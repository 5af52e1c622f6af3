"""The train-path kernel modules of the port against the JAX package, on
the CPU (where each wrapper runs its plain version and each
`autograd.Function` its backward composition):

  * K6 (`warp_variance_train`): forward and the feature gradient against
    jax.grad through the XLA warp + variance, the composition
    tests/test_pallas_warp_train.py holds the TPU kernel to;
  * K7 (`warp_volume_train`): the variance and the render volume (warped
    images, then no-ref variance), and the feature and image gradients,
    against the XLA composition of tests/test_pallas_warp_volume.py;
  * K8 (`conv3d_train`): each mode's forward, dx and dw against jax.grad
    through XLA's conv (tests/test_pallas_costreg_train.py:46), and the
    plain dw (27 shifted products) against autograd;
  * CostRegNet / RenderCostReg in train mode through K8: outputs, every
    parameter and input gradient, and the BN running statistics against
    the JAX modules (train=True, XLA path).
Inputs come from numpy with a fixed seed. Tolerances: forward 1e-4 (K8
1e-5), gradients rtol = atol = 1e-4 (the sums run in another order), BN
statistics 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.core.geometry import compose_projection
from rcmvsnet_tpu.data.synthetic import make_synthetic_views
from rcmvsnet_tpu.nn.costreg import CostRegNet as JCostRegNet
from rcmvsnet_tpu.nn.costreg import RenderCostReg as JRenderCostReg
from rcmvsnet_tpu.ops.warp import (homo_warp, plane_sweep_variance,
                                   plane_sweep_variance_no_ref)
from rcmvsnet_tpu_torch.nn.costreg import CostRegNet, RenderCostReg
from rcmvsnet_tpu_torch.ops import conv3d_train as K8
from rcmvsnet_tpu_torch.ops import warp_variance as K6
from rcmvsnet_tpu_torch.ops import warp_volume as K7
from rcmvsnet_tpu_torch.weights import costreg_state_dict_from_jax

torch.set_num_threads(2)
GTOL = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy


def _setup(H=16, W=24, V=4, D=8, C=8, seed=3):
    """The JAX kernel tests' scene: features, stage images, projections,
    the hypothesis volume and (lo, step), all numpy."""
    s = make_synthetic_views(H=H, W=W, V=V, depth0=600.0, seed=seed,
                             baseline=4.0)
    rs = np.random.RandomState(seed)
    feats = rs.randn(V, H, W, C).astype(np.float32)
    imgs = rs.rand(V, H, W, 3).astype(np.float32)
    pairs = np.zeros((1, V, 2, 4, 4), np.float32)
    for v in range(V):
        pairs[0, v, 0] = s["extrinsics"][v]
        pairs[0, v, 1, :3, :3] = s["intrinsics"]
    projs = np.asarray(compose_projection(jnp.asarray(pairs)))[0]
    lo = np.full((H, W), s["depth_min"], np.float32)
    step = np.full((H, W), (s["depth_max"] - s["depth_min"]) / (D - 1),
                   np.float32)
    dv = lo[None] + np.arange(D, dtype=np.float32)[:, None, None] * step
    return feats, imgs, projs, lo, step, dv, D


def _jax_variance(feats, projs, dv):
    V = feats.shape[0]
    var, _ = plane_sweep_variance(
        feats[0][None], [feats[v][None] for v in range(1, V)],
        [projs[v][None] for v in range(1, V)], projs[0][None], dv[None])
    return var[0]                                           # [D, h, w, C]


def _jax_volume(feats, imgs, projs, dv):
    V = feats.shape[0]
    ref_p = projs[0][None]
    src = [feats[v][None] for v in range(1, V)]
    prj = [projs[v][None] for v in range(1, V)]
    var, _ = plane_sweep_variance(feats[0][None], src, prj, ref_p, dv[None])
    var_nr = plane_sweep_variance_no_ref(
        [homo_warp(f, p, ref_p, dv[None]) for f, p in zip(src, prj)])
    wimg = jnp.concatenate([homo_warp(imgs[v][None], projs[v][None], ref_p,
                                      dv[None]) for v in range(1, V)], -1)
    return var[0], var_nr[0], wimg[0]


def _cm(x):
    """JAX [D, h, w, C] → the port's [C, D, h, w]."""
    return np.transpose(np.asarray(x), (3, 0, 1, 2))


@pytest.mark.parametrize("C", [8, 32])
def test_k6_forward_and_grad_match_jax(C):
    feats, _, projs, lo, step, dv, D = _setup(C=C)
    wr = np.random.RandomState(11).randn(D, *feats.shape[1:]).astype(
        np.float32)
    want = _jax_variance(jnp.asarray(feats), jnp.asarray(projs),
                         jnp.asarray(dv))
    g_want = jax.grad(lambda x: jnp.sum(_jax_variance(
        x, jnp.asarray(projs), jnp.asarray(dv)) * wr))(jnp.asarray(feats))

    x = T(feats).requires_grad_(True)
    n0 = K6.warp_variance_bwd.launches
    var = K6.warp_variance_train(x, T(projs), T(lo), T(step), D)
    (var * T(_cm(wr))).sum().backward()
    assert K6.warp_variance_bwd.launches == n0      # CPU: plain version
    np.testing.assert_allclose(var.detach().numpy(), _cm(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want), **GTOL)
    bwd = K6.warp_variance_bwd_plain(T(feats), T(projs), T(lo), T(step),
                                     T(_cm(wr)))
    np.testing.assert_allclose(bwd.numpy(), np.asarray(g_want), **GTOL)


def test_k7_forward_and_grads_match_jax():
    feats, imgs, projs, lo, step, dv, D = _setup()
    rs = np.random.RandomState(11)
    V, H, W, C = feats.shape
    w_var = rs.randn(D, H, W, C).astype(np.float32)
    w_nr = rs.randn(D, H, W, C).astype(np.float32)
    w_img = rs.randn(D, H, W, 3 * (V - 1)).astype(np.float32)
    jp, jdv = jnp.asarray(projs), jnp.asarray(dv)

    def f_jax(x, im):
        var, var_nr, wimg = _jax_volume(x, im, jp, jdv)
        return (jnp.sum(var * w_var) + jnp.sum(var_nr * w_nr)
                + jnp.sum(wimg * w_img))

    want = _jax_volume(jnp.asarray(feats), jnp.asarray(imgs), jp, jdv)
    gf, gi = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(feats),
                                            jnp.asarray(imgs))

    x = T(feats).requires_grad_(True)
    im = T(imgs).requires_grad_(True)
    var, vol = K7.warp_volume_train(x, im, T(projs), T(lo), T(step), D)
    # vol: the warped images (view-major), then the no-ref variance
    outs = (var, vol[3 * (V - 1):], vol[:3 * (V - 1)])
    for got, ref in zip(outs, want):
        np.testing.assert_allclose(got.detach().numpy(), _cm(ref),
                                   rtol=1e-4, atol=1e-4)
    loss = sum((o * T(_cm(w))).sum() for o, w in zip(outs,
                                                     (w_var, w_nr, w_img)))
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gf), **GTOL)
    np.testing.assert_allclose(im.grad.numpy(), np.asarray(gi), **GTOL)


def test_k7_var_only_cotangent_gives_zero_image_grad():
    feats, imgs, projs, lo, step, dv, D = _setup()
    x = T(feats).requires_grad_(True)
    im = T(imgs).requires_grad_(True)
    var, _ = K7.warp_volume_train(x, im, T(projs), T(lo), T(step), D)
    var.sum().backward()
    assert float(im.grad.abs().max()) == 0.0
    g = jax.grad(lambda f: jnp.sum(_jax_variance(
        f, jnp.asarray(projs), jnp.asarray(dv))))(jnp.asarray(feats))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **GTOL)


def _jax_conv(x, k, mode):
    """XLA conv, NCDHW in and out; k in the port's layout."""
    dn = ("NCDHW", "OIDHW", "NCDHW")
    if mode == "t2":
        # ConvTranspose3d == conv over the 2-dilated input with the
        # flipped, in/out-swapped kernel
        kt = jnp.flip(jnp.swapaxes(k, 0, 1), (2, 3, 4))
        return jax.lax.conv_general_dilated(
            x, kt, (1, 1, 1), [(1, 2)] * 3, lhs_dilation=(2, 2, 2),
            dimension_numbers=dn, precision=jax.lax.Precision.HIGHEST)
    s = 1 if mode == "s1" else 2
    return jax.lax.conv_general_dilated(
        x, k, (s,) * 3, [(1, 1)] * 3, dimension_numbers=dn,
        precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 16, 8, (8, 8, 16)), ("s1", 8, 1, (8, 8, 8)),
    ("s2", 8, 16, (8, 16, 16)), ("t2", 16, 8, (4, 8, 8)),
    ("s1", 41, 8, (8, 8, 8))])
def test_k8_forward_and_grads_match_jax(mode, ci, co, shape):
    rs = np.random.RandomState(0)
    x = rs.randn(2, ci, *shape).astype(np.float32)
    wshape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    k = (0.1 * rs.randn(*wshape)).astype(np.float32)
    y_j = _jax_conv(jnp.asarray(x), jnp.asarray(k), mode)
    g = rs.randn(*y_j.shape).astype(np.float32)
    gx_j, gk_j = jax.grad(lambda a, b: jnp.sum(_jax_conv(a, b, mode) * g),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))

    xt, kt = T(x).requires_grad_(True), T(k).requires_grad_(True)
    y = K8.conv3d_train(xt, kt, mode)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    (y * T(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **GTOL)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_j), **GTOL)
    dw = K8.conv3d_dw_plain(T(x), T(g), mode)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gk_j), **GTOL)


def test_k8_adjoint_odd_sizes_match_autograd():
    """The stride-2 conv's adjoint is the transposed conv, 2n per axis:
    over an odd input size K8 trims it to the input (`out_dhw`), and the
    gradient equals autograd through the plain conv; a size that no
    transposed conv gives is rejected."""
    x = torch.randn(1, 4, 5, 6, 6, requires_grad=True)
    w = torch.randn(8, 4, 3, 3, 3)
    y = K8.conv3d_train(x, w, "s2")
    y.sum().backward()
    xp = x.detach().clone().requires_grad_(True)
    K8.conv3d_train_plain(xp, w, "s2").sum().backward()
    torch.testing.assert_close(x.grad, xp.grad, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="cannot give"):
        K8.conv3d(y.detach(), w, torch.zeros(4), "t2", out_dhw=(4, 6, 6))


@pytest.mark.parametrize("net", ["costreg", "render"])
def test_unet_train_matches_jax(net):
    """Train-mode U-Net through K8 vs the JAX module (train=True, XLA):
    output, input and parameter gradients per tensor, BN statistics."""
    rs = np.random.RandomState(5)
    ci = 16 if net == "costreg" else 15
    x = rs.randn(1, 8, 16, 16, ci).astype(np.float32)       # NDHWC
    J = JCostRegNet(8) if net == "costreg" else JRenderCostReg(8)
    variables = J.init(jax.random.PRNGKey(2), jnp.asarray(x), False)
    out_ch = 1 if net == "costreg" else 8
    g = rs.randn(1, 8, 16, 16, out_ch).astype(np.float32)

    def f(params, xx):
        y, mut = J.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         xx, True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut)

    (_, (y_j, mut)), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"],
                                        jnp.asarray(x))
    render = net == "render"
    wrap = lambda p, s: costreg_state_dict_from_jax(p, s, render)
    model = RenderCostReg(ci, 8) if render else CostRegNet(ci, 8)
    model.load_state_dict(wrap(variables["params"],
                               variables["batch_stats"]), strict=True)
    model.train()
    xt = T(np.ascontiguousarray(np.transpose(x, (0, 4, 1, 2, 3))))
    xt.requires_grad_(True)
    y = model.forward_train(xt)
    y_nd = y.permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(y_nd.detach().numpy(), np.asarray(y_j),
                               rtol=1e-4, atol=1e-4)
    (y_nd * T(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(gx_j), **GTOL)
    want_g = wrap(gp_j, variables["batch_stats"])
    for name, p in model.named_parameters():
        ref = want_g[name].numpy()
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 + 1e-4 * float(np.abs(ref).max()), name
    want_s = wrap(variables["params"], mut["batch_stats"])
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want_s[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
