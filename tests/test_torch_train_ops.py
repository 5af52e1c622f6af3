"""The train slice's plain modules of the port against the JAX package, on
the CPU: geometry (`world_to_ndc`), samplers (`grid_sample_3d`,
`loss_bilinear_sample` with its gradient, `resize_trilinear`), image ops,
the unsupervised, aug, ray and supervised losses (values and depth
gradients), ray sampling with injected draws, the neural-volume and
color-volume lookups, compositing, positional encoding, the NeRF MLP, the
whole render branch (forward, BN statistics and gradients), the cascade's
train forward (depths, stage-1 volume, feature gradients), the schedule
and `adjust_w_aug`. Inputs come from numpy with a fixed seed; both sides
get the same arrays. Tolerance rtol = atol = 1e-5 for direct ops, 1e-4
where a network or a gradient sits between."""
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.core import geometry as jgeo
from rcmvsnet_tpu.data.synthetic import make_synthetic_batch
from rcmvsnet_tpu.losses import aug as jaug
from rcmvsnet_tpu.losses import rays as jrays
from rcmvsnet_tpu.losses import supervised as jsup
from rcmvsnet_tpu.losses import unsup as junsup
from rcmvsnet_tpu.models.cascade import CascadeMVSNet as JCascade
from rcmvsnet_tpu.models.render_net import (
    RenderingConsistencyNet as JRenderNet)
from rcmvsnet_tpu.nn import mlp as jmlp
from rcmvsnet_tpu.ops import image as jimage
from rcmvsnet_tpu.ops import sampling as jsamp
from rcmvsnet_tpu.render import rays as jrender_rays
from rcmvsnet_tpu.render import volume_render as jvr
from rcmvsnet_tpu.train.schedule import warmup_multistep_schedule as jsched
from rcmvsnet_tpu_torch.core import geometry as tgeo
from rcmvsnet_tpu_torch.losses import aug as taug
from rcmvsnet_tpu_torch.losses import rays as trays
from rcmvsnet_tpu_torch.losses import supervised as tsup
from rcmvsnet_tpu_torch.losses import unsup as tunsup
from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
from rcmvsnet_tpu_torch.models.render_net import RenderingConsistencyNet
from rcmvsnet_tpu_torch.nn import mlp as tmlp
from rcmvsnet_tpu_torch.ops import image as timage
from rcmvsnet_tpu_torch.ops import sampling as tsamp
from rcmvsnet_tpu_torch.render import rays as trender_rays
from rcmvsnet_tpu_torch.render import volume_render as tvr
from rcmvsnet_tpu_torch.train.schedule import warmup_multistep_schedule
from rcmvsnet_tpu_torch.train.step import batch_to
from rcmvsnet_tpu_torch.weights import (nerf_state_dict_from_jax,
                                        render_state_dict_from_jax,
                                        state_dict_from_jax)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
NTOL = dict(rtol=1e-4, atol=1e-4)
T = lambda a: torch.from_numpy(np.array(a))
RS = np.random.RandomState
GOLDEN = Path(__file__).resolve().parent / "golden" / "backbone_synth.msgpack"


@pytest.fixture(scope="module")
def batch():
    return make_synthetic_batch(B=1, V=3, H=32, W=32, ndepth=64, seed=2)


def test_world_to_ndc_matches_jax(batch):
    pts = (RS(0).randn(7, 5, 3) * 50 + [0, 0, 600]).astype(np.float32)
    inv = np.float32([31, 31])
    want = jgeo.world_to_ndc(jnp.asarray(pts), batch["w2cs"][0, 1],
                             batch["intrinsics"][0, 1], jnp.asarray(inv),
                             480.0, 750.0)
    got = tgeo.world_to_ndc(T(pts), T(batch["w2cs"][0, 1]),
                            T(batch["intrinsics"][0, 1]), T(inv),
                            480.0, 750.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_samplers_match_jax():
    rs = RS(1)
    vol = rs.randn(2, 5, 6, 7, 4).astype(np.float32)          # NDHWC
    x, y, z = (rs.uniform(-1.2, 1.2, (2, 9, 3)).astype(np.float32)
               for _ in range(3))
    want = jsamp.grid_sample_3d(*map(jnp.asarray, (vol, x, y, z)))
    got = tsamp.grid_sample_3d(T(np.transpose(vol, (0, 4, 1, 2, 3))),
                               T(x), T(y), T(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    img = rs.randn(2, 8, 10, 3).astype(np.float32)
    for mode in ("zeros", "border"):
        want = jsamp.grid_sample_2d(jnp.asarray(img), jnp.asarray(x),
                                    jnp.asarray(y), padding_mode=mode)
        got = tsamp.grid_sample_2d(T(img), T(x), T(y), padding_mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    px = rs.uniform(-1.1, 1.1, (2, 8, 10)).astype(np.float32)
    py = rs.uniform(-1.1, 1.1, (2, 8, 10)).astype(np.float32)
    (w_j, m_j) = jsamp.loss_bilinear_sample(*map(jnp.asarray, (img, px, py)))
    tx, ty = T(px).requires_grad_(True), T(py).requires_grad_(True)
    w_t, m_t = tsamp.loss_bilinear_sample(T(img), tx, ty)
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j), **TOL)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    gw = rs.randn(*w_t.shape).astype(np.float32)
    gx, gy = jax.grad(lambda a, b: jnp.sum(jsamp.loss_bilinear_sample(
        jnp.asarray(img), a, b)[0] * gw), argnums=(0, 1))(
        jnp.asarray(px), jnp.asarray(py))
    (w_t * T(gw)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **NTOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), **NTOL)

    v = rs.randn(1, 6, 5, 7, 3).astype(np.float32)
    for ac in (True, False):
        want = jsamp.resize_trilinear(jnp.asarray(v), 16, 10, 9, ac)
        got = tsamp.resize_trilinear(T(v), 16, 10, 9, ac)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_image_ops_match_jax():
    rs = RS(2)
    x, y = (rs.rand(2, 9, 11, 3).astype(np.float32) for _ in range(2))
    mask = (rs.rand(2, 9, 11, 1) > 0.3).astype(np.float32)
    d = rs.rand(2, 9, 11, 1).astype(np.float32) * 5
    np.testing.assert_allclose(
        timage.ssim(T(x), T(y), T(mask)).numpy(),
        np.asarray(jimage.ssim(*map(jnp.asarray, (x, y, mask)))), **TOL)
    np.testing.assert_allclose(
        float(timage.depth_smoothness(T(d), T(x))),
        float(jimage.depth_smoothness(jnp.asarray(d), jnp.asarray(x))),
        **TOL)
    for a, b in zip(timage.gradient(T(x)), jimage.gradient(jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(
        timage.smooth_l1(T(x * 3), T(y)).numpy(),
        np.asarray(jimage.smooth_l1(jnp.asarray(x * 3), jnp.asarray(y))),
        **TOL)
    np.testing.assert_allclose(
        float(timage.masked_mean(T(x[..., :1]), T(mask) > 0.5)),
        float(jimage.masked_mean(jnp.asarray(x[..., :1]),
                                 jnp.asarray(mask) > 0.5)), **TOL)


def _depths(batch, rs):
    """Per-stage depth maps near the scene's plane (with noise)."""
    B, V, H, W, _ = batch["imgs"].shape
    out = {}
    for i, s in enumerate((4, 2, 1)):
        gt = batch["depth"][f"stage{i + 1}"]
        out[f"stage{i + 1}"] = (gt + rs.randn(*gt.shape) * 3).astype(
            np.float32)
    return out


def test_unsup_loss_and_depth_grads_match_jax(batch):
    depths = _depths(batch, RS(3))
    projs = batch["proj_matrices"]
    jloss = jax.jit(lambda ds: junsup.unsup_loss_multi_stage(
        {k: {"depth": v} for k, v in ds.items()},
        jnp.asarray(batch["center_imgs"]),
        {k: jnp.asarray(v) for k, v in projs.items()}))
    jd = {k: jnp.asarray(v) for k, v in depths.items()}
    want, wsc = jloss(jd)
    td = {k: T(v).requires_grad_(True) for k, v in depths.items()}
    got, tsc = tunsup.unsup_loss_multi_stage(
        {k: {"depth": v} for k, v in td.items()}, T(batch["center_imgs"]),
        {k: T(v) for k, v in projs.items()})
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert set(tsc) == set(wsc)
    for k in wsc:
        np.testing.assert_allclose(float(tsc[k]), float(wsc[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    gj = jax.jit(jax.grad(lambda ds: jloss(ds)[0]))(jd)
    got.backward()
    for k, v in td.items():
        ref = np.asarray(gj[k])
        np.testing.assert_allclose(v.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)


def test_aug_mask_and_loss_match_jax(batch):
    rs = RS(4)
    key = jax.random.PRNGKey(9)
    img = batch["imgs_aug"][:, 0]
    H, W = img.shape[1:3]
    masked_j, fm_j = jaug.random_image_mask(key, jnp.asarray(img),
                                            (H // 3, W // 3))
    kx, ky = jax.random.split(jax.random.split(key, 1)[0])
    origin = torch.tensor([[int(jax.random.randint(kx, (), 0, W - W // 3)),
                            int(jax.random.randint(ky, (), 0,
                                                   H - H // 3))]])
    masked_t, fm_t = taug.random_image_mask(T(img), (H // 3, W // 3), origin)
    np.testing.assert_array_equal(fm_t.numpy(), np.asarray(fm_j))
    np.testing.assert_array_equal(masked_t.numpy(), np.asarray(masked_j))
    gen = torch.Generator().manual_seed(0)
    o = taug.draw_mask_origins(gen, 4, H, W, (H // 3, W // 3))
    assert o.shape == (4, 2) and int(o[:, 0].max()) < W - W // 3

    depths = _depths(batch, rs)
    pseudo = batch["depth"]["stage3"] + rs.randn(1, H, W).astype(np.float32)
    want, wsc = jaug.aug_loss_multi_stage(
        {k: {"depth": jnp.asarray(v)} for k, v in depths.items()},
        jnp.asarray(pseudo), fm_j)
    got, tsc = taug.aug_loss_multi_stage(
        {k: {"depth": T(v)} for k, v in depths.items()}, T(pseudo), fm_t)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    for k in wsc:
        np.testing.assert_allclose(float(tsc[k]), float(wsc[k]), **TOL)
    for e in range(12):
        assert taug.adjust_w_aug(e, 0.01) == jaug.adjust_w_aug(e, 0.01)


def test_ray_and_supervised_metrics_match_jax():
    rs = RS(5)
    pred = rs.rand(2, 64).astype(np.float32) * 8
    gt = rs.rand(2, 64).astype(np.float32) * 8
    mask = gt > 2
    for name in ("abs_error",):
        np.testing.assert_allclose(
            float(getattr(trays, name)(T(pred), T(gt), T(mask))),
            float(getattr(jrays, name)(pred, gt, mask)), **TOL)
    np.testing.assert_allclose(float(trays.sl1_loss(T(pred), T(gt))),
                               float(jrays.sl1_loss(pred, gt)), **TOL)
    np.testing.assert_allclose(
        float(trays.acc_threshold(T(pred), T(gt), T(mask), 2.0)),
        float(jrays.acc_threshold(pred, gt, mask, 2.0)), **TOL)
    mse = trays.img2mse(T(pred), T(gt))
    np.testing.assert_allclose(float(trays.mse2psnr(mse)),
                               float(jrays.mse2psnr(jrays.img2mse(pred, gt))),
                               **TOL)
    est = rs.rand(2, 8, 9).astype(np.float32) * 10
    g2 = rs.rand(2, 8, 9).astype(np.float32) * 10
    m2 = rs.rand(2, 8, 9) > 0.4
    for thres in (2.0, 4.0):
        np.testing.assert_allclose(
            float(tsup.thres_metric(T(est), T(g2), T(m2), thres)),
            float(jsup.thres_metric(est, g2, m2, thres)), **TOL)
    np.testing.assert_allclose(
        float(tsup.abs_depth_error_metric(T(est), T(g2), T(m2))),
        float(jsup.abs_depth_error_metric(est, g2, m2)), **TOL)


def _jax_ray_draws(key, n, s, H, W):
    k_px, k_py, k_norm, k_strat = jax.random.split(key, 4)
    return trender_rays.RayDraws(
        T(jax.random.randint(k_px, (n,), 0, W)).long(),
        T(jax.random.randint(k_py, (n,), 0, H)).long(),
        T(jax.random.normal(k_norm, (n, s))),
        T(jax.random.uniform(k_strat, (n - n // 2, s))))


def test_rays_lookups_and_compositing_match_jax(batch):
    rs = RS(6)
    key = jax.random.PRNGKey(3)
    imgs = batch["imgs"][0] * 0.2 + 0.5
    pseudo = batch["depth"]["stage3"][0]
    args = [batch[k][0] for k in ("w2cs", "c2ws", "intrinsics",
                                  "near_fars")]
    n, s = 11, 6
    want = jrender_rays.sample_rays(key, jnp.asarray(imgs),
                                    jnp.asarray(pseudo),
                                    *map(jnp.asarray, args), n_rays=n,
                                    n_samples=s)
    got = trender_rays.sample_rays(_jax_ray_draws(key, n, s, *pseudo.shape),
                                   T(imgs), T(pseudo), *map(T, args))
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    vol = rs.randn(6, 8, 8, 5).astype(np.float32)               # DHWC
    want_f = jrender_rays.index_point_feature(jnp.asarray(vol), want.ndc)
    got_f = trender_rays.index_point_feature(
        T(np.transpose(vol, (3, 0, 1, 2))), got.ndc)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **NTOL)
    H, W = imgs.shape[1:3]
    want_c = jrender_rays.build_color_volume(
        want.pts_world, jnp.asarray(imgs), jnp.asarray(args[0]),
        jnp.asarray(args[2]), (W, H))
    got_c = trender_rays.build_color_volume(got.pts_world, T(imgs),
                                            T(args[0]), T(args[2]), (W, H))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **NTOL)

    raw = rs.randn(n, s, 4).astype(np.float32)
    z = np.sort(rs.rand(n, s).astype(np.float32) * 10, -1)
    cos = rs.rand(n).astype(np.float32) + 0.5
    dj = jvr.depth2dist(jnp.asarray(z), jnp.asarray(cos))
    dt = tvr.depth2dist(T(z), T(cos))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    oj = jvr.volumetric_render(jnp.asarray(raw), jnp.asarray(z), dj)
    ot = tvr.volumetric_render(T(raw), T(z), dt)
    for name in oj._fields:
        np.testing.assert_allclose(getattr(ot, name).numpy(),
                                   np.asarray(getattr(oj, name)), **TOL)


def test_positional_encoding_and_mlp_match_jax():
    rs = RS(7)
    x = rs.rand(5, 4, 3).astype(np.float32)
    enc_j = jmlp.positional_encoding(jnp.asarray(x), 10)
    enc_t = tmlp.positional_encoding(T(x), 10)
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), **TOL)
    feats = rs.randn(5, 4, 20).astype(np.float32)
    views = rs.randn(5, 4, 3).astype(np.float32)
    mlp = jmlp.NerfMLP(6, 32, in_ch_pts=63)
    params = mlp.init(jax.random.PRNGKey(0), enc_j, jnp.asarray(feats),
                      jnp.asarray(views))["params"]
    want = mlp.apply({"params": params}, enc_j, jnp.asarray(feats),
                     jnp.asarray(views))
    net = tmlp.NerfMLP(6, 32, in_ch_pts=63, in_ch_feat=20)
    net.load_state_dict(nerf_state_dict_from_jax(params), strict=True)
    got = net(enc_t, T(feats), T(views))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **NTOL)


@pytest.mark.parametrize("net_type", ["v0", "v1", "v2"])
def test_render_branch_matches_jax(batch, net_type):
    """The whole render branch (neural volume through K8's plain
    composition, rays, lookups, MLP of each net_type, compositing):
    outputs, BN statistics, parameter and volume gradients of img +
    ray-depth loss, over every ray.

    v2's reference is JAX run op by op, not jitted: rays drawn on an image
    edge project exactly onto view 0's border, where the color volume's
    in-bounds mask (grid > −1 and < 1) is decided by the last bit. XLA's
    fused program rounds one sample of these draws (ray 10, column W−1)
    to the other side from per-op float32, which both the port and
    unjitted JAX use; under v2 that moves the ray's rgb by 2e-2, under v0
    and v1 the sample's weight hides it."""
    B, V, H, W, _ = batch["imgs"].shape
    n, s, planes = 16, 8, 16
    rs = RS(8)
    vf = rs.rand(B, 48, H // 4, W // 4, 3 * (V - 1) + 32).astype(np.float32)
    pseudo = batch["depth"]["stage3"]
    cams = [batch[k] for k in ("w2cs", "c2ws", "intrinsics", "near_fars")]
    net = JRenderNet(n_rays=n, n_samples=s, num_planes=planes,
                     net_type=net_type)
    key = jax.random.PRNGKey(5)
    variables = jax.jit(lambda *a: net.init(*a, rng=key, train=False))(
        jax.random.PRNGKey(4), jnp.asarray(vf), jnp.asarray(pseudo),
        jnp.asarray(batch["imgs"]), *map(jnp.asarray, cams))

    def f(params, vol):
        res, mut = net.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             vol, jnp.asarray(pseudo),
                             jnp.asarray(batch["imgs"]),
                             *map(jnp.asarray, cams), rng=key, train=True,
                             mutable=["batch_stats"])
        loss = (jrays.img2mse(res.rgb, res.target_rgb)
                + jrays.sl1_loss(res.depth, res.rays_depth,
                                 res.rays_depth > 0))
        return loss, (res, mut)

    grad = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
    if net_type != "v2":
        grad = jax.jit(grad)
    (loss_j, (res_j, mut)), (gp, gv) = grad(variables["params"],
                                            jnp.asarray(vf))
    port = RenderingConsistencyNet(3 * (V - 1) + 32, num_planes=planes,
                                   net_type=net_type)
    port.load_state_dict(render_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    port.train()
    draws = [_jax_ray_draws(k, n, s, H, W)
             for k in jax.random.split(key, B)]
    vt = T(np.transpose(vf, (0, 4, 1, 2, 3))).requires_grad_(True)
    b = batch_to(batch, "cpu")
    res = port(vt, T(pseudo), b["imgs"], b["w2cs"], b["c2ws"],
               b["intrinsics"], b["near_fars"], draws)
    for name in ("rgb", "depth", "target_rgb", "rays_depth", "weights"):
        np.testing.assert_allclose(getattr(res, name).detach().numpy(),
                                   np.asarray(getattr(res_j, name)),
                                   **NTOL, err_msg=name)
    loss = (trays.img2mse(res.rgb, res.target_rgb)
            + trays.sl1_loss(res.depth, res.rays_depth, res.rays_depth > 0))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    loss.backward()
    # 11 train-mode BNs lie between the loss and the volume: float32
    # rounding there reaches ~1e-4 of the largest gradient in either
    # framework (a float64 run puts both at that level), so 1e-3
    np.testing.assert_allclose(
        vt.grad.permute(0, 2, 3, 4, 1).numpy(), np.asarray(gv),
        rtol=1e-3, atol=1e-3 * float(np.abs(np.asarray(gv)).max()))
    want_g = render_state_dict_from_jax(gp, variables["batch_stats"])
    scale = max(float(v.abs().max()) for k, v in want_g.items()
                if not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked")))
    for name, p in port.named_parameters():
        err = float(np.abs(p.grad.numpy() - want_g[name].numpy()).max())
        assert err <= 1e-3 * scale, (name, err, scale)
    want_s = render_state_dict_from_jax(variables["params"],
                                        mut["batch_stats"])
    for name, buf in port.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want_s[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def test_cascade_train_forward_matches_jax(batch):
    """The cascade's train forward with return_volume (K7 at stage 1, K1
    after it, K8 in every U-Net, all through their CPU compositions), with
    the golden backbone: per-stage depth, the stage-1 volume, BN statistics
    and every parameter gradient of Σ depth·w + Σ volume·u (to 1e-3 of the
    largest; see test_torch_train_step.py for why not per tensor)."""
    rs = RS(9)
    imgs = jnp.asarray(batch["imgs"])
    projs = {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()}
    dvals = jnp.asarray(batch["depth_values"])
    net = JCascade()
    blob = flax.serialization.msgpack_restore(GOLDEN.read_bytes())
    variables = {"params": blob["params"],
                 "batch_stats": blob["batch_stats"]}
    wd = {k: rs.randn(*batch["depth"][k].shape).astype(np.float32)
          for k in batch["depth"]}
    B, V, H, W, _ = batch["imgs"].shape
    u = rs.randn(B, 48, H // 4, W // 4, 3 * (V - 1) + 32).astype(np.float32)

    def f(params):
        (outs, vol), mut = net.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            imgs, projs, dvals, train=True, return_volume=True,
            mutable=["batch_stats"])
        loss = sum(jnp.sum(outs[k]["depth"] * wd[k]) for k in wd)
        return loss + jnp.sum(vol * u), (outs, vol, mut)

    (_, (outs_j, vol_j, mut)), gp = jax.jit(jax.value_and_grad(
        f, has_aux=True))(variables["params"])
    port = CascadeMVSNet()
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]),
                         strict=True)
    port.train()
    b = batch_to(batch, "cpu")
    outs, vol = port.forward_train(b["imgs"], b["proj_matrices"],
                                   b["depth_values"], return_volume=True)
    for k in wd:
        np.testing.assert_allclose(outs[k]["depth"].detach().numpy(),
                                   np.asarray(outs_j[k]["depth"]),
                                   rtol=1e-5, err_msg=k)
    vol_nd = vol.permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(vol_nd.detach().numpy(), np.asarray(vol_j),
                               **NTOL)
    loss = sum((outs[k]["depth"] * T(wd[k])).sum() for k in wd)
    (loss + (vol_nd * T(u)).sum()).backward()
    want_g = state_dict_from_jax(gp, variables["batch_stats"])
    scale = max(float(np.abs(v.numpy()).max()) for k, v in want_g.items()
                if not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked")))
    for name, p in port.named_parameters():
        err = float(np.abs(p.grad.numpy() - want_g[name].numpy()).max())
        assert err <= 1e-3 * scale, (name, err, scale)
    want_s = state_dict_from_jax(variables["params"], mut["batch_stats"])
    for name, buf in port.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want_s[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def test_schedule_matches_jax():
    want = jsched(1e-4, [1000, 1200], gamma=0.5, warmup_iters=500)
    got = warmup_multistep_schedule(1e-4, [1000, 1200], gamma=0.5)
    for step in (0, 1, 250, 499, 500, 999, 1000, 1199, 1200, 5000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
