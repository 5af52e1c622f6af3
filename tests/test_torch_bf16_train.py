"""The bf16 train path of the PyTorch port (`BackboneConfig.train_dtype` =
"bfloat16"), piece by piece, against the JAX package's bf16 train path on
the CPU, each piece at the scale of one bf16 ulp.

The JAX CLI trains on its chip with train_dtype bf16 and the fused train
kernels on (`cli/train.py:200-222`): `plane_sweep_variance_fused_train`
(K1 with K6 as its backward), `plane_sweep_volume_fused_train` (K7,
forward and backward) and `conv_lanes_t` (K8: K2 forward and adjoint, the
dw kernel), all at their default compute dtype bf16. Here those Pallas
kernels run in interpret mode, and the port runs its bf16 plain versions
(the float32 plain version on the bf16 operands, rounded where the kernel
rounds). Inputs come from seeds with numpy.

XLA's CPU backend lowers a bf16 `reduce_sum` with a bf16 accumulator. The
JAX step meets one wherever autodiff transposes a broadcast of a bf16
value: the cotangents of FeatureNet's rounded BN factors and of its head
biases, each a sum over every pixel of the batch, which a bf16
accumulator loses (a 65536-term sum of values in [1, 2) read 0.083 of
its value). The port sums them in float32 and rounds once, as PyTorch's bf16 `sum` does,
and so the tests lower JAX's bf16 `reduce_sum` through float32
(`f32_reductions`): without it FeatureNet's parameter gradients departed
from JAX's by 1–9 % of their largest element in every block. XLA may also
compute a fused chain of bf16 operations in float32 and round once
("excess precision"), where the JAX source rounds each operation, as the
port does: the references are compiled with it off (`jit`); with it on,
FeatureNet blocks' input gradients departed from the port's by up to
2.3e-2 in relative L2 (≤ 2.3e-3 with it off).

  * Per kernel, through `jax.vjp`: K6 (the feature gradient of the fused
    variance), K7 (its three outputs, the feature and image gradients)
    and K8 (forward, dx and dw in s1, s2 over `subsample_hw`, t2 over
    `stuff_hw_z`, and the prob head's float32 output with its float32
    cotangent), each within one bf16 ulp of each element (2^-7 of its
    magnitude) plus 1e-4 of the largest value, where both sides sum in
    float32 in another order and round once; K8's dw, float32 in both, to
    1e-4 of its largest value. The warps run on cameras whose sample
    coordinates are exact in float32 (`tests/test_torch_bf16_eval.py`:
    JAX computes X·(1/Z), the port X/Z).
  * Per block, each fed JAX's own input and a seeded cotangent: every
    FeatureNet block (`nn/featurenet.block_train_bf16` against
    `ConvBNAct`, on the inputs JAX's FeatureNet gives each block at the
    golden weights), FeatureNet's heads (on JAX's trunk outputs), and the
    U-Net blocks (`nn/costreg.block_train` against `_LanesConvBN`) in s1,
    s2 and t2, with and without ReLU. FeatureNet's blocks: output, input
    and parameter gradients within 2^-8 relative L2 (one bf16 ulp; see
    `_check_feature_block`), its heads' gradients 2^-7. The U-Net blocks
    and FeatureNet's head outputs: each element within one bf16 ulp +
    1e-4 of the largest value at all but BLOCK_SHARE of them, the U-Nets'
    float32 dw within 1e-4 of its largest value (measured ≤ 2e-6), dγ and
    dβ within BN_GRAD. Running statistics within 1e-5 of their largest
    value. Faults planted in the port (FeatureNet's BN factors not
    rounded; K8's plain dw scaled by 1.01) fail these gates.
  * A whole CostRegNet `forward_train` at bf16 against JAX's, chained:
    each conv sums in another order in the two, which flips the bf16
    rounding of an element now and then, and the flips multiply layer by
    layer (one input element moved by one ulp moves the port's own input
    gradient by 1.6 % relative L2), so its gates are the scale of those
    flips: a few ulps in relative L2 (the cost within 2^-7, the input
    and parameter gradients within 2^-5), which is where the port meets
    its own output with one input element moved by one ulp.

The train step end to end is `tests/test_torch_bf16_train_step.py`.
"""
from functools import partial
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.interpreters import mlir
from jax._src.lax import lax as jlax
from jax.experimental import pallas as pl

from rcmvsnet_tpu.nn.costreg import CostRegNet as JCostRegNet
from rcmvsnet_tpu.nn.costreg import _LanesConvBN
from rcmvsnet_tpu.nn.featurenet import FeatureNet as JFeatureNet
from rcmvsnet_tpu.nn.layers import ConvBNAct as JConvBNAct
from rcmvsnet_tpu.ops import (pallas_costreg, pallas_costreg_train,
                              pallas_resample, pallas_warp2,
                              pallas_warp_train, pallas_warp_volume)
from rcmvsnet_tpu.ops.pallas_costreg import (make_layout, stuff_hw_z,
                                             subsample_hw, to_lanes)
from rcmvsnet_tpu.ops.pallas_costreg_train import conv_lanes_t
from rcmvsnet_tpu.ops.pallas_warp_train import (
    lanes_to_ndhwc, plane_sweep_variance_fused_train)
from rcmvsnet_tpu.ops.pallas_warp_volume import plane_sweep_volume_fused_train
from rcmvsnet_tpu_torch.nn import costreg as port_costreg
from rcmvsnet_tpu_torch.nn import featurenet as port_featurenet
from rcmvsnet_tpu_torch.nn.costreg import CostRegNet, block_train
from rcmvsnet_tpu_torch.nn.featurenet import FeatureNet, block_train_bf16
from rcmvsnet_tpu_torch.nn.layers import ConvBNAct, DeconvBNAct, bn_apply_f32
from rcmvsnet_tpu_torch.ops import conv3d_train as K8
from rcmvsnet_tpu_torch.ops import warp_variance as K6
from rcmvsnet_tpu_torch.ops import warp_volume as K7
from rcmvsnet_tpu_torch.weights import (costreg_state_dict_from_jax,
                                        state_dict_from_jax, unconv,
                                        undeconv)
from tests.test_torch_bf16_eval import _assert_ulp, _bf16_np, _exact_cameras

torch.set_num_threads(2)
GOLDEN = Path(__file__).resolve().parent / "golden" / "backbone_synth.msgpack"
BF16 = torch.bfloat16
T = torch.from_numpy
V = 3
BLOCK_SHARE = 1e-3        # elements allowed beyond one bf16 ulp, a block
FEATURE_REL = 2.0 ** -8   # relative L2, a FeatureNet block (one bf16 ulp)
HEADS_REL = 2.0 ** -7     # relative L2, FeatureNet's heads (two ulps)
BN_GRAD = 1e-3            # × the largest, a U-Net block's dγ and dβ


# XLA may compute a fused chain of bf16 operations in float32 and round
# once ("excess precision"); the JAX source rounds each bf16 operation, and
# so does the port: the references are compiled without it
jit = partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


def interpret(mp):
    """Every Pallas kernel of the JAX package in interpret mode (the train
    kernels reached through flax modules read `_INTERPRET_DEFAULT`)."""
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    for mod in (pallas_costreg, pallas_costreg_train, pallas_resample,
                pallas_warp2, pallas_warp_train, pallas_warp_volume):
        mp.setattr(mod.pl, "pallas_call", interp)
    mp.setattr(pallas_costreg_train, "_INTERPRET_DEFAULT", True)


def f32_reductions(mp):
    """JAX's bf16 `reduce_sum` lowered as a float32 sum rounded once to
    bf16 (see the module doc); other dtypes as before."""
    orig = mlir._lowerings[jlax.reduce_sum_p]

    def f32_sum(v, **params):
        return jlax.reduce_sum_p.bind(v.astype(jnp.float32),
                                      **params).astype(v.dtype)

    lowered = mlir.lower_fun(f32_sum, multiple_results=False)

    def rule(ctx, x, **params):
        if ctx.avals_in[0].dtype == jnp.bfloat16:
            return lowered(ctx, x, **params)
        return orig.rule(ctx, x, **params)

    mp.setitem(mlir._lowerings, jlax.reduce_sum_p,
               type(orig)(rule, orig.inline))


@pytest.fixture(scope="module", autouse=True)
def jax_as_on_chip():
    with pytest.MonkeyPatch.context() as mp:
        interpret(mp)
        f32_reductions(mp)
        yield


def _warp_inputs(h, w, C, seed, D=8):
    """bf16 features and images, K1-bf16's test planes (dyadic depths,
    out-of-image taps included) and exact cameras."""
    rs = np.random.RandomState(seed)
    feats = np.array(_bf16_np(rs.randn(V, h, w, C)))
    imgs = np.array(_bf16_np(rs.rand(V, h, w, 3)))
    lo = (1.0 + rs.randint(0, 16, (h, w)) / 256.0).astype(np.float32)
    step = np.full((h, w), 3.0 / 1024.0, np.float32)
    return feats, imgs, _exact_cameras(V), lo, step, D, rs


def _cf(a) -> torch.Tensor:
    """[D, h, w, C] (numpy or JAX) → the port's [C, D, h, w] bf16."""
    return T(np.ascontiguousarray(np.transpose(
        np.asarray(jnp.asarray(a).astype(jnp.float32)), (3, 0, 1, 2)))).to(
        BF16)


@pytest.mark.parametrize("h,w,C", [(16, 16, 32), (16, 32, 8)])
def test_k6_bf16_matches_fused_train(h, w, C):
    """K6's bf16 plain version (and K1-bf16's forward) against
    `plane_sweep_variance_fused_train` at its bf16 defaults, through
    `jax.vjp` with a bf16 cotangent."""
    feats, _, projs, lo, step, D, rs = _warp_inputs(h, w, C, C + h)
    lay = make_layout(h, w)

    def fused(x):
        vol, viol = plane_sweep_variance_fused_train(
            x, jnp.asarray(projs), (jnp.asarray(lo), jnp.asarray(step), D),
            rows_per_step=4, band=8)
        return lanes_to_ndhwc(vol, lay, C), viol

    var_j, vjp, viol = jax.vjp(fused, jnp.asarray(feats).astype(
        jnp.bfloat16), has_aux=True)
    assert int(viol) == 0 and var_j.dtype == jnp.bfloat16
    g = _bf16_np(rs.randn(D, h, w, C))
    (dfeat_j,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    assert dfeat_j.dtype == jnp.bfloat16

    args = (T(feats).to(BF16), T(projs), T(lo), T(step))
    var = K6.warp_variance_plain(*args, D)
    _assert_ulp(var, np.transpose(np.asarray(var_j.astype(jnp.float32)),
                                  (3, 0, 1, 2)), "variance")
    got = K6.warp_variance_bwd_plain(*args, _cf(g))
    assert got.dtype == BF16
    _assert_ulp(got, dfeat_j, "dfeat")


def test_k7_bf16_matches_fused_volume():
    """K7's bf16 plain versions against `plane_sweep_volume_fused_train`
    at its bf16 defaults: the variance, the warped images and the no-ref
    variance, then the feature and image gradients through `jax.vjp`
    with bf16 cotangents for all three."""
    h, w, C = 16, 16, 32
    feats, imgs, projs, lo, step, D, rs = _warp_inputs(h, w, C, 7)
    lay = make_layout(h, w)
    nv = 3 * (V - 1)

    def fused(x, im):
        var, nr, img, viol = plane_sweep_volume_fused_train(
            x, im, jnp.asarray(projs),
            (jnp.asarray(lo), jnp.asarray(step), D), rows_per_step=4,
            band=8)
        return (lanes_to_ndhwc(var, lay, C), lanes_to_ndhwc(nr, lay, C),
                lanes_to_ndhwc(img, lay, nv)), viol

    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    (var_j, nr_j, img_j), vjp, viol = jax.vjp(fused, bf(feats), bf(imgs),
                                              has_aux=True)
    assert int(viol) == 0
    g_var, g_nr, g_img = (_bf16_np(rs.randn(D, h, w, c))
                          for c in (C, C, nv))
    dfeat_j, dimg_j = vjp((bf(g_var), bf(g_nr), bf(g_img)))

    args = (T(feats).to(BF16), T(imgs).to(BF16), T(projs), T(lo), T(step))
    var, vol = K7.warp_volume_plain(*args, D)
    assert var.dtype == vol.dtype == BF16
    cm = lambda a: np.transpose(np.asarray(a.astype(jnp.float32)),
                                (3, 0, 1, 2))
    _assert_ulp(var, cm(var_j), "var")
    _assert_ulp(vol[:nv], cm(img_j), "warped images")
    _assert_ulp(vol[nv:], cm(nr_j), "no-ref variance")
    g_vol = torch.cat([_cf(g_img), _cf(g_nr)])
    dfeat, dimg = K7.warp_volume_bwd_plain(*args, _cf(g_var), g_vol)
    assert dfeat.dtype == dimg.dtype == BF16
    _assert_ulp(dfeat, dfeat_j, "dfeat")
    _assert_ulp(dimg, dimg_j, "dimg")


@pytest.mark.parametrize("mode,ci,co,dhw", [
    ("s1", 16, 8, (8, 8, 16)), ("s2", 8, 16, (8, 8, 16)),
    ("t2", 16, 8, (4, 4, 8)), ("prob", 8, 1, (8, 8, 16))])
def test_k8_bf16_matches_conv_lanes_t(mode, ci, co, dhw):
    """K8's bf16 plain pair (`conv3d_train_plain` of a bf16 x) against
    `conv_lanes_t` at compute dtype bf16 through `jax.vjp`: the float32
    weight rounded inside, forward and dx bf16 (the prob head's output
    and cotangent float32, the cotangent rounded before dx and dw), dw
    float32."""
    d, h, w = dhw
    rs = np.random.RandomState(ci + co)
    x = _bf16_np(rs.randn(d, h, w, ci))
    k = (0.2 * rs.randn(3, 3, 3, ci, co)).astype(np.float32)
    lay = make_layout(h, w, 512)
    prob = mode == "prob"

    def f(xx, kk):
        xl = to_lanes(xx, lay, -(-ci // 8) * 8, jnp.bfloat16)
        if mode == "s2":
            lay2 = make_layout(h // 2, w // 2, 512)
            y = subsample_hw(conv_lanes_t(xl, kk, lay, z_stride=2,
                                          compute_dtype=jnp.bfloat16),
                             lay, lay2)
            return lanes_to_ndhwc(y[:, :co], lay2, co)
        if mode == "t2":
            lay2 = make_layout(2 * h, 2 * w, 512)
            y = conv_lanes_t(stuff_hw_z(xl, lay, lay2), kk, lay2,
                             compute_dtype=jnp.bfloat16)
            return lanes_to_ndhwc(y[:, :co], lay2, co)
        y = conv_lanes_t(xl, kk, lay, compute_dtype=jnp.bfloat16,
                         out_dtype=jnp.float32 if prob else None)
        return lanes_to_ndhwc(y[:, :co], lay, co)

    y_j, vjp = jax.vjp(f, jnp.asarray(x).astype(jnp.bfloat16),
                       jnp.asarray(k))
    assert y_j.dtype == (jnp.float32 if prob else jnp.bfloat16)
    g = rs.randn(*y_j.shape).astype(np.float32)
    if not prob:
        g = _bf16_np(g)
    dx_j, dk_j = vjp(jnp.asarray(g).astype(y_j.dtype))

    xt = T(np.ascontiguousarray(np.transpose(x, (3, 0, 1, 2))))[None]
    xt = xt.to(BF16).requires_grad_(True)
    wt = T(undeconv(k) if mode == "t2" else unconv(k)).requires_grad_(True)
    y = K8.conv3d_train_plain(xt, wt, "s1" if prob else mode,
                              out_dtype=torch.float32 if prob else None)
    assert y.dtype == (torch.float32 if prob else BF16)
    _assert_ulp(y[0].detach(), np.transpose(np.asarray(
        y_j.astype(jnp.float32)), (3, 0, 1, 2)), "forward")
    gt = T(np.ascontiguousarray(np.transpose(g, (3, 0, 1, 2))))[None]
    y.backward(gt.to(y.dtype))
    assert xt.grad.dtype == BF16 and wt.grad.dtype == torch.float32
    _assert_ulp(xt.grad[0], np.transpose(np.asarray(
        dx_j.astype(jnp.float32)), (3, 0, 1, 2)), "dx")
    want = undeconv(dk_j) if mode == "t2" else unconv(dk_j)
    err = float(np.abs(wt.grad.numpy() - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), ("dw", err)


def test_k8_bf16_function_passes_float32_bias(monkeypatch):
    """K2's bias is float32 in every instance: the bf16 Function hands it
    a float32 zero bias, forward and adjoint, and a float32 x gets the
    same."""
    seen = []
    real = K8.conv3d

    def spy(x, weight, bias, *a, **kw):
        seen.append((x.dtype, bias.dtype))
        return real(x, weight, bias, *a, **kw)

    monkeypatch.setattr(K8, "conv3d", spy)
    for dt in (BF16, torch.float32):
        x = torch.randn(1, 8, 4, 4, 8).to(dt).requires_grad_(True)
        w = torch.randn(8, 8, 3, 3, 3, requires_grad=True)
        K8.conv3d_train(x, w, "s2").float().sum().backward()
    assert [b for _, b in seen] == [torch.float32] * 4, seen
    assert [x for x, _ in seen] == [BF16, BF16, torch.float32,
                                    torch.float32]


# ------------------------------------------------------------------ blocks

def _hold(what, got: torch.Tensor, want, share=BLOCK_SHARE):
    """At most `share` of the elements beyond one bf16 ulp + 1e-4 of the
    largest value."""
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    over = np.abs(g - w) > np.abs(w) * 2.0 ** -7 + 1e-4 * np.abs(w).max()
    assert over.mean() <= share, (what, float(over.mean()),
                                  float(np.abs(g - w).max()))


def _hold_f32(what, got: torch.Tensor, want, tol=1e-4):
    """Every element within tol of the largest value."""
    w = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().numpy() - w).max())
    assert err <= tol * float(np.abs(w).max()), (what, err)


def _rel_l2(what, got: torch.Tensor, want, tol=FEATURE_REL):
    """‖got − want‖₂ / ‖want‖₂ within tol."""
    g = got.detach().float().numpy().ravel()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32)).ravel()
    assert g.shape == w.shape, (what, g.shape, w.shape)
    rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    assert rel <= tol, (what, rel)


def _hold_stats(what, bn, want):
    """Running mean and variance within 1e-5 of each one's largest
    value."""
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        _hold_f32(f"{what} {buf}", getattr(bn, buf), want[key], 1e-5)


def _nchw(a) -> torch.Tensor:
    """JAX NHWC (or NDHWC) bf16 → the port's NCHW (NCDHW) bf16."""
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    return T(np.ascontiguousarray(np.moveaxis(a, -1, 1))).to(BF16)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.movedim(1, -1)


FEATURE_BLOCKS = (("conv0_0", "conv0", 0, 8, 3, 1),
                  ("conv0_1", "conv0", 1, 8, 3, 1),
                  ("conv1_0", "conv1", 0, 16, 5, 2),
                  ("conv1_1", "conv1", 1, 16, 3, 1),
                  ("conv1_2", "conv1", 2, 16, 3, 1),
                  ("conv2_0", "conv2", 0, 32, 5, 2),
                  ("conv2_1", "conv2", 1, 32, 3, 1),
                  ("conv2_2", "conv2", 2, 32, 3, 1))
HEADS = ("out1", "inner1", "out2", "inner2", "out3")


@pytest.fixture(scope="module")
def feature():
    """JAX's bf16 FeatureNet at the golden weights on 4 seeded 64×64
    images (BN over 16384, 4096 and 1024 values a channel): each block's
    input, and its output, input and parameter cotangents and running
    statistics for a seeded output cotangent; the heads' outputs and
    parameter gradients for seeded cotangents of the three outputs."""
    blob = flax.serialization.msgpack_restore(GOLDEN.read_bytes())
    P, S = blob["params"]["feature"], blob["batch_stats"]["feature"]
    rs = np.random.RandomState(11)
    x = jnp.asarray(rs.rand(4, 64, 64, 3).astype(np.float32)).astype(
        jnp.bfloat16)
    net = JFeatureNet(8, 3)
    g_out = {k: jnp.asarray(rs.randn(4, 64 // s, 64 // s, c).astype(
        np.float32)) for k, s, c in (("stage1", 4, 32), ("stage2", 2, 16),
                                     ("stage3", 1, 8))}

    def whole(p, xx):
        out, st = net.apply({"params": p, "batch_stats": S}, xx, True,
                            mutable=["batch_stats", "intermediates"],
                            capture_intermediates=True)
        loss = sum(jnp.sum(out[k].astype(jnp.float32) * g_out[k])
                   for k in g_out)
        return loss, (out, st["intermediates"])

    (_, (out, inter)), grads = jit(jax.value_and_grad(
        whole, has_aux=True))(P, x)
    blocks = {}
    xin = x
    for name, _, _, co, k, st in FEATURE_BLOCKS:
        blk = JConvBNAct(co, (k, k), (st, st), (k // 2, k // 2))

        def f(p, xx, blk=blk, name=name):
            return blk.apply({"params": p, "batch_stats": S[name]}, xx,
                             True, mutable=["batch_stats"])

        @jit
        def run(p, xx, gg, f=f):
            y, vjp, mut = jax.vjp(f, p, xx, has_aux=True)
            return y, mut, vjp(gg)

        h = xin.shape[1] // st
        g = jnp.asarray(rs.randn(4, h, h, co).astype(np.float32)).astype(
            jnp.bfloat16)
        y, mut, (gp, gx) = run(P[name], xin, g)
        blocks[name] = dict(x=xin, y=y, g=g, gp=gp, gx=gx,
                            stats=mut["batch_stats"]["TorchBatchNorm_0"])
        xin = inter[name]["__call__"][0]
    acts = [inter[n]["__call__"][0] for n in ("conv0_1", "conv1_2",
                                               "conv2_2")]
    sd = {k[len("feature."):]: v for k, v in state_dict_from_jax(
        blob["params"], blob["batch_stats"]).items()
        if k.startswith("feature.")}
    return dict(blocks=blocks, out=out, grads=grads, acts=acts, g_out=g_out,
                sd=sd)


def _port_feature(feature) -> FeatureNet:
    net = FeatureNet(8)
    net.load_state_dict(feature["sd"], strict=True)
    return net.train()


def _check_feature_block(feature, name, seq, i):
    """FeatureNet's block `name` on JAX's input and cotangent: output,
    input and parameter gradients (dw rounded to bf16 in both) within
    FEATURE_REL, running statistics within 1e-5 of their largest value. Each BN factor
    is rounded to bf16 from float32 statistics that the two sum in
    another order: where those straddle a bf16 rounding boundary the
    factor rounds apart in one channel and every element of it moves by
    one ulp of that factor (conv1_2 here: 1.4e-3 of y, 2.3e-3 of dx, in
    relative L2; the other blocks ≤ 3.6e-4). Hence relative L2 at one
    bf16 ulp rather than each element's ulp."""
    ref = feature["blocks"][name]
    blk = getattr(_port_feature(feature), seq)[i]
    x = _nchw(ref["x"]).requires_grad_(True)
    y = block_train_bf16(blk, x)
    assert y.dtype == BF16
    y.backward(_nchw(ref["g"]))
    _rel_l2(f"{name} y", _nhwc(y), ref["y"])
    _rel_l2(f"{name} dx", _nhwc(x.grad), ref["gx"])
    dw = np.transpose(np.asarray(ref["gp"]["Conv_0"]["kernel"]),
                      (3, 2, 0, 1))
    _rel_l2(f"{name} dw", blk.conv.weight.grad, dw)
    bn = ref["gp"]["TorchBatchNorm_0"]
    _rel_l2(f"{name} dgamma", blk.bn.weight.grad, bn["scale"])
    _rel_l2(f"{name} dbeta", blk.bn.bias.grad, bn["bias"])
    _hold_stats(name, blk.bn, ref["stats"])


@pytest.mark.parametrize("name,seq,i", [b[:3] for b in FEATURE_BLOCKS])
def test_featurenet_block_bf16_matches_jax(feature, name, seq, i):
    """Each FeatureNet block at bf16 against JAX's `ConvBNAct` (XLA conv
    at dtype bf16, `TorchBatchNorm`: float32 statistics, each factor
    rounded to bf16 and the arithmetic bf16), fed JAX's own input."""
    _check_feature_block(feature, name, seq, i)


def test_featurenet_heads_bf16_match_jax(feature):
    """FeatureNet's heads at bf16 on JAX's trunk outputs: the three
    outputs (bf16) within one bf16 ulp at all but BLOCK_SHARE of their
    elements, and the heads' parameter gradients for the seeded output
    cotangents within HEADS_REL. Each of those is a sum over every pixel,
    rounded to bf16 once, of cotangents that JAX rounds twice where the
    port rounds once (the nearest upsample's adjoint: JAX scatters one
    axis at a time in bf16): measured 1.6e-3–3.6e-3 (inner1's bias)."""
    net = _port_feature(feature)
    out = net.heads_bf16(*[_nchw(a) for a in feature["acts"]])
    loss = 0.0
    for k, g in feature["g_out"].items():
        assert out[k].dtype == BF16
        _hold(k, _nhwc(out[k]), feature["out"][k])
        loss = loss + (_nhwc(out[k]).float() * T(np.array(g))).sum()
    loss.backward()
    for head in HEADS:
        m, ref = getattr(net, head), feature["grads"][head]["Conv_0"]
        _rel_l2(f"{head} dw", m.weight.grad, np.transpose(
            np.asarray(ref["kernel"]), (3, 2, 0, 1)), HEADS_REL)
        if m.bias is not None:
            _rel_l2(f"{head} dbias", m.bias.grad, ref["bias"], HEADS_REL)


def test_featurenet_block_gate_catches_unrounded_bn(feature, monkeypatch):
    """The gate fails, in every block, when FeatureNet's BN is applied in
    float32 with its factors unrounded (the U-Nets' rule) instead of
    JAX's rounded bf16 factors and arithmetic (measured: dx, dw and dβ
    6.8e-3–4.4e-2 in relative L2)."""
    monkeypatch.setattr(port_featurenet, "bn_apply_rounded", bn_apply_f32)
    for name, seq, i, *_ in FEATURE_BLOCKS:
        with pytest.raises(AssertionError, match=name):
            _check_feature_block(feature, name, seq, i)


# (mode, relu, Ci, Co, input D, h, w): the CostRegNet blocks' modes with
# ReLU, the render U-Net's without; BN over ≥ 512 values a channel
UNET_BLOCKS = (("s1", True, 32, 8, (8, 16, 16)),
               ("s2", True, 8, 16, (16, 16, 16)),
               ("t2", False, 16, 8, (4, 8, 8)))


def _unet_ref(mode, relu, ci, co, dhw, seed):
    """JAX's `_LanesConvBN` at bf16 on a seeded input, with a seeded
    non-trivial BN scale and bias: its variables, input, output and the
    input and parameter cotangents for a seeded output cotangent."""
    d, h, w = dhw
    rs = np.random.RandomState(seed)
    x = _bf16_np(rs.randn(d, h, w, ci) * 2.0 + 0.5)
    lay = make_layout(h, w)
    lay2 = {"s2": make_layout(h // 2, w // 2),
            "t2": make_layout(2 * h, 2 * w)}.get(mode, lay)
    kw = {} if mode == "t2" else {"z_stride": 2 if mode == "s2" else 1}
    blk = _LanesConvBN(ci, co, deconv=mode == "t2", relu=relu)
    lanes = lambda xx: to_lanes(xx, lay, ci, jnp.bfloat16)
    variables = blk.init(jax.random.PRNGKey(seed),
                         lanes(jnp.asarray(x)), lay, lay2, **kw)
    params = {**variables["params"], "TorchBatchNorm_0": {
        "scale": jnp.asarray(0.5 + rs.rand(co), jnp.float32),
        "bias": jnp.asarray(rs.randn(co), jnp.float32)}}

    def f(p, xx):
        y, mut = blk.apply({"params": p,
                            "batch_stats": variables["batch_stats"]},
                           lanes(xx), lay, lay2, mutable=["batch_stats"],
                           **kw)
        return lanes_to_ndhwc(y, lay2, co), mut["batch_stats"]

    out_dhw = (d // 2, h // 2, w // 2) if mode == "s2" else (
        (2 * d, 2 * h, 2 * w) if mode == "t2" else dhw)
    g = jnp.asarray(_bf16_np(rs.randn(*out_dhw, co))).astype(jnp.bfloat16)

    @jit
    def run(p, xx, gg):
        y, vjp, stats = jax.vjp(f, p, xx, has_aux=True)
        return y, stats, vjp(gg)

    y, stats, (gp, gx) = run(params, jnp.asarray(x).astype(jnp.bfloat16), g)
    return dict(params=params, x=x, y=y, g=g, gp=gp, gx=gx,
                stats=stats["TorchBatchNorm_0"])


@pytest.fixture(scope="module")
def unet_refs():
    return {case: _unet_ref(*case, seed=20 + n)
            for n, case in enumerate(UNET_BLOCKS)}


def _check_unet_block(ref, mode, relu, ci, co):
    """`block_train` (K8's bf16 plain pair → float32 BN rounded once →
    [ReLU]) on JAX's input and cotangent."""
    deconv = mode == "t2"
    mod = DeconvBNAct(ci, co) if deconv else ConvBNAct(ci, co, 3, 1, 1,
                                                       dims=3)
    kernel = lambda p: np.asarray(p["kernel"] if deconv
                                  else p["Conv_0"]["kernel"])
    k = kernel(ref["params"])
    mod.conv.weight.data = T(undeconv(k) if deconv else unconv(k))
    bn = ref["params"]["TorchBatchNorm_0"]
    mod.bn.weight.data = T(np.array(bn["scale"]))
    mod.bn.bias.data = T(np.array(bn["bias"]))
    mod.train()
    x = _nchw(ref["x"][None]).requires_grad_(True)
    y = block_train(mod.conv, mod.bn, x, mode, relu, plain=True)
    assert y.dtype == BF16
    y.backward(_nchw(ref["g"][None]))
    _hold("y", _nhwc(y)[0], ref["y"])
    _hold("dx", _nhwc(x.grad)[0], ref["gx"])
    dk = kernel(ref["gp"])
    _hold_f32("dw", mod.conv.weight.grad, undeconv(dk) if deconv
              else unconv(dk))
    gbn = ref["gp"]["TorchBatchNorm_0"]
    _hold_f32("dgamma", mod.bn.weight.grad, gbn["scale"], BN_GRAD)
    _hold_f32("dbeta", mod.bn.bias.grad, gbn["bias"], BN_GRAD)
    _hold_stats(mode, mod.bn, ref["stats"])


@pytest.mark.parametrize("case", UNET_BLOCKS,
                         ids=[f"{m}-{'relu' if r else 'linear'}-{ci}-{co}"
                              for m, r, ci, co, _ in UNET_BLOCKS])
def test_unet_block_bf16_matches_jax(unet_refs, case):
    """A U-Net block at bf16 against JAX's `_LanesConvBN` (K8's lanes
    conv at compute dtype bf16, `bn_stats_lanes` / `bn_apply_lanes`),
    fed JAX's own input: y and dx within one bf16 ulp at all but
    BLOCK_SHARE of their elements, dw (float32) within 1e-4 of its
    largest value, dγ and dβ (float32 sums over every position, in
    another order) within BN_GRAD of theirs, the running statistics
    within 1e-5 of their largest value."""
    _check_unet_block(unet_refs[case], *case[:4])


def test_unet_block_gate_catches_scaled_dw(unet_refs, monkeypatch):
    """The gate fails when K8's plain dw is 1 % too large."""
    real = K8.conv3d_dw_plain
    monkeypatch.setattr(K8, "conv3d_dw_plain",
                        lambda *a, **kw: real(*a, **kw) * 1.01)
    case = UNET_BLOCKS[0]
    with pytest.raises(AssertionError, match="dw"):
        _check_unet_block(unet_refs[case], *case[:4])


# chained CostRegNet (see the module doc), relative L2: measured at this
# input, port vs JAX, cost 1.1e-3, dx 1.4e-2, all parameter gradients
# together 1.5e-2; the port against itself with one input element moved
# by one ulp, 1.3e-3, 1.6e-2, 1.8e-2
CHAIN_COST, CHAIN_GRAD = 2.0 ** -7, 2.0 ** -5


def test_costregnet_bf16_forward_train_matches_jax():
    """CostRegNet `forward_train` at bf16 (the stage-1 U-Net at the
    golden weights, a seeded [16, 32, 32] 32-channel volume, a seeded
    cotangent of the float32 cost) against JAX's lanes U-Net at bf16:
    the cost in relative L2 within CHAIN_COST, dx and the parameter
    gradients (all together) within CHAIN_GRAD, the running statistics
    within 1e-3 of each tensor's largest value (measured 2.2e-4)."""
    blob = flax.serialization.msgpack_restore(GOLDEN.read_bytes())
    p0 = blob["params"]["stage1"]["cost_reg"]
    s0 = blob["batch_stats"]["stage1"]["cost_reg"]
    rs = np.random.RandomState(1)
    x = _bf16_np(rs.randn(1, 16, 32, 32, 32))
    g = rs.randn(1, 16, 32, 32, 1).astype(np.float32)
    J = JCostRegNet(8, train_impl="lanes")

    def f(p, xx):
        y, mut = J.apply({"params": p, "batch_stats": s0}, xx, True,
                         mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut)

    (_, (y_j, mut)), (gp, gx) = jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p0, jnp.asarray(x).astype(
            jnp.bfloat16))
    net = CostRegNet(32, 8)
    net.load_state_dict(costreg_state_dict_from_jax(p0, s0), strict=True)
    net.train()
    xt = _nchw(x).requires_grad_(True)
    y = net.forward_train(xt)
    assert y.dtype == torch.float32 and xt.grad is None
    (_nhwc(y) * T(g)).sum().backward()
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    assert rel(_nhwc(y).detach().numpy(), f32(y_j)) <= CHAIN_COST
    assert rel(_nhwc(xt.grad).float().numpy(), f32(gx)) <= CHAIN_GRAD
    want = costreg_state_dict_from_jax(gp, mut["batch_stats"])
    names = [n for n, _ in net.named_parameters()]
    params = dict(net.named_parameters())
    assert rel(np.concatenate([params[n].grad.numpy().ravel()
                               for n in names]),
               np.concatenate([want[n].numpy().ravel()
                               for n in names])) <= CHAIN_GRAD
    for name, buf in net.named_buffers():
        if "running" in name:
            w = want[name].numpy()
            assert np.abs(buf.numpy() - w).max() <= 1e-3 * np.abs(w).max(), \
                name
