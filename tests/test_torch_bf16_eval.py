"""The bf16 eval path of the PyTorch port (`BackboneConfig.eval_dtype =
"bfloat16"`) against the JAX package's bf16 eval path, on the CPU.

The JAX eval CLI runs its chip's eval in bf16 (`cli/eval_dtu.build_forward`:
`pack_featurenet` + `featurenet_packed` on bf16 images, then the fused
cascade, whose `plane_sweep_variance_lanes` and `costreg_lanes` default to
compute dtype bf16). Here the Pallas kernels run in interpret mode, as
`tests/test_cascade_fastpath.py` runs them, and the port runs its bf16
plain versions (a kernel's float32 plain version on the bf16 operands,
rounded where the kernel rounds). Inputs come from seeds with numpy; the
weights are the golden backbone's, through `weights.state_dict_from_jax`.

  * Per kernel, each within one bf16 ulp of each element (2^-7 of its
    magnitude) plus 1e-4 of the largest value, where both sides sum in
    float32 in different orders and round once: K5 (`conv2d_cm` on a bf16
    input: the tensor-core shapes, a 1×1 head in the warp layout), the
    FPN's upsample-add and stage 3's lateral head against JAX's
    composition of `upsample2_cm`, `matmul_cm` and `conv2d_cm`; K1
    (`plane_sweep_variance_lanes` at its defaults, on cameras whose
    coordinates are exact in float32); K2 (`conv_lanes` in
    s1, s2 with `subsample_lanes`, t2 with `stuff_lanes` and a skip, and
    the float32 prob head).
  * The slice: the port's `CascadeMVSNet` (eval_dtype bfloat16, plain)
    against the JAX eval CLI's composition, 64×64, V=3, ndepths 8/8/8:
    depth within 2e-3 relative at every pixel and 2e-4 on average at each
    stage, 25× tighter than the JAX package's own bf16-vs-f32 budget
    (`test_cascade_fastpath.py`: 5e-2 and 5e-3); measured 2.9e-4 and
    5.8e-5. Both are bf16 paths that round at the same places, but a sum
    in another order flips a rounding now and then (about 1 element in
    10^4 a layer), and each flip spreads through the next layers; stage 3's
    head is the lateral head here and `_stage3_polyphase` there (the same
    function, rounded elsewhere). Stage 1's and stage 2's features equal
    JAX's in every bit in ≥ 85 % of their elements (measured 90 %), where
    float32 features would in almost none.
"""
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rcmvsnet_tpu.models.cascade import CascadeMVSNet as JCascade
from rcmvsnet_tpu.nn.featurenet_fast import featurenet_packed, pack_featurenet
from rcmvsnet_tpu.ops import (pallas_conv2d, pallas_costreg, pallas_resample,
                              pallas_tail, pallas_warp2)
from rcmvsnet_tpu.ops.pallas_conv2d import (cm_from_nhwc, cm_to_nhwc,
                                            conv2d_cm, make_geo, matmul_cm,
                                            upsample2_cm)
from rcmvsnet_tpu.ops.pallas_costreg import (conv_lanes,
                                             fold_costreg_variables,
                                             make_layout, to_lanes)
from rcmvsnet_tpu.ops.pallas_resample import stuff_lanes, subsample_lanes
from rcmvsnet_tpu.ops.pallas_warp2 import plane_sweep_variance_lanes
from rcmvsnet_tpu_torch.config import BackboneConfig
from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
from rcmvsnet_tpu_torch.nn.layers import fold_bn
from rcmvsnet_tpu_torch.ops import conv2d as K5
from rcmvsnet_tpu_torch.ops import conv3d as K2
from rcmvsnet_tpu_torch.ops import warp_variance as K1
from rcmvsnet_tpu_torch.weights import state_dict_from_jax
from tests.test_models import _dtu_like_inputs
from tests.test_torch_nets import _from_lanes, _from_warp

torch.set_num_threads(2)
GOLDEN = Path(__file__).resolve().parent / "golden" / "backbone_synth.msgpack"
BF16 = torch.bfloat16
T = torch.from_numpy


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    for mod in (pallas_conv2d, pallas_costreg, pallas_resample, pallas_tail,
                pallas_warp2):
        monkeypatch.setattr(mod.pl, "pallas_call", interp)


@pytest.fixture(scope="module")
def golden():
    blob = flax.serialization.msgpack_restore(GOLDEN.read_bytes())
    return blob["params"], blob["batch_stats"], state_dict_from_jax(
        blob["params"], blob["batch_stats"])


def _bf16_np(a) -> np.ndarray:
    """float32 values of an array rounded to bf16."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _assert_ulp(got: torch.Tensor, want, what=""):
    """|got − want| ≤ 2^-7·|want| + 1e-4·max|want| at every element."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    tol = np.abs(w) * 2.0 ** -7 + 1e-4 * np.abs(w).max()
    over = int((np.abs(g - w) > tol).sum())
    assert over == 0, (what, over, float(np.abs(g - w).max()))


@pytest.mark.parametrize("k,stride,ci,co,layout", [
    (3, 1, 3, 8, "cm"), (3, 1, 8, 8, "cm"), (5, 2, 8, 16, "cm"),
    (3, 1, 32, 32, "cm"), (1, 1, 32, 32, "warp")])
def test_conv2d_bf16_matches_conv2d_cm(k, stride, ci, co, layout):
    """K5's bf16 plain version against `conv2d_cm` on a bf16 input: BN's
    scale folded into the bf16 kernel and the product rounded again (as
    `conv2d_cm` folds it), the shift a float32 bias, ReLU, a bf16 output;
    the 1×1 head writes the warp layout."""
    rs = np.random.RandomState(10 * k + ci)
    x = _bf16_np(rs.randn(2, 16, 24, ci))
    kern = _bf16_np(rs.randn(k, k, ci, co) * 0.2)
    scale = (0.5 + rs.rand(co)).astype(np.float32)
    shift = rs.randn(co).astype(np.float32)
    relu = layout == "cm"
    geo = make_geo(2, 16, 24, margin=4)
    kw = dict(scale=jnp.asarray(scale), shift=jnp.asarray(shift))
    out, g2 = conv2d_cm(cm_from_nhwc(jnp.asarray(x).astype(jnp.bfloat16),
                                     geo), geo,
                        jnp.asarray(kern).astype(jnp.bfloat16),
                        stride=stride, padding=k // 2, relu=relu,
                        out_layout=layout, **(kw if relu else {}))
    assert out.dtype == jnp.bfloat16
    xt = T(x).permute(0, 3, 1, 2).to(BF16)
    wt = T(kern).permute(3, 2, 0, 1)
    if relu:
        wt = (wt * T(scale)[:, None, None, None]).to(BF16)
        got = K5.conv2d_plain(xt, wt, None, T(shift), stride=stride,
                              padding=k // 2, relu=True)
        _assert_ulp(got.permute(0, 2, 3, 1), cm_to_nhwc(out, g2))
    else:
        got = K5.conv2d_plain(xt, wt.to(BF16), out_layout="warp")
        _assert_ulp(got, _from_warp(out, (2, g2.hm, g2.row0, co,
                                          -(-g2.width // 128) * 128))(16, 24))
    assert got.dtype == BF16


def test_fpn_upsample_add_and_lateral_head_bf16_match_jax():
    """The FPN's inner1 + nearest-×2 upsample-add, and stage 3's lateral
    head (inner2 + upsample-add + out3 in one call), against JAX's
    `featurenet_packed` composition of them (`matmul_cm` with the 1×1
    weights cast to bf16, a bf16 + bf16 add, `conv2d_cm`): the 1×1 sum
    rounded to bf16, then the sum with the upsampled map again."""
    rs = np.random.RandomState(4)
    n, h, w = 2, 16, 24
    intra2 = _bf16_np(rs.randn(n, h // 2, w // 2, 32))     # stage-2 intra
    conv0 = _bf16_np(rs.randn(n, h, w, 8))
    w2 = (rs.randn(8, 32) * 0.3).astype(np.float32)        # [Ci, Co]
    b2 = rs.randn(32).astype(np.float32)
    k3 = _bf16_np(rs.randn(3, 3, 32, 8) * 0.1)
    geo = make_geo(n, h, w, margin=4)
    geo2 = geo.halved()
    up, geo_up = upsample2_cm(
        cm_from_nhwc(jnp.asarray(intra2).astype(jnp.bfloat16), geo2), geo2)
    assert geo_up == geo
    intra = up + matmul_cm(
        cm_from_nhwc(jnp.asarray(conv0).astype(jnp.bfloat16), geo), geo,
        jnp.asarray(w2), jnp.asarray(b2))
    out3, _ = conv2d_cm(intra, geo, jnp.asarray(k3).astype(jnp.bfloat16),
                        stride=1, padding=1)
    up_t = T(intra2).permute(0, 3, 1, 2).to(BF16)
    lat = T(conv0).permute(0, 3, 1, 2).to(BF16)
    wi = T(w2).t()[:, :, None, None].to(BF16)
    s = K5.conv2d_plain(lat, wi, shift=T(b2), up=up_t)
    _assert_ulp(s.permute(0, 2, 3, 1), cm_to_nhwc(intra, geo), "up-add")
    got = K5.lateral_conv2d_plain(up_t, lat, wi, T(b2),
                                  T(k3).permute(3, 2, 0, 1).to(BF16))
    assert got.dtype == BF16
    _assert_ulp(got.permute(0, 2, 3, 1), cm_to_nhwc(out3, geo), "lateral")


def _exact_cameras(V: int) -> np.ndarray:
    """[V, 4, 4] projections whose sample coordinates are exact in float32:
    the reference at the identity, source v at px = x·dv + v/4, py = y·dv −
    v/8, Z = 1. JAX computes a coordinate as X·(1/Z) and the port as X/Z;
    elsewhere the two differ by an ulp now and then, which flips the bf16
    rounding of an x weight and moves that sample by 2^-8 of its taps'
    difference. That belongs to the float32 coordinates, not to the bf16
    arithmetic held here."""
    P = np.zeros((V, 4, 4), np.float32)
    P[0] = np.eye(4)
    for v in range(1, V):
        P[v, 0, 0] = P[v, 1, 1] = 1.0
        P[v, 0, 3], P[v, 1, 3] = v / 4.0, -v / 8.0
        P[v, 2, 3] = P[v, 3, 3] = 1.0
    return P


@pytest.mark.parametrize("h,w,C", [(16, 16, 32), (32, 32, 16), (32, 64, 8)])
def test_warp_variance_bf16_matches_plane_sweep_variance_lanes(h, w, C):
    """K1's bf16 plain version against `plane_sweep_variance_lanes` at its
    defaults (compute and output dtype bf16), 8 planes per pixel at
    dyadic depths (x weights of up to 10 fractional bits, which bf16
    rounds), out-of-image taps included."""
    rs = np.random.RandomState(C + h)
    feats = _bf16_np(rs.randn(3, h, w, C))
    lo = (1.0 + rs.randint(0, 16, (h, w)) / 256.0).astype(np.float32)
    step = np.full((h, w), 3.0 / 1024.0, np.float32)
    projs = _exact_cameras(3)
    lay = make_layout(h, w)
    vol, viol = plane_sweep_variance_lanes(
        jnp.asarray(feats).astype(jnp.bfloat16), jnp.asarray(projs), None,
        lay, rows_per_step=4, band=8,
        depth_planes=(jnp.asarray(lo), jnp.asarray(step), 8))
    assert int(viol) == 0 and vol.dtype == jnp.bfloat16
    got = K1.warp_variance_plain(T(feats).to(BF16), T(projs), T(lo), T(step),
                                 8)
    assert got.dtype == BF16
    _assert_ulp(got, _from_lanes(vol.astype(jnp.float32), lay, C))


@pytest.mark.parametrize("mode", ["s1", "s2", "t2", "prob"])
def test_conv3d_bf16_matches_conv_lanes(golden, mode):
    """K2's bf16 plain version against `conv_lanes` at compute dtype bf16:
    the folded weights rounded to bf16 once, the float32 bias, ReLU, the
    bf16 skip added in float32 before the output's rounding (t2, over
    `stuff_lanes`), s2 over `subsample_lanes`, and the prob head's float32
    output."""
    params, stats, sd = golden
    cp, cs = params["stage2"]["cost_reg"], stats["stage2"]["cost_reg"]
    name = {"s1": "conv2", "s2": "conv3", "t2": "conv9", "prob": "prob"}[mode]
    if mode == "prob":
        k_j, b_j = cp["prob"]["Conv_0"]["kernel"], np.zeros(1, np.float32)
    else:
        k_j, b_j = fold_costreg_variables(cp, cs)[name]
    k_j, b_j = np.asarray(k_j), np.asarray(b_j)
    ci, co = k_j.shape[3], k_j.shape[4]
    d, h, w = (4, 4, 8) if mode == "t2" else (8, 8, 16)
    rs = np.random.RandomState(12)
    x = _bf16_np(rs.randn(d, h, w, ci))
    lay = make_layout(h, w, 512)
    xl = to_lanes(jnp.asarray(x), lay, -(-ci // 8) * 8, jnp.bfloat16)
    skip = None
    if mode == "s2":
        lay2 = make_layout(h // 2, w // 2, 512)
        y = subsample_lanes(conv_lanes(xl, k_j, b_j, lay, z_stride=2),
                            lay, lay2)
        want = _from_lanes(y.astype(jnp.float32), lay2, co)
    elif mode == "t2":
        lay2 = make_layout(2 * h, 2 * w, 512)
        skip = _bf16_np(rs.randn(2 * d, 2 * h, 2 * w, co))
        y = conv_lanes(stuff_lanes(xl, lay, lay2), k_j, b_j, lay2,
                       skip=to_lanes(jnp.asarray(skip), lay2,
                                     -(-co // 8) * 8, jnp.bfloat16))
        want = _from_lanes(y.astype(jnp.float32), lay2, co)
    else:
        y = conv_lanes(xl, k_j, b_j, lay, relu=mode != "prob",
                       out_dtype=jnp.float32 if mode == "prob" else None)
        assert y.dtype == (jnp.float32 if mode == "prob" else jnp.bfloat16)
        want = _from_lanes(y.astype(jnp.float32), lay, co)

    blk = f"cost_regularization.1.{name}"
    if mode == "prob":
        wt, bt = sd[f"{blk}.weight"], torch.zeros(1)
    else:
        wt, bt = fold_bn(sd[f"{blk}.conv.weight"], sd[f"{blk}.bn.weight"],
                         sd[f"{blk}.bn.bias"], sd[f"{blk}.bn.running_mean"],
                         sd[f"{blk}.bn.running_var"],
                         out_dim=1 if mode == "t2" else 0)
    xt = T(x).permute(3, 0, 1, 2)[None].to(BF16)
    sk = (T(skip).permute(3, 0, 1, 2)[None].to(BF16)
          if skip is not None else None)
    got = K2.conv3d_plain(xt, wt.to(BF16), bt,
                          "s1" if mode == "prob" else mode,
                          relu=mode != "prob", skip=sk,
                          out_dtype=torch.float32 if mode == "prob" else None)
    assert got.dtype == (torch.float32 if mode == "prob" else BF16)
    _assert_ulp(got[0], want, mode)


def test_bf16_slice_matches_jax_eval_path(golden):
    """The port's bf16 eval (CascadeMVSNet with eval_dtype bfloat16, plain)
    against the JAX eval CLI's: `featurenet_packed` on bf16 images in the
    warp layout, then the fused cascade (Pallas warp, lanes U-Net and
    tail, `test_cascade_fastpath.py`'s flags), as `eval_dtu.build_forward`
    composes them. Tolerances in the module's note."""
    params, stats, sd = golden
    imgs, projs, dv = _dtu_like_inputs(B=1, V=3, H=64, W=64, ndepth=32)
    variables = {"params": params, "batch_stats": stats}
    feats_j = featurenet_packed(
        pack_featurenet(params["feature"], stats["feature"]),
        jnp.asarray(imgs).astype(jnp.bfloat16).reshape(-1, 64, 64, 3),
        out_layout="warp")
    fast = JCascade(ndepths=(8, 8, 8),
                    pallas_warp_max_bytes=32 * 1024 * 1024,
                    pallas_warp_rows=4, pallas_warp_band=8,
                    pallas_costreg=True, pallas_tail=True)
    want = fast.apply(variables, jnp.asarray(imgs),
                      jax.tree_util.tree_map(jnp.asarray, projs),
                      jnp.asarray(dv), train=False, features_warp=feats_j)
    assert int(np.asarray(want["warp_violations"]).sum()) == 0

    model = CascadeMVSNet(BackboneConfig(ndepths=(8, 8, 8),
                                         eval_dtype="bfloat16"))
    model.load_state_dict(sd, strict=True)
    model.eval()
    x = T(imgs).reshape(3, 64, 64, 3).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        feats = model.feature.forward_folded(x, plain=True,
                                             out_layout="warp", dtype=BF16)
        got = model(T(imgs), {k: T(v) for k, v in projs.items()}, T(dv),
                    plain=True)
    for key, sc in (("stage1", 4), ("stage2", 2)):
        f = feats[key]
        ref = _from_warp(*feats_j[key])(64 // sc, 64 // sc)
        same = np.mean(f.float().numpy() == np.asarray(ref, np.float32))
        assert f.dtype == BF16 and same >= 0.85, (key, same)
    for key in ("stage1", "stage2", "stage3"):
        d_j = np.asarray(want[key]["depth"])
        d_t = got[key]["depth"].numpy()
        assert got[key]["depth"].dtype == torch.float32
        rel = np.abs(d_t - d_j) / np.abs(d_j)
        assert rel.max() <= 2e-3 and rel.mean() <= 2e-4, (
            key, rel.max(), rel.mean())
