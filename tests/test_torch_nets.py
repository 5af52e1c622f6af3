"""FeatureNet and CostRegNet of the PyTorch port against the JAX package, on
the CPU, with the golden backbone's trained weights and BN statistics.

  * FeatureNet, as modules and folded through K5's plain version, against
    FeatureNet.apply(train=False) and featurenet_packed (Pallas, interpret);
    the eval path's warp-layout heads, stage 3's through the lateral head
    (`lateral_conv2d_plain`), against featurenet_packed(out_layout="warp"),
    whose stage 3 is `_stage3_polyphase`, to 1e-5 of the largest value,
    image borders included;
  * CostRegNet, as modules and folded through K2's plain version (stride 1,
    stride 2, transposed), against CostRegNet(conv_impl='xla') and
    costreg_lanes (Pallas conv + resample kernels, interpret);
  * each K2/K3 mode and K5 shape singly against the Pallas layer.
Tolerance rtol = atol = 1e-4."""
from pathlib import Path

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.nn.costreg import CostRegNet as JCostRegNet
from rcmvsnet_tpu.nn.featurenet import FeatureNet as JFeatureNet
from rcmvsnet_tpu.nn.featurenet_fast import (featurenet_packed,
                                             pack_featurenet)
from rcmvsnet_tpu.ops.pallas_costreg import (conv_lanes, costreg_lanes,
                                             fold_costreg_variables,
                                             make_layout, to_lanes)
from rcmvsnet_tpu.ops.pallas_conv2d import (cm_from_nhwc, cm_to_nhwc,
                                            conv2d_cm, make_geo)
from rcmvsnet_tpu.ops.pallas_resample import stuff_lanes, subsample_lanes
from rcmvsnet_tpu_torch.nn.costreg import CostRegNet
from rcmvsnet_tpu_torch.nn.featurenet import FeatureNet
from rcmvsnet_tpu_torch.nn.layers import fold_bn
from rcmvsnet_tpu_torch.ops import conv2d as K5
from rcmvsnet_tpu_torch.ops import conv3d as K2
from rcmvsnet_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
GOLDEN = Path(__file__).resolve().parent / "golden" / "backbone_synth.msgpack"
T = torch.from_numpy


@pytest.fixture(scope="module")
def golden():
    blob = flax.serialization.msgpack_restore(GOLDEN.read_bytes())
    return blob["params"], blob["batch_stats"], state_dict_from_jax(
        blob["params"], blob["batch_stats"])


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_featurenet_matches_jax(golden):
    params, stats, sd = golden
    x = np.random.RandomState(7).randn(2, 32, 48, 3).astype(np.float32)
    variables = {"params": params["feature"], "batch_stats": stats["feature"]}
    want = JFeatureNet(8, 3).apply(variables, jnp.asarray(x), False)
    packed = featurenet_packed(
        pack_featurenet(params["feature"], stats["feature"],
                        dtype=jnp.float32), jnp.asarray(x), interpret=True)
    net = FeatureNet(8)
    net.load_state_dict(_sub(sd, "feature."), strict=True)
    net.eval()
    xt = T(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = net(xt)
        folded = net.forward_folded(xt)
    for k in ("stage1", "stage2", "stage3"):
        ref = np.asarray(want[k])
        for name, out in (("modules", got[k]), ("folded", folded[k])):
            np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                                       err_msg=f"{k} {name}", **TOL)
        np.testing.assert_allclose(folded[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(packed[k]), err_msg=k, **TOL)


def _from_warp(src2d, meta):
    """featurenet_packed's warp layout → [V, h, w, C]."""
    V, hm, row0, C, w_pad = meta
    got = np.asarray(src2d)
    return lambda h, w: np.stack([
        got[(v * hm + row0) * C:(v * hm + row0 + h) * C]
        .reshape(h, C, w_pad)[:, :, :w].transpose(0, 2, 1)
        for v in range(V)])


def test_featurenet_warp_layout_matches_jax(golden):
    """forward_folded(out_layout="warp") through the plain versions, stage
    3 as one lateral head, against the JAX eval path's warp layout
    (stage 3 by `_stage3_polyphase`) and against the modules."""
    params, stats, sd = golden
    x = np.random.RandomState(9).randn(2, 32, 48, 3).astype(np.float32)
    packed = featurenet_packed(
        pack_featurenet(params["feature"], stats["feature"],
                        dtype=jnp.float32), jnp.asarray(x), out_layout="warp",
        interpret=True)
    net = FeatureNet(8)
    net.load_state_dict(_sub(sd, "feature."), strict=True)
    net.eval()
    xt = T(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = net.forward_folded(xt, plain=True, out_layout="warp")
        mods = net(xt)
    for k, scale in (("stage1", 4), ("stage2", 2), ("stage3", 1)):
        h, w = 32 // scale, 48 // scale
        want = _from_warp(*packed[k])(h, w)
        out = got[k].numpy()
        assert out.shape == want.shape == (2, h, w, want.shape[-1])
        tol = 1e-5 * np.abs(want).max()
        assert np.abs(out - want).max() <= tol, k
        border = np.ones((h, w), bool)
        border[1:-1, 1:-1] = False
        assert np.abs(out - want)[:, border].max() <= tol, k
        np.testing.assert_allclose(
            out, mods[k].permute(0, 2, 3, 1).numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("stage,shape", [(1, (8, 8, 16)), (3, (8, 16, 8))])
def test_costregnet_matches_jax(golden, stage, shape):
    params, stats, sd = golden
    cp = params[f"stage{stage}"]["cost_reg"]
    cs = stats[f"stage{stage}"]["cost_reg"]
    C = cp["conv0"]["Conv_0"]["kernel"].shape[3]
    x = np.random.RandomState(stage).randn(1, *shape, C).astype(np.float32)
    want = JCostRegNet(8, conv_impl="xla").apply(
        {"params": cp, "batch_stats": cs}, jnp.asarray(x), False)[..., 0]
    lanes = costreg_lanes(jnp.asarray(x), fold_costreg_variables(cp, cs),
                          lane_tile=512, compute_dtype=jnp.float32,
                          interpret=True)
    net = CostRegNet(C, 8)
    net.load_state_dict(_sub(sd, f"cost_regularization.{stage - 1}."),
                        strict=True)
    net.eval()
    xt = T(x).permute(0, 4, 1, 2, 3).contiguous()
    with torch.no_grad():
        got = net(xt)[:, 0]
        folded = net.forward_folded(xt)[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(folded.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(folded.numpy(), np.asarray(lanes), **TOL)


def _from_lanes(y, lay, co):
    """[P, C', lanesp] lanes volume → [co, D, h, w]."""
    v = np.asarray(y)[1:-1, :co, lay.halo:lay.halo + lay.lanes0]
    v = v.reshape(v.shape[0], co, lay.hp, lay.wp)[:, :, 1:-1, 1:1 + lay.w]
    return np.transpose(v, (1, 0, 2, 3))


@pytest.mark.parametrize("mode", ["s1", "s2", "t2", "prob"])
def test_conv3d_modes_match_pallas_layers(golden, mode):
    """K2's plain version per mode against the TPU layer it replaces:
    conv_lanes (s1), conv_lanes(z_stride=2) + subsample_lanes (s2),
    stuff_lanes + conv_lanes with a skip after the ReLU (t2), and the f32
    prob head without ReLU."""
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
    rs = np.random.RandomState(11)
    x = rs.randn(d, h, w, ci).astype(np.float32)
    lay = make_layout(h, w, 512)
    xl = to_lanes(jnp.asarray(x), lay, -(-ci // 8) * 8, jnp.float32)
    kw = dict(compute_dtype=jnp.float32, interpret=True)
    skip = None
    if mode == "s2":
        lay2 = make_layout(h // 2, w // 2, 512)
        y = subsample_lanes(conv_lanes(xl, k_j, b_j, lay, z_stride=2, **kw),
                            lay, lay2, interpret=True)
        want = _from_lanes(y, lay2, co)
    elif mode == "t2":
        lay2 = make_layout(2 * h, 2 * w, 512)
        skip = rs.randn(2 * d, 2 * h, 2 * w, co).astype(np.float32)
        y = conv_lanes(stuff_lanes(xl, lay, lay2, interpret=True), k_j, b_j,
                       lay2, skip=to_lanes(jnp.asarray(skip), lay2,
                                           -(-co // 8) * 8, jnp.float32),
                       **kw)
        want = _from_lanes(y, lay2, co)
    else:
        y = conv_lanes(xl, k_j, b_j, lay, relu=mode != "prob",
                       out_dtype=jnp.float32, **kw)
        want = _from_lanes(y, lay, co)

    blk = f"cost_regularization.1.{name}"
    if mode == "prob":
        wt, bt = sd[f"{blk}.weight"], torch.zeros(1)
    else:
        wt, bt = fold_bn(sd[f"{blk}.conv.weight"], sd[f"{blk}.bn.weight"],
                         sd[f"{blk}.bn.bias"], sd[f"{blk}.bn.running_mean"],
                         sd[f"{blk}.bn.running_var"],
                         out_dim=1 if mode == "t2" else 0)
    xt = T(x).permute(3, 0, 1, 2)[None].contiguous()
    sk = (T(skip).permute(3, 0, 1, 2)[None].contiguous()
          if skip is not None else None)
    got = K2.conv3d_plain(xt, wt, bt, "s1" if mode == "prob" else mode,
                          relu=mode != "prob", skip=sk)
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)


@pytest.mark.parametrize("k,stride,ci,co", [(3, 1, 3, 8), (5, 2, 8, 16),
                                            (1, 1, 16, 32), (3, 1, 32, 8)])
def test_conv2d_matches_pallas_layer(k, stride, ci, co):
    """K5's plain version against conv2d_cm (BN scale/shift + ReLU)."""
    rs = np.random.RandomState(k * 10 + stride)
    x = rs.randn(2, 16, 24, ci).astype(np.float32)
    kern = (rs.randn(k, k, ci, co) * 0.2).astype(np.float32)
    scale = (0.5 + rs.rand(co)).astype(np.float32)
    shift = rs.randn(co).astype(np.float32)
    geo = make_geo(2, 16, 24, margin=4)
    flat, g2 = conv2d_cm(cm_from_nhwc(jnp.asarray(x), geo), geo,
                         jnp.asarray(kern), stride=stride, padding=k // 2,
                         scale=jnp.asarray(scale), shift=jnp.asarray(shift),
                         relu=True, interpret=True)
    want = np.asarray(cm_to_nhwc(flat, g2))
    got = K5.conv2d_plain(T(x).permute(0, 3, 1, 2),
                          T(kern).permute(3, 2, 0, 1), T(scale), T(shift),
                          stride=stride, padding=k // 2, relu=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_conv2d_upsample_add_matches_jax():
    """The fused `up(intra) + inner(conv)` epilogue against the JAX
    FeatureNet's resize_nearest + 1×1 conv with bias."""
    from rcmvsnet_tpu.ops.sampling import resize_nearest
    rs = np.random.RandomState(5)
    conv = rs.randn(2, 8, 12, 16).astype(np.float32)
    intra = rs.randn(2, 4, 6, 32).astype(np.float32)
    w = rs.randn(16, 32).astype(np.float32)
    b = rs.randn(32).astype(np.float32)
    want = (np.asarray(resize_nearest(jnp.asarray(intra), 8, 12))
            + conv @ w + b)
    got = K5.conv2d_plain(T(conv).permute(0, 3, 1, 2),
                          T(w.T.copy())[:, :, None, None], shift=T(b),
                          up=T(intra).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
