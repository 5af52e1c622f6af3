"""Ops of the PyTorch port against the JAX package, on the CPU.

Geometry, samplers, the warp + variance (K1's plain version, against the
XLA warp and against the Pallas kernel in interpret mode) and the depth tail
(K4's plain version, against the fused Pallas tail in interpret mode and the
unfused cascade tail). Inputs come from numpy with a fixed seed; both sides
get the same arrays. Tolerance rtol = atol = 1e-5 (K1: 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.core import geometry as jgeo
from rcmvsnet_tpu.data.synthetic import make_synthetic_views
from rcmvsnet_tpu.models.cascade import (depth_regression,
                                         photometric_confidence)
from rcmvsnet_tpu.ops import sampling as jsamp
from rcmvsnet_tpu.ops import warp as jwarp
from rcmvsnet_tpu.ops.pallas_costreg import make_layout
from rcmvsnet_tpu.ops.pallas_tail import fused_depth_tail
from rcmvsnet_tpu.ops.pallas_warp2 import (check_group_coverage,
                                           plane_sweep_variance_lanes)
from rcmvsnet_tpu_torch.core import geometry as tgeo
from rcmvsnet_tpu_torch.ops import conv3d as K2
from rcmvsnet_tpu_torch.ops import depth_tail as K4
from rcmvsnet_tpu_torch.ops import sampling as tsamp
from rcmvsnet_tpu_torch.ops import warp as twarp
from rcmvsnet_tpu_torch.ops import warp_variance as K1

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy


def _scene(H=16, W=24, V=4, D=8, C=8, seed=3):
    """Synthetic plane views → (features [V,H,W,C], projs [V,4,4], pairs
    [1,V,2,4,4], depth range) as numpy."""
    s = make_synthetic_views(H=H, W=W, V=V, depth0=600.0, seed=seed,
                             baseline=4.0)
    rs = np.random.RandomState(seed)
    feats = rs.randn(V, H, W, C).astype(np.float32)
    pairs = np.zeros((1, V, 2, 4, 4), np.float32)
    for v in range(V):
        pairs[0, v, 0] = s["extrinsics"][v]
        pairs[0, v, 1, :3, :3] = s["intrinsics"]
    projs = np.array(jgeo.compose_projection(jnp.asarray(pairs)))[0]
    return feats, projs, pairs, (s["depth_min"], s["depth_max"])


def test_geometry_matches_jax():
    _, projs, pairs, (dmin, dmax) = _scene()
    np.testing.assert_allclose(
        tgeo.compose_projection(T(pairs)).numpy(),
        np.asarray(jgeo.compose_projection(jnp.asarray(pairs))), **TOL)
    rel_t = tgeo.relative_projection(T(projs[1:]), T(projs[:1]))
    rel_j = jgeo.relative_projection(jnp.asarray(projs[1:]),
                                     jnp.asarray(projs[:1]))
    np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tgeo.pixel_grid(5, 7).numpy(),
                                  np.asarray(jgeo.pixel_grid(5, 7)))
    rs = np.random.RandomState(0)
    dv = (dmin + (dmax - dmin) * rs.rand(3, 6, 5, 7)).astype(np.float32)
    proj = np.array(rel_j)
    proj[2, 2, 3] = -proj[2, 2, 2] * dv[2, 0, 0, 0]   # drive z to ~0
    xt, yt = tgeo.project_to_grid(T(proj), T(dv), 5, 7)
    xj, yj = jgeo.project_to_grid(jnp.asarray(proj), jnp.asarray(dv), 5, 7)
    for a, b in ((xt, xj), (yt, yj)):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)


def test_grid_sample_matches_jax():
    rs = np.random.RandomState(1)
    img = rs.randn(2, 9, 13, 5).astype(np.float32)
    # coordinates beyond [-1, 1] exercise the per-tap zero padding
    x = rs.uniform(-1.3, 1.3, (2, 4, 17)).astype(np.float32)
    y = rs.uniform(-1.3, 1.3, (2, 4, 17)).astype(np.float32)
    got = tsamp.grid_sample_2d(T(img), T(x), T(y))
    want = jsamp.grid_sample_2d(jnp.asarray(img), jnp.asarray(x),
                                jnp.asarray(y), padding_mode="zeros")
    assert got.shape == (2, 4, 17, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("size,align", [((18, 30), False), ((5, 7), False),
                                        ((18, 30), True), ((5, 8), True)])
def test_resize_bilinear_matches_jax(size, align):
    x = np.random.RandomState(2).randn(2, 9, 15, 3).astype(np.float32)
    got = tsamp.resize_bilinear(T(x), *size, align_corners=align)
    want = jsamp.resize_bilinear(jnp.asarray(x), *size, align_corners=align)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [(18, 30), (4, 5), (27, 15)])
def test_resize_nearest_matches_jax(size):
    x = np.random.RandomState(3).randn(1, 9, 15, 2).astype(np.float32)
    got = tsamp.resize_nearest(T(x), *size)
    want = jsamp.resize_nearest(jnp.asarray(x), *size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_homo_warp_and_variance_match_jax():
    feats, projs, _, (dmin, dmax) = _scene()
    D = 8
    dv = np.linspace(dmin, dmax, D, dtype=np.float32)[None]
    w_t = twarp.homo_warp(T(feats[1:2]), T(projs[1:2]), T(projs[:1]), T(dv))
    w_j = jwarp.homo_warp(jnp.asarray(feats[1:2]), jnp.asarray(projs[1:2]),
                          jnp.asarray(projs[:1]), jnp.asarray(dv))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j),
                               rtol=1e-4, atol=1e-4)
    V = feats.shape[0]
    v_t = twarp.plane_sweep_variance(
        T(feats[:1]), [T(feats[v:v + 1]) for v in range(1, V)],
        [T(projs[v:v + 1]) for v in range(1, V)], T(projs[:1]), T(dv))
    v_j, _ = jwarp.plane_sweep_variance(
        jnp.asarray(feats[:1]), [jnp.asarray(feats[v:v + 1])
                                 for v in range(1, V)],
        [jnp.asarray(projs[v:v + 1]) for v in range(1, V)],
        jnp.asarray(projs[:1]), jnp.asarray(dv))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j),
                               rtol=1e-4, atol=1e-4)


def _planes(H, W, D, dmin, dmax, seed=0):
    """Per-pixel (lo, step): a noisy window like a later cascade stage."""
    rs = np.random.RandomState(seed)
    cur = (0.5 * (dmin + dmax)
           + 0.05 * (dmax - dmin) * rs.randn(H, W)).astype(np.float32)
    half = np.float32(0.25 * (dmax - dmin))
    lo = (cur - half).astype(np.float32)
    step = ((cur + half - lo) / (D - 1)).astype(np.float32)
    return lo, step


def test_warp_variance_plain_matches_xla_warp():
    feats, projs, _, (dmin, dmax) = _scene()
    V, H, W, C = feats.shape
    D = 8
    lo, step = _planes(H, W, D, dmin, dmax)
    got = K1.warp_variance_plain(T(feats), T(projs), T(lo), T(step), D)
    dv = lo[None] + np.arange(D, dtype=np.float32)[:, None, None] * step[None]
    want, _ = jwarp.plane_sweep_variance(
        jnp.asarray(feats[:1]), [jnp.asarray(feats[v:v + 1])
                                 for v in range(1, V)],
        [jnp.asarray(projs[v:v + 1]) for v in range(1, V)],
        jnp.asarray(projs[:1]), jnp.asarray(dv[None]))
    assert got.shape == (C, D, H, W)
    np.testing.assert_allclose(
        got.numpy(), np.transpose(np.asarray(want)[0], (3, 0, 1, 2)),
        rtol=1e-4, atol=1e-4)


def test_warp_variance_plain_matches_pallas_planes_kernel():
    """K1's plain version against plane_sweep_variance_lanes in planes
    mode (the TPU kernel the CUDA kernel replaces), interpret mode."""
    feats, projs, pairs, (dmin, dmax) = _scene()
    V, H, W, C = feats.shape
    D = 8
    lo = np.full((H, W), dmin, np.float32)
    step = np.full((H, W), (dmax - dmin) / (D - 1), np.float32)
    dv = lo[None] + np.arange(D, dtype=np.float32)[:, None, None] * step[None]
    assert check_group_coverage(pairs, dv[None], H, W, 4, 8)
    lay = make_layout(H, W, 512)
    vol, viol = plane_sweep_variance_lanes(
        jnp.asarray(feats), jnp.asarray(projs), None, lay, rows_per_step=4,
        band=8, depth_planes=(jnp.asarray(lo), jnp.asarray(step), D),
        compute_dtype=jnp.float32, out_dtype=jnp.float32, interpret=True)
    assert int(viol) == 0
    v = np.asarray(vol)[1:-1, :C, lay.halo:lay.halo + lay.lanes0]
    want = v.reshape(D, C, lay.hp, lay.wp)[:, :, 1:-1, 1:1 + W]
    got = K1.warp_variance_plain(T(feats), T(projs), T(lo), T(step), D)
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (1, 0, 2, 3)),
                               rtol=1e-4, atol=1e-4)


def _tail_inputs(D, H, W, seed):
    rs = np.random.RandomState(seed)
    cost = (rs.randn(D, H, W) * 3).astype(np.float32)
    lo = (425.0 + rs.rand(H, W) * 10).astype(np.float32)
    step = (2.5 + rs.rand(H, W)).astype(np.float32)
    return cost, lo, step


@pytest.mark.parametrize("D,H,W", [(48, 8, 16), (32, 6, 20), (8, 12, 12)])
def test_depth_tail_plain_matches_pallas_and_unfused(D, H, W):
    cost, lo, step = _tail_inputs(D, H, W, seed=D)
    depth, conf = K4.depth_tail_plain(T(cost), T(lo), T(step))
    fd, fc = fused_depth_tail(jnp.asarray(cost[None]),
                              (jnp.asarray(lo[None]), jnp.asarray(step[None])),
                              interpret=True)
    np.testing.assert_allclose(depth.numpy(), np.asarray(fd)[0], **TOL)
    np.testing.assert_allclose(conf.numpy(), np.asarray(fc)[0], **TOL)
    dv = lo[None] + np.arange(D, dtype=np.float32)[:, None, None] * step[None]
    prob = jax.nn.softmax(jnp.asarray(cost[None]), axis=1)
    np.testing.assert_allclose(
        depth.numpy(), np.asarray(depth_regression(prob, jnp.asarray(
            dv[None])))[0], **TOL)
    np.testing.assert_allclose(
        conf.numpy(), np.asarray(photometric_confidence(prob))[0], **TOL)


def test_depth_tail_confidence_at_window_edges():
    """Peaks at the first and last plane push the index to the clamp
    edges; the window must see zeros outside [0, D)."""
    D, H, W = 8, 1, 16
    cost = np.full((D, H, W), -10.0, np.float32)
    cost[0, :, :8] = 10.0
    cost[-1, :, 8:] = 10.0
    lo = np.ones((H, W), np.float32)
    step = np.full((H, W), 1.0 / 7, np.float32)
    _, conf = K4.depth_tail_plain(T(cost), T(lo), T(step))
    prob = jax.nn.softmax(jnp.asarray(cost[None]), axis=1)
    np.testing.assert_allclose(
        conf.numpy(), np.asarray(photometric_confidence(prob))[0], **TOL)


def test_wrappers_take_plain_version_on_cpu_only():
    """On a CPU tensor a wrapper returns its plain version and launches
    nothing; on a tensor of another device it raises instead of falling
    back."""
    feats, projs, _, (dmin, dmax) = _scene(V=3)
    H, W = feats.shape[1:3]
    lo, step = _planes(H, W, 8, dmin, dmax)
    n0 = K1.warp_variance.launches
    got = K1.warp_variance(T(feats), T(projs), T(lo), T(step), 8)
    want = K1.warp_variance_plain(T(feats), T(projs), T(lo), T(step), 8)
    assert torch.equal(got, want) and K1.warp_variance.launches == n0
    x = torch.zeros(1, 8, 4, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K2.conv3d(x, torch.zeros(8, 8, 3, 3, 3, device="meta"),
                  torch.zeros(8, device="meta"))
