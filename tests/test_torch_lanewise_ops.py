"""K9 and K10's plain versions against the JAX package on the CPU.

  * K9: `ops/conv3d.conv3d_lanewise_plain` against `conv3d_lanewise`
    (interpret mode), the JAX DHWIO kernel brought to the port's layout by
    `weights.unconv` / `undeconv`, at the shapes of
    tests/test_pallas_conv3d.py (odd sizes included); error ≤ 1e-5 of the
    largest value.
  * K10: `pixel_coords` against `_pixel_coords` (≤ 1e-5 of the largest
    coordinate); `warp_view_plain` against `warp_volume_pallas`
    (interpret mode, float32, band 16) on the scene of
    tests/test_pallas_warp.py, atol 2e-4 (that test's own); and
    `plane_sweep_variance_views` against `plane_sweep_variance_fast`
    (float32), atol 1e-4 (float32 coordinates computed in another order
    move a sample by an ulp of its pixel position)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rcmvsnet_tpu.core.geometry import compose_projection, relative_projection
from rcmvsnet_tpu.data.synthetic import make_synthetic_batch
from rcmvsnet_tpu.ops import pallas_warp
from rcmvsnet_tpu.ops.pallas_conv3d import conv3d_lanewise
from rcmvsnet_tpu_torch.ops import conv3d as K9
from rcmvsnet_tpu_torch.ops import warp_view as K10
from rcmvsnet_tpu_torch.weights import unconv, undeconv

torch.set_num_threads(2)


def _conv_case(ci, co, shape, mode, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape, ci).astype(np.float32)
    k = (rs.randn(3, 3, 3, ci, co) * 0.1).astype(np.float32)
    want = np.asarray(conv3d_lanewise(
        jnp.asarray(x), jnp.asarray(k),
        strides=(2, 2, 2) if mode == "s2" else (1, 1, 1),
        transposed=mode == "t2", interpret=True, lane_tile=256))
    wgt = undeconv(k) if mode == "t2" else unconv(k)
    got = K9.conv3d_lanewise(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 0)))[None],
        torch.from_numpy(wgt), mode)[0].permute(1, 2, 3, 0).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("ci,co,shape", [
    (32, 8, (6, 10, 12)), (16, 16, (4, 9, 11)), (8, 1, (5, 8, 8))])
def test_conv3d_lanewise_s1_matches_jax(ci, co, shape):
    _conv_case(ci, co, shape, "s1", 0)


@pytest.mark.parametrize("shape", [(6, 10, 12), (5, 9, 7)])
def test_conv3d_lanewise_s2_matches_jax(shape):
    _conv_case(8, 16, shape, "s2", 1)


def test_conv3d_lanewise_t2_matches_jax():
    _conv_case(16, 8, (3, 5, 6), "t2", 2)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_warp.pl, "pallas_call", interp)


def _scene(H=64, W=64, D=8, C=16, V=3, seed=0):
    """tests/test_pallas_warp.py's scene: stage-1 projections of the
    synthetic rig, random features, 8 planes from 480 to 750."""
    rs = np.random.RandomState(seed)
    batch = make_synthetic_batch(B=1, V=V, H=H, W=W, ndepth=192, seed=seed)
    projs = compose_projection(jnp.asarray(batch["proj_matrices"]["stage1"]))
    h, w = H // 4, W // 4
    feats = rs.randn(1, V, h, w, C).astype(np.float32)
    dv = np.broadcast_to(np.linspace(480.0, 750.0, D, dtype=np.float32)
                         [None, :, None, None], (1, D, h, w)).copy()
    assert pallas_warp.check_band_coverage(
        batch["proj_matrices"]["stage1"], jnp.asarray(dv), h, w, band=16)
    return feats, projs, dv, h, w


def test_pixel_coords_matches_jax():
    _, projs, dv, h, w = _scene()
    for v in (1, 2):
        proj = relative_projection(projs[:, v], projs[:, 0])
        want = pallas_warp._pixel_coords(proj, jnp.asarray(dv), h, w)
        got = K10.pixel_coords(torch.from_numpy(np.array(proj)),
                               torch.from_numpy(dv), h, w)
        for g, t in zip(got, want):
            t = np.asarray(t)
            assert np.abs(g.numpy() - t).max() <= 1e-5 * np.abs(t).max()


def test_warp_view_plain_matches_warp_volume_pallas(interpret_pallas):
    feats, projs, dv, h, w = _scene()
    proj = relative_projection(projs[:, 1], projs[:, 0])
    px, py = pallas_warp._pixel_coords(proj, jnp.asarray(dv), h, w)
    want = jax.vmap(partial(pallas_warp.warp_volume_pallas, band=16,
                            compute_dtype=jnp.float32))(
        jnp.asarray(feats[:, 1]), px, py)
    want = np.moveaxis(np.asarray(want), 3, 4)[0]    # [D,h,C,W] -> [D,h,W,C]
    got = K10.warp_view(torch.from_numpy(feats[0, 1]),
                        torch.from_numpy(np.array(px[0])),
                        torch.from_numpy(np.array(py[0])))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_plane_sweep_variance_views_matches_jax(interpret_pallas):
    feats, projs, dv, h, w = _scene(seed=3)
    want = pallas_warp.plane_sweep_variance_fast(
        jnp.asarray(feats[:, 0]), [jnp.asarray(feats[:, i]) for i in (1, 2)],
        [projs[:, i] for i in (1, 2)], projs[:, 0], jnp.asarray(dv),
        band=16, compute_dtype=jnp.float32)
    tp = torch.from_numpy(np.asarray(projs))
    got = K10.plane_sweep_variance_views(
        torch.from_numpy(feats[:, 0]),
        [torch.from_numpy(feats[:, i]) for i in (1, 2)],
        [tp[:, i] for i in (1, 2)], tp[:, 0], torch.from_numpy(dv))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
