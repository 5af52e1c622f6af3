"""K1's lane layout (`ops/csrc/warp_variance.cu`, forward, on the block
skeleton of `ops/csrc/warp_fwd.cuh`), checked on the CPU.

CUDA cannot run here, so these tests hold the kernel's mapping of lanes,
pixels and planes in plain numpy against the plain versions:
  * `plan` (the kernel's grid, as its entry computes it: P pixels a
    block, a chunk of DC planes a block walks) and the block's write
    loop put every element of the [C, D, h, w] output in exactly one
    place, at the DTU, T&T and train
    shapes and at odd sizes (h·w not a multiple of P, D not a multiple
    of DC); the shared-memory staging of a plane's P × C results is
    one-to-one and conflict-free on the banks for the lanes' writes;
  * the projection split into rot · [x, y, 1] once per pixel and
    · dv + t per plane (`warp::rot_row`, `warp::depth_row`) gives
    `warp_view.pixel_coords` bit for bit, which the K10 route's 1e-5
    gate rests on;
  * an emulation of the kernel block by block (lane q of a pixel's group
    of C/4 lanes owns channels 4q..4q+3 and projects views q, q + C/4,
    ...; each view's taps come from its owner lane, as the shuffles pass
    them; pixels past
    the image compute the last one and write nothing; the planes of each
    chunk in order) equals the K10 route's plain variance (the kernel's
    coordinates sampled in float64) to 1e-5 of the largest value, and
    `warp_variance_plain` to 1e-4, with a chunk that does not divide D.
"""
import numpy as np
import pytest
import torch

from rcmvsnet_tpu_torch.ops import warp_variance as K1
from rcmvsnet_tpu_torch.ops.warp_view import (pixel_coords,
                                              plane_sweep_variance_views)

torch.set_num_threads(2)
f32 = np.float32
THREADS = 256                   # the kernel's block (kFwdThreads)
TARGET_BLOCKS = 8 * 132         # kTargetBlocks: 8 blocks per SM of an H100

# (h, w, C, D) of K1's calls: DTU eval (864x1152), T&T (1056x1920), train
# (512x640), and odd sizes
EVAL = ((216, 288, 32, 48), (432, 576, 16, 32), (864, 1152, 8, 8))
TANKS = ((264, 480, 32, 48), (528, 960, 16, 32), (1056, 1920, 8, 8))
TRAIN = ((128, 160, 32, 48), (256, 320, 16, 32), (512, 640, 8, 8))
ODD = ((81, 95, 32, 48), (9, 7, 8, 5), (5, 7, 16, 3), (24, 40, 16, 32))


def plan(h, w, C, D):
    """warp_fwd.cuh's `fwd_plan`: (P pixels a block, pixel blocks, DC
    planes a block walks, plane chunks). A block walks all D planes when
    the pixel blocks alone reach TARGET_BLOCKS; otherwise the planes are
    cut into chunks until they do (at least one plane a chunk)."""
    P = THREADS // (C // 4)
    nx = -(-(h * w) // P)
    nz = min(D, max(1, -(-TARGET_BLOCKS // nx)))
    dc = -(-D // nz)
    return P, nx, dc, -(-D // dc)


def _stage_stride(C):
    """The staging row stride PS = P + 8 / L of the kernel, L = C / 4."""
    L = C // 4
    return THREADS // L + 8 // L


@pytest.mark.parametrize("shape", EVAL + TANKS + TRAIN + ODD)
def test_plan_writes_every_element_once(shape):
    """The write index (c, d, pixel) is the product of three maps: the
    block's write loop i -> (c, jj) over C·P, the blocks' pixels bx·P +
    jj (masked to h·w), and the chunks' planes bz·DC + dd (masked to D);
    each map hits its range exactly once, so the product does."""
    h, w, C, D = shape
    HW = h * w
    P, nx, dc, nz = plan(h, w, C, D)
    assert P == THREADS // (C // 4) and 1 <= dc <= D
    assert (nx - 1) * P < HW <= nx * P and (nz - 1) * dc < D <= nz * dc
    # the write loop of one block over its threads
    i = np.concatenate([np.arange(t, C * P, THREADS) for t in range(THREADS)])
    assert np.array_equal(np.sort(i), np.arange(C * P))
    c, jj = i // P, i % P
    assert np.array_equal(np.bincount(c * P + jj, minlength=C * P),
                          np.ones(C * P))
    pix = (np.arange(nx)[:, None] * P + np.arange(P)[None]).ravel()
    pix = pix[pix < HW]
    assert np.array_equal(np.bincount(pix, minlength=HW), np.ones(HW))
    d = (np.arange(nz)[:, None] * dc + np.arange(dc)[None]).ravel()
    d = d[d < D]
    assert np.array_equal(np.bincount(d, minlength=D), np.ones(D))


def test_plan_cuts_planes_only_where_the_pixels_do_not_fill_the_card():
    for h, w, C, D in EVAL + TANKS:
        assert plan(h, w, C, D)[2] == D
    assert plan(128, 160, 32, 48)[2:] == (24, 2)
    assert plan(81, 95, 32, 48)[2:] == (10, 5)       # 48 = 4·10 + 8


@pytest.mark.parametrize("C", K1.CHANNELS)
def test_staging_is_one_to_one_and_conflict_free(C):
    """Lane (j, q) writes channels 4q + k of pixel j to (4q + k)·PS + j:
    one-to-one over (c, j), and for each k the 32 lanes of a warp hit 32
    distinct banks; the write loop reads c·PS + jj, consecutive jj on
    consecutive banks."""
    L, PS = C // 4, _stage_stride(C)
    P = THREADS // L
    tid = np.arange(THREADS)
    j, q = tid // L, tid % L
    addr = np.stack([(4 * q + k) * PS + j for k in range(4)])  # [4, 256]
    assert len(np.unique(addr)) == C * P
    assert addr.max() < C * PS
    for row in addr:
        for wp in range(THREADS // 32):
            banks = row[32 * wp:32 * wp + 32] % 32
            assert len(np.unique(banks)) == 32


# ------------------------------------------------- projection and values

def _inputs(V, h, w, C, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((V, h, w, C)).astype(f32)
    f = 1.2 * max(h, w)
    projs = np.zeros((V, 4, 4), f32)
    for v in range(V):
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
        E = np.eye(4)
        E[0, 3], E[1, 3] = -4.0 * v, 1.5 * (v % 2)
        projs[v, :3] = K @ E[:3]
        projs[v, 3] = E[3]
    lo = (560 + 10 * rng.random((h, w))).astype(f32)
    step = (3.0 + rng.random((h, w))).astype(f32)
    return feats, projs, lo, step


def _rot_row(m, fx, fy):
    return f32(f32(m[..., 0] * fx) + f32(m[..., 1] * fy)) + m[..., 2]


def _depth_row(rr, t, dv):
    return f32(rr * dv) + t


def _coords(rows, h, w):
    """taps_of_rows up to the clipped pixel coordinates."""
    X, Y, Z = rows
    Z = np.where(np.abs(Z) < f32(1e-6),
                 np.where(Z < 0, f32(-1e-6), f32(1e-6)), Z).astype(f32)
    return (np.clip(X / Z, f32(-2), f32(w + 1)).astype(f32),
            np.clip(Y / Z, f32(-2), f32(h + 1)).astype(f32))


def test_split_projection_equals_pixel_coords_bit_for_bit():
    V, h, w, C, D = 5, 13, 21, 8, 6
    _, projs, lo, step = _inputs(V, h, w, C, 3)
    rel = K1.relative_projections(torch.from_numpy(projs)).reshape(
        V, 4, 4).numpy()
    ys, xs = np.meshgrid(np.arange(h, dtype=f32), np.arange(w, dtype=f32),
                         indexing="ij")
    dv = np.stack([lo + f32(d) * step for d in range(D)]).astype(f32)
    for v in range(1, V):
        rr = [_rot_row(rel[v, r], xs, ys) for r in range(3)]   # per pixel
        px, py = _coords([_depth_row(rr[r][None], rel[v, r, 3], dv)
                          for r in range(3)], h, w)
        want = pixel_coords(torch.from_numpy(rel[v:v + 1]),
                            torch.from_numpy(dv[None]), h, w)
        assert np.array_equal(px, want[0][0].numpy())
        assert np.array_equal(py, want[1][0].numpy())


def _sample_quad(src, x0, y0, wx, wy, chans, h, w):
    """warp::sample_quad over the lanes' channels `chans` [lanes, 4]:
    taps 0..3, one fma each, zero outside."""
    val = np.zeros(chans.shape, f32)
    for k in range(4):
        xi, yi = x0 + (k & 1), y0 + (k >> 1)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        wgt = (f32(wx if k & 1 else f32(1) - wx)
               * f32(wy if k >> 1 else f32(1) - wy)).astype(f32)
        p = np.where(ok, yi * w + xi, 0)
        s = src[p[:, None], chans]
        fma = (wgt[:, None].astype(np.float64) * s + val).astype(f32)
        val = np.where(ok[:, None], fma, val)
    return val


def emulate_k1(feats, rel, lo, step, D, dc=None):
    """warp_variance_kernel block by block over its 256 threads; returns
    [C, D, h, w]. dc: the plane chunk (default: `plan`'s)."""
    V, h, w, C = feats.shape
    HW, nv, L = h * w, V - 1, C // 4
    P, nx, dc0, _ = plan(h, w, C, D)
    dc = dc or dc0
    PS = _stage_stride(C)
    S = -(-nv // L)                             # views a lane projects
    src = feats.reshape(V, HW, C)
    lo, step = lo.reshape(-1), step.reshape(-1)
    out = np.full((C, D, HW), np.nan, f32)
    tid = np.arange(THREADS)
    j, q = tid // L, tid % L
    chans = 4 * q[:, None] + np.arange(4)[None]               # [256, 4]
    inv_v = f32(1) / f32(V)
    for bx in range(nx):
        p0 = bx * P
        pix = np.minimum(p0 + j, HW - 1)
        y = pix // w
        fx, fy = (pix - y * w).astype(f32), y.astype(f32)
        ref = src[0][pix[:, None], chans]
        ref_sq = (ref * ref).astype(f32)
        views = [s * L + q for s in range(S)]
        mats = [rel[np.where(v < nv, v + 1, 0)] for v in views]
        rr = [[_rot_row(m[:, r], fx, fy) for r in range(3)] for m in mats]
        for d0 in range(0, D, dc):
            for d in range(d0, min(D, d0 + dc)):
                dv = (lo[pix] + f32(f32(d) * step[pix])).astype(f32)
                mine = []
                for s in range(S):
                    px, py = _coords([_depth_row(rr[s][r], mats[s][:, r, 3],
                                                 dv) for r in range(3)], h, w)
                    x0f, y0f = np.floor(px), np.floor(py)
                    mine.append((x0f.astype(int), y0f.astype(int),
                                 (px - x0f).astype(f32),
                                 (py - y0f).astype(f32)))
                sm, sq = ref.copy(), ref_sq.copy()
                for v in range(nv):
                    owner = j * L + v % L          # the shuffle's source lane
                    taps = [a[owner] for a in mine[v // L]]
                    val = _sample_quad(src[v + 1], *taps, chans, h, w)
                    sm = (sm + val).astype(f32)
                    sq = (sq + (val * val).astype(f32)).astype(f32)
                mean = (sm * inv_v).astype(f32)
                var = ((sq * inv_v).astype(f32) - (mean * mean).astype(f32))
                so = np.full(C * PS, np.nan, f32)
                for k in range(4):
                    so[chans[:, k] * PS + j] = var[:, k]
                i = np.arange(C * P)
                c, jj = i // P, i % P
                keep = p0 + jj < HW
                assert np.isnan(out[c[keep], d, p0 + jj[keep]]).all()
                out[c[keep], d, p0 + jj[keep]] = so[c * PS + jj][keep]
    return out.reshape(C, D, h, w)


@pytest.mark.parametrize("V,h,w,C,D,dc", [
    (5, 9, 7, 8, 5, 2), (4, 11, 13, 16, 7, 3), (5, 6, 10, 32, 8, 3),
    (3, 5, 7, 32, 4, None), (10, 6, 7, 8, 3, 2), (9, 5, 9, 16, 4, None)])
def test_kernel_emulation_matches_plain(V, h, w, C, D, dc):
    """Including 8 and 9 source views: more views than lanes at C = 8
    and 16, so a lane projects two or three of them."""
    feats, projs, lo, step = _inputs(V, h, w, C, h * w + C)
    T = torch.from_numpy
    rel = K1.relative_projections(T(projs)).reshape(V, 4, 4).numpy()
    got = emulate_k1(feats, rel, lo, step, D, dc)
    assert not np.isnan(got).any()
    dv = T(np.stack([lo + f32(d) * step for d in range(D)]).astype(f32))
    f = T(feats)
    route = plane_sweep_variance_views(
        f[:1], [f[v:v + 1] for v in range(1, V)],
        [T(projs[v:v + 1]) for v in range(1, V)], T(projs[:1]),
        dv[None])[0].permute(3, 0, 1, 2).numpy()
    scale = np.abs(route).max()
    assert np.abs(got - route).max() <= 1e-5 * scale
    plain = K1.warp_variance_plain(f, T(projs), T(lo), T(step), D).numpy()
    assert np.abs(got - plain).max() <= 1e-4 * scale
