"""K10's block plan (`ops/csrc/warp_view.cu`), checked on the CPU.

CUDA cannot run here, so these tests hold the kernel's mapping of blocks,
warps, lanes and samples in plain numpy against the plain version:
  * the lane kernel (C = 4, 8, 16, 32: L = C / 4 lanes a sample, one
    float4 of channels a lane) writes every element of the [D, h, w, C]
    output exactly once: block (bx, d, bz) covers WARPS rows of plane d,
    warp w row bz·WARPS + w and the chunk of NW = P·32/L samples from
    x = bx·NW, cut at the row's end; lane (g, q) writes channels
    4q..4q+3 of the chunk's samples p·32/L + g; the scalar kernel (any
    other C) one element a thread. At the DTU and T&T stage shapes and at
    odd sizes (w not a multiple of a chunk, h not a multiple of a block's
    rows, D = 1, C = 3 and 12);
  * an emulation of the kernel warp by warp (each sample's tap plan
    staged once: tap 0's offset, the landing mask and the four weights;
    every lane's gathers read through the plan of the sample it owns,
    pass p + 1's taps loaded into the other ring slot before pass p is
    summed) equals the per-sample rule (taps 0..3, one fused multiply-add
    each, zero outside) in every bit, and `warp_view_plain` within 1e-5
    of the largest value, for coordinates at −2, w+1 and h+1 and whole
    rows out of the image.
"""
import numpy as np
import pytest
import torch

from rcmvsnet_tpu_torch.ops.warp_view import warp_view_plain

f32 = np.float32
THREADS = 256                   # kThreads
WARPS = THREADS // 32           # kWarps
PASSES = 8                      # kPasses: passes of a warp's chunk
LANE_C = (4, 8, 16, 32)         # the C the lane kernel is built for

# (h, w, C, D) of K10's calls: DTU eval (864x1152), T&T (1056x1920), odd
DTU = ((216, 288, 32, 48), (432, 576, 16, 32), (864, 1152, 8, 8))
TANKS = ((264, 480, 32, 48), (528, 960, 16, 32), (1056, 1920, 8, 8))
ODD = ((17, 33, 8, 3), (9, 7, 32, 1), (5, 7, 3, 2), (13, 29, 4, 5),
       (11, 37, 16, 1), (7, 9, 12, 2))


def plan(C, h, w, D):
    """The entry's launch: (L lanes a sample, NW samples a warp, grid) for
    the lane kernel, grid (x tiles, D, row groups): the planes of a row
    group's tile run as consecutive blocks; or (None, None, blocks) for
    the scalar one."""
    if C in LANE_C:
        L = C // 4
        NW = PASSES * (32 // L)
        return L, NW, (-(-w // NW), D, -(-h // WARPS))
    return None, None, -(-(D * h * w * C) // THREADS)


def warps(h, w, NW, grid):
    """Every live warp of the lane kernel's grid as (first sample, count):
    block (bx, d, bz), warp wid takes row bz·WARPS + wid of plane d and
    the x chunk from bx·NW, cut at the row's end; a warp past the last
    row returns at once."""
    gx, D, gz = grid
    bx, d, by, wid = np.meshgrid(np.arange(gx), np.arange(D), np.arange(gz),
                                 np.arange(WARPS), indexing="ij")
    row = by * WARPS + wid
    xs = bx * NW
    live = (row < h) & (xs < w)
    row, xs, d = row[live], xs[live], d[live]
    first = (d.astype(np.int64) * h + row) * w + xs
    return first, np.minimum(NW, w - xs)


def lane_map(L):
    """(j, q) of every (lane, pass p) of a warp: the sample j of the chunk
    and the channel group q it writes, j = p · 32/L + lane / L,
    q = lane % L."""
    G = 32 // L
    lane = np.arange(32)[:, None]
    p = np.arange(PASSES)[None]
    return p * G + lane // L + 0 * p, lane % L + 0 * p


@pytest.mark.parametrize("shape", DTU + TANKS + ODD)
def test_plan_writes_every_element_once(shape):
    """The write index (first + j) · C + 4q + c is the product of three
    maps: the warps' (first, count) sample ranges partition [0, n), each
    warp's (lane, s) → (j, q) hits [0, NW) × [0, L) once, and its writes
    keep j < count."""
    h, w, C, D = shape
    n = D * h * w
    L, NW, grid = plan(C, h, w, D)
    if L is None:                    # one thread an element
        assert (grid - 1) * THREADS < n * C <= grid * THREADS
        return
    gx, gy, gz = grid
    assert gy == D <= 65535 and gz * WARPS >= h > (gz - 1) * WARPS
    assert gx * NW >= w > (gx - 1) * NW
    first, count = warps(h, w, NW, grid)
    assert (count > 0).all() and count.sum() == n
    order = np.argsort(first)
    first, count = first[order], count[order]
    assert first[0] == 0
    assert np.array_equal(first[1:], first[:-1] + count[:-1])
    j, q = lane_map(L)
    assert np.array_equal(np.bincount((j * L + q).ravel(),
                                      minlength=NW * L), np.ones(NW * L))
    # within a warp the stores of one pass are 32 lanes × 16 contiguous
    # bytes: lane l writes float offset 4·l of the pass
    for p in range(PASSES):
        assert np.array_equal(j[:, p] * C + 4 * q[:, p],
                              p * 32 * 4 + 4 * np.arange(32))
    # whole warps of samples a chunk (each lane plans NW / 32), 32-bit tap
    # offsets (h + 2)(w + 2)C, and the staging within 48 KB a block
    assert NW % 32 == 0 and (h + 2) * (w + 2) * C < 2**31
    assert WARPS * NW * (16 + 8) <= 48 * 1024


def _fma(a, b, c):
    """fmaf: a·b exact in float64, one rounding to float32."""
    return (a.astype(np.float64) * b + c).astype(f32)


def tap_plan(px, py, h, w, C):
    """The kernel's per-sample staging: (tap 0's float offset, landing
    mask bits, weights [n, 4]) with warp::taps_at / tap_weight."""
    x0f, y0f = np.floor(px), np.floor(py)
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)
    wx, wy = (px - x0f).astype(f32), (py - y0f).astype(f32)
    x0in, x1in = (x0 >= 0) & (x0 < w), (x0 >= -1) & (x0 < w - 1)
    y0in, y1in = (y0 >= 0) & (y0 < h), (y0 >= -1) & (y0 < h - 1)
    mask = ((x0in & y0in) | (x1in & y0in) << 1 | (x0in & y1in) << 2
            | (x1in & y1in) << 3)
    one = f32(1)
    wgt = np.stack([((one - wx) * (one - wy)), (wx * (one - wy)),
                    ((one - wx) * wy), (wx * wy)], -1).astype(f32)
    return (y0 * w + x0) * C, mask, wgt


def per_sample_rule(src, px, py):
    """The parent kernel's rule sample by sample: taps 0..3 in order, one
    fma each, a tap outside the image skipped."""
    h, w, C = src.shape
    flat = src.reshape(-1)
    off, mask, wgt = tap_plan(px.ravel(), py.ravel(), h, w, C)
    val = np.zeros((off.size, C), f32)
    for k in range(4):
        ok = (mask >> k & 1).astype(bool)
        t = off + (C if k & 1 else 0) + (w * C if k >> 1 else 0)
        s = flat[np.where(ok, t, 0)[:, None] + np.arange(C)]
        val = np.where(ok[:, None], _fma(wgt[:, k:k + 1], s, val), val)
    return val.reshape(*px.shape, C)


def emulate_k10(src, px, py):
    """warp_view_f32 warp by warp (the lane kernel for C in LANE_C, the
    scalar kernel otherwise); returns [D, h, w, C], NaN where nothing was
    written, and asserts nothing is written twice."""
    h, w, C = src.shape
    D = px.shape[0]
    n = D * h * w
    flat = src.reshape(-1)
    out = np.full(n * C, np.nan, f32)
    L, NW, grid = plan(C, h, w, D)
    pxf, pyf = px.reshape(-1), py.reshape(-1)
    if L is None:
        idx = np.arange(grid * THREADS)
        idx = idx[idx < n * C]
        q, c = idx // C, idx % C
        off, mask, wgt = tap_plan(pxf[q], pyf[q], h, w, 1)
        val = np.zeros(idx.size, f32)
        for k in range(4):
            ok = (mask >> k & 1).astype(bool)
            p = off + (1 if k & 1 else 0) + (w if k >> 1 else 0)
            s = flat[np.where(ok, p * C + c, 0)]
            val = np.where(ok, _fma(wgt[:, k], s, val), val)
        out[idx] = val
        return out.reshape(D, h, w, C)
    first, count = warps(h, w, NW, grid)
    # staging: sample i of each warp, i >= count staged empty
    i = np.arange(NW)
    live = i[None] < count[:, None]                         # [warps, NW]
    samp = np.minimum(first[:, None] + i[None], n - 1)
    off, mask, wgt = tap_plan(pxf[samp], pyf[samp], h, w, C)
    mask = np.where(live, mask, 0)
    tap_off = (0, C, w * C, w * C + C)
    jm, qm = lane_map(L)
    P = PASSES
    for lane in range(32):
        ring = [None, None]

        def gather(p):
            j, q = jm[lane, p], qm[lane, p]
            taps = []
            for k in range(4):
                ok = (mask[:, j] >> k & 1).astype(bool)
                a = off[:, j] + tap_off[k] + 4 * q
                v = flat[np.where(ok, a, 0)[:, None] + np.arange(4)]
                taps.append(np.where(ok[:, None], v, 0))
            ring[p % 2] = (mask[:, j], taps)

        gather(0)
        for p in range(P):
            if p + 1 < P:
                gather(p + 1)
            j, q = jm[lane, p], qm[lane, p]
            m, taps = ring[p % 2]
            acc = np.zeros((first.size, 4), f32)
            for k in range(4):
                ok = (m >> k & 1).astype(bool)
                acc = np.where(ok[:, None],
                               _fma(wgt[:, j, k:k + 1], taps[k], acc), acc)
            keep = j < count
            dst = ((first[keep] + j) * C + 4 * q)[:, None] + np.arange(4)
            assert np.isnan(out[dst]).all()
            out[dst] = acc[keep]
    return out.reshape(D, h, w, C)


def _coords(h, w, D, rng):
    """px, py [D, h, w] as pixel_coords leaves them (clipped to [-2, w+1]
    and [-2, h+1]), with samples exactly on the clip bounds and on the
    last pixel, and whole rows out of the image."""
    px = rng.uniform(-3.0, w + 2.0, (D, h, w)).astype(f32)
    py = rng.uniform(-3.0, h + 2.0, (D, h, w)).astype(f32)
    px[:, :, 0], py[:, 0, :] = -2.0, h + 1.0
    px[:, :, -1], py[:, :, 1 % w] = w + 1.0, -2.0
    px[0, h // 2, :] = rng.uniform(-2.0, -1.0, w)       # a row left of it
    py[-1, h - 1, :] = h + 1.0                          # a row below it
    px[:, 1 % h, 2 % w], py[:, 1 % h, 2 % w] = w - 1.0, h - 1.0
    return (np.clip(px, -2.0, w + 1.0).astype(f32),
            np.clip(py, -2.0, h + 1.0).astype(f32))


@pytest.mark.parametrize("h,w,C,D", ODD + ((6, 10, 16, 5), (5, 9, 32, 4),
                                           (9, 13, 4, 3), (40, 70, 8, 2)))
def test_kernel_emulation_matches_plain(h, w, C, D):
    rng = np.random.default_rng(h * w + C * D)
    src = rng.standard_normal((h, w, C)).astype(f32)
    px, py = _coords(h, w, D, rng)
    got = emulate_k10(src, px, py)
    assert not np.isnan(got).any()
    assert np.array_equal(got, per_sample_rule(src, px, py))
    want = warp_view_plain(torch.from_numpy(src), torch.from_numpy(px),
                           torch.from_numpy(py)).numpy()
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the whole rows out of the image read zero
    assert not got[0, h // 2].any() and not got[-1, h - 1].any()
