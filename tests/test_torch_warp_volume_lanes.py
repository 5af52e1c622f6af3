"""K7's forward lanes (`ops/csrc/warp_volume.cu` on the block skeleton of
`ops/csrc/warp_fwd.cuh`), checked on the CPU.

CUDA cannot run here, so these tests hold the kernel's mapping of lanes,
pixels, planes and staging rows in plain numpy:
  * the plan (K1's `fwd_plan`: P pixels a block, a chunk of DC planes a
    block walks) with K7's 2C + 3(V−1) staging rows writes every element
    of var [C, D, h, w] and vol [3(V−1) + C, D, h, w] exactly once, at the
    train shape and at odd sizes (h·w not a multiple of P, D not a
    multiple of DC, V 2 and 5); the lanes' stage writes fill each staged
    row and pixel exactly once; the staging buffer fits a block's shared
    memory at every C and V the kernel takes;
  * an emulation of the kernel block by block (lane q of a pixel's group
    of C/4 lanes owns channels 4q..4q+3 and projects views q, q + C/4,
    ...; the group's lanes take each view's taps from its owner; the owner
    samples that view's RGB at its own taps; Σx and Σx² over the source
    views, x² with one fused multiply-add, divisions by V, the reference
    last) equals `warp_volume_plain` to 1e-4 of the largest value.
"""
import numpy as np
import pytest
import torch
from test_torch_warp_lanes import (THREADS, _coords, _depth_row, _inputs,
                                   _rot_row, _sample_quad, _stage_stride,
                                   plan)

from rcmvsnet_tpu_torch.ops import warp_volume as K7
from rcmvsnet_tpu_torch.ops.warp_variance import relative_projections

torch.set_num_threads(2)
f32 = np.float32
SMEM_MAX = 232448           # bytes of shared memory a block may use (H100)
STATIC_MAX = 48 * 1024      # above this, the launch raises the limit

# (V, h, w, C, D): the train stage 1, then odd sizes
SHAPES = ((4, 128, 160, 32, 48), (5, 81, 95, 32, 48), (2, 9, 7, 8, 5),
          (5, 13, 21, 16, 7), (2, 24, 40, 16, 32), (5, 5, 7, 8, 9))


def rows(C, V):
    """K7's staging rows: var (C), images (3(V−1)), no-ref variance (C)."""
    return 2 * C + 3 * (V - 1)


def stage_addresses(C, V):
    """Every shared-memory slot the block's 256 lanes write in `stage`,
    as (row, pixel) pairs: var at row 4q + k, the no-ref variance at
    C + 3(V−1) + 4q + k, view v's RGB at C + 3v + c by the lane q = v mod
    L that projected v (its s = v div L-th view)."""
    L = C // 4
    P = THREADS // L
    nv = V - 1
    S = -(-nv // L)
    tid = np.arange(THREADS)
    j, q = tid // L, tid % L
    out = []
    for k in range(4):
        out += list(zip(4 * q + k, j))
        out += list(zip(C + 3 * nv + 4 * q + k, j))
    for s in range(S):
        v = s * L + q
        own = v < nv
        for c in range(3):
            out += list(zip((C + 3 * v + c)[own], j[own]))
    assert all(0 <= jj < P for _, jj in out)
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_writes_every_element_of_var_and_vol_once(shape):
    """The write index is the product of the block's write loop i ->
    (row r, pixel jj) over rows·P, the blocks' pixels bx·P + jj (masked to
    h·w) and the chunks' planes bz·DC + dd (masked to D); rows [0, C) go
    to var, rows [C, 2C + 3(V−1)) to vol's rows r − C. Each map hits its
    range once, so the product does; where it is small the product is
    also counted element by element."""
    V, h, w, C, D = shape
    HW, R = h * w, rows(C, V)
    P, nx, dc, nz = plan(h, w, C, D)
    i = np.concatenate([np.arange(t, R * P, THREADS) for t in range(THREADS)])
    assert np.array_equal(np.sort(i), np.arange(R * P))
    r, jj = i // P, i % P
    pix = (np.arange(nx)[:, None] * P + np.arange(P)[None]).ravel()
    assert np.array_equal(np.bincount(pix[pix < HW], minlength=HW),
                          np.ones(HW))
    d = (np.arange(nz)[:, None] * dc + np.arange(dc)[None]).ravel()
    assert np.array_equal(np.bincount(d[d < D], minlength=D), np.ones(D))
    # one block's (row, pixel) pairs, then the output element each names
    assert np.array_equal(np.bincount(r * P + jj, minlength=R * P),
                          np.ones(R * P))
    # rows [0, C) -> var's rows, [C, R) -> vol's rows r - C: together one
    # flat index over var then vol, hit once per (row, plane, pixel)
    rr, bb, dd = np.meshgrid(np.arange(R), np.arange(nx), d[d < D],
                             indexing="ij")
    if rr.size * P <= 4_000_000:         # the full product where it is small
        flat = ((rr[..., None] * D + dd[..., None]) * HW
                + bb[..., None] * P + np.arange(P))
        flat = flat[(bb[..., None] * P + np.arange(P)) < HW]
        assert np.array_equal(np.bincount(flat, minlength=R * D * HW),
                              np.ones(R * D * HW))
    # the lanes' stage writes fill every staged (row, pixel) once
    addr = stage_addresses(C, V)
    assert sorted(addr) == [(rr, pp) for rr in range(R) for pp in range(P)]


@pytest.mark.parametrize("C", (8, 16, 32))
def test_staging_fits_shared_memory(C):
    """2 planes × rows × PS floats: under 48 KiB static at the train
    shape, and within a block's limit for every V ≤ 16 (the launch raises
    the dynamic limit where it passes 48 KiB)."""
    PS = _stage_stride(C)
    assert 2 * rows(C, 4) * PS * 4 <= STATIC_MAX
    for V in range(2, K7.MAX_VIEWS + 1):
        assert 2 * rows(C, V) * PS * 4 + 16 * 16 * 4 <= SMEM_MAX


def _sample_rgb(im, x0, y0, wx, wy, own, h, w):
    """sample_rgb for the lanes in `own`: taps 0..3, one fma each."""
    rgb = np.zeros((len(x0), 3), f32)
    for k in range(4):
        xi, yi = x0 + (k & 1), y0 + (k >> 1)
        ok = own & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        wgt = (f32(wx if k & 1 else f32(1) - wx)
               * f32(wy if k >> 1 else f32(1) - wy)).astype(f32)
        p = np.where(ok, yi * w + xi, 0)
        s = im[np.arange(len(x0)), p]                      # [lanes, 3]
        fma = (wgt[:, None].astype(np.float64) * s + rgb).astype(f32)
        rgb = np.where(ok[:, None], fma, rgb)
    return rgb


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(f32)


def emulate_k7(feats, imgs, rel, lo, step, D, dc=None):
    """warp_volume_kernel block by block over its 256 threads; returns
    (var [C, D, h, w], vol [3(V−1) + C, D, h, w])."""
    V, h, w, C = feats.shape
    HW, nv, L = h * w, V - 1, C // 4
    P, nx, dc0, _ = plan(h, w, C, D)
    dc = dc or dc0
    PS, R = _stage_stride(C), rows(C, V)
    S = -(-nv // L)
    src = feats.reshape(V, HW, C)
    im = imgs.reshape(V, HW, 3)
    lo, step = lo.reshape(-1), step.reshape(-1)
    var = np.full((C, D, HW), np.nan, f32)
    vol = np.full((R - C, D, HW), np.nan, f32)
    tid = np.arange(THREADS)
    j, q = tid // L, tid % L
    chans = 4 * q[:, None] + np.arange(4)[None]               # [256, 4]
    fv = f32(V)
    for bx in range(nx):
        p0 = bx * P
        pix = np.minimum(p0 + j, HW - 1)
        y = pix // w
        fx, fy = (pix - y * w).astype(f32), y.astype(f32)
        ref = src[0][pix[:, None], chans]
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
                sm = np.zeros((THREADS, 4), f32)
                sq = np.zeros((THREADS, 4), f32)
                for v in range(nv):
                    owner = j * L + v % L          # the shuffle's source lane
                    taps = [a[owner] for a in mine[v // L]]
                    val = _sample_quad(src[v + 1], *taps, chans, h, w)
                    sm = (sm + val).astype(f32)
                    sq = _fma(val, val, sq)
                so = np.full(R * PS, np.nan, f32)
                m_nr = (sm / fv).astype(f32)
                nr = _fma(-m_nr, m_nr, (sq / fv).astype(f32))
                m = ((sm + ref).astype(f32) / fv).astype(f32)
                vr = _fma(-m, m, (_fma(ref, ref, sq) / fv).astype(f32))
                for k in range(4):
                    so[chans[:, k] * PS + j] = vr[:, k]
                    so[(C + 3 * nv + chans[:, k]) * PS + j] = nr[:, k]
                for s in range(S):
                    v = views[s]
                    own = v < nv
                    x0, y0, wx, wy = mine[s]
                    rgb = _sample_rgb(im[np.where(own, v + 1, 0)], x0, y0,
                                      wx, wy, own, h, w)
                    for c in range(3):
                        so[((C + 3 * v + c) * PS + j)[own]] = rgb[own, c]
                i = np.arange(R * P)
                r, jj = i // P, i % P
                keep = p0 + jj < HW
                val = so[r * PS + jj]
                assert not np.isnan(val[keep]).any()
                a = keep & (r < C)
                assert np.isnan(var[r[a], d, p0 + jj[a]]).all()
                var[r[a], d, p0 + jj[a]] = val[a]
                b = keep & (r >= C)
                assert np.isnan(vol[r[b] - C, d, p0 + jj[b]]).all()
                vol[r[b] - C, d, p0 + jj[b]] = val[b]
    return var.reshape(C, D, h, w), vol.reshape(R - C, D, h, w)


@pytest.mark.parametrize("V,h,w,C,D,dc", [
    (4, 9, 7, 8, 5, 2), (5, 11, 13, 16, 7, 3), (2, 6, 10, 32, 8, 3),
    (4, 5, 7, 32, 4, None), (9, 6, 7, 8, 3, 2)])
def test_kernel_emulation_matches_plain(V, h, w, C, D, dc):
    """Including 8 source views at C = 8: more views than lanes, so a
    lane projects, and samples the RGB of, several of them."""
    feats, projs, lo, step = _inputs(V, h, w, C, h * w + C + V)
    imgs = np.random.default_rng(V * C).random((V, h, w, 3)).astype(f32)
    T = torch.from_numpy
    rel = relative_projections(T(projs)).reshape(V, 4, 4).numpy()
    got = emulate_k7(feats, imgs, rel, lo, step, D, dc)
    want = K7.warp_volume_plain(T(feats), T(imgs), T(projs), T(lo),
                                T(step), D)
    for g, p in zip(got, want):
        assert not np.isnan(g).any()
        p = p.numpy()
        assert g.shape == p.shape
        assert np.abs(g - p).max() <= 1e-4 * np.abs(p).max()
    assert got[1].shape[0] == 3 * (V - 1) + C
