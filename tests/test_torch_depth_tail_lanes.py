"""K4's thread loop (`ops/csrc/depth_tail.cu`), checked on the CPU.

CUDA cannot run here, so a numpy emulation of the kernel (thread t of
block b owns pixel 128·b + t; its D costs in registers; max, then exp and
Σ, then p = e / Σ with Σp·dv and Σp·d, then trunc, clamp and the window
[i−1, i+2] summed over the planes in order) is held against
`depth_tail_plain` at D 2, 8, 13, 48 and 64 (the kernel's instances for
8 and 48, and its generic one) and at a pixel count that is not a
multiple of the block: depth to relative 1e-5 per pixel, confidence
within 1e-4 on all but 1e-3 of the pixels, the gates chip_smoke.py holds
the kernel to. Costs peaked at the first and the last plane put the
window across both edges of the volume.
"""
import numpy as np
import pytest
import torch

from rcmvsnet_tpu_torch.ops.depth_tail import MAX_DEPTH, depth_tail_plain

f32 = np.float32
THREADS = 128                       # the kernel's block (kThreads)


def emulate_k4(cost, lo, step):
    """depth_tail_kernel over its grid; cost [D, h, w] → (depth, conf)."""
    D, h, w = cost.shape
    n = h * w
    c_all = cost.reshape(D, n)
    lo, step = lo.reshape(-1), step.reshape(-1)
    depth = np.full(n, np.nan, f32)
    conf = np.full(n, np.nan, f32)
    for b in range(-(-n // THREADS)):
        p = b * THREADS + np.arange(THREADS)
        p = p[p < n]                                   # the bounds check
        c = c_all[:, p].astype(f32)                    # [D, threads]
        m = c.max(axis=0)
        e = np.exp((c - m).astype(f32)).astype(f32)
        s = np.zeros(len(p), f32)
        for d in range(D):
            s = (s + e[d]).astype(f32)
        dsum = np.zeros(len(p), f32)
        isum = np.zeros(len(p), f32)
        prob = (e / s).astype(f32)
        for d in range(D):
            dv = (lo[p] + (f32(d) * step[p]).astype(f32)).astype(f32)
            dsum = (prob[d].astype(np.float64) * dv + dsum).astype(f32)
            isum = (prob[d].astype(np.float64) * d + isum).astype(f32)
        i = np.clip(isum.astype(np.int64), 0, D - 1)   # trunc, then clamp
        win = np.zeros(len(p), f32)
        for d in range(D):
            inside = (d >= i - 1) & (d <= i + 2)
            win = np.where(inside, (win + prob[d]).astype(f32), win)
        assert np.isnan(depth[p]).all()
        depth[p], conf[p] = dsum, win
    return depth.reshape(h, w), conf.reshape(h, w)


def _inputs(D, h, w, seed, edges=False):
    rng = np.random.default_rng(seed)
    cost = (3 * rng.standard_normal((D, h, w))).astype(f32)
    if edges:
        # a sharp peak at plane 0 in the left half, at D − 1 in the right
        cost[0, :, : w // 2] += 30
        cost[D - 1, :, w // 2:] += 30
    lo = (425 + 500 * rng.random((h, w))).astype(f32)
    step = (2.5 + rng.random((h, w))).astype(f32)
    return cost, lo, step


@pytest.mark.parametrize("D", [2, 8, 13, 48, MAX_DEPTH])
@pytest.mark.parametrize("edges", [False, True])
def test_emulation_matches_plain(D, edges):
    h, w = 9, 31                                       # 279 = 2·128 + 23
    cost, lo, step = _inputs(D, h, w, D, edges)
    depth, conf = emulate_k4(cost, lo, step)
    T = torch.from_numpy
    d_p, c_p = (t.numpy() for t in depth_tail_plain(T(cost), T(lo),
                                                    T(step)))
    assert not np.isnan(depth).any() and not np.isnan(conf).any()
    assert np.max(np.abs(depth - d_p) / np.abs(d_p)) <= 1e-5
    assert np.mean(np.abs(conf - c_p) > 1e-4) <= 1e-3
    if edges:
        # the window's index sits at the first plane on the left (i − 1
        # clipped) and within 2 of the last on the right (i + 2 clipped)
        e = np.exp(cost - cost.max(axis=0))
        i = np.trunc((e / e.sum(axis=0)
                      * np.arange(D)[:, None, None]).sum(0))
        assert (i[:, : w // 2] == 0).all()
        assert (i[:, w // 2:] + 2 >= D).all()
