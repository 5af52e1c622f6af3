"""K4: fused softmax + depth regression + photometric confidence (Triton).

`depth_tail` launches the Triton kernel below for a CUDA tensor; for a CPU
tensor it returns `depth_tail_plain`: softmax over D, `depth_regression`
and the cumsum `photometric_confidence`, as `rcmvsnet_tpu/models/
cascade.py:40-68,281-288` compute them.

Replaces `rcmvsnet_tpu/ops/pallas_tail.py` `fused_depth_tail`. The work is
a per-pixel reduction over D ≤ 64 with no reuse across pixels, so it is
bound by reading the cost volume once: one program loads a [D_PAD, BLOCK]
tile (pixels contiguous, coalesced), and keeps max, exp, Σ, Σp·dv and Σp·d
in registers. The confidence is Σ_d p[d]·[i−1 ≤ d ≤ i+2] with
i = clamp(trunc(Σp·d), 0, D−1), which equals the reference's pad-(1, 2)
window-4 sum gathered at i and needs no shifted tiles.
"""
from __future__ import annotations

import os

import torch

from . import _build

MAX_DEPTH = 64
BLOCK = 128


def depth_regression(prob: torch.Tensor,
                     depth_values: torch.Tensor) -> torch.Tensor:
    """Soft-argmax Σ p·d over axis 1. prob [B, D, H, W]; depth_values
    [B, D] or [B, D, H, W]."""
    if depth_values.ndim == 2:
        depth_values = depth_values[:, :, None, None]
    return torch.sum(prob * depth_values, dim=1)


def photometric_confidence(prob: torch.Tensor) -> torch.Tensor:
    """Probability mass of the 4-window around the soft-argmax index.

    prob [B, D, H, W]: pad depth by (1, 2), sliding window-4 sum (by
    cumsum), gathered at trunc(Σ p·i) clamped to [0, D−1]."""
    B, D, H, W = prob.shape
    padded = torch.nn.functional.pad(prob, (0, 0, 0, 0, 1, 2))
    csum = torch.nn.functional.pad(torch.cumsum(padded, dim=1),
                                   (0, 0, 0, 0, 1, 0))
    sum4 = csum[:, 4:] - csum[:, :-4]                       # [B, D, H, W]
    idx_f = torch.sum(prob * torch.arange(D, dtype=prob.dtype,
                                          device=prob.device)
                      [None, :, None, None], dim=1)
    idx = torch.clamp(idx_f.long(), 0, D - 1)                # trunc
    return torch.gather(sum4, 1, idx[:, None])[:, 0]


def depth_tail_plain(cost: torch.Tensor, lo: torch.Tensor,
                     step: torch.Tensor):
    """cost [D, h, w]; hypotheses dv(d) = lo + d·step with lo, step
    [h, w]. Returns (depth, confidence), each [h, w] float32."""
    D = cost.shape[0]
    idx = torch.arange(D, dtype=lo.dtype, device=lo.device)
    dv = lo[None] + idx[:, None, None] * step[None]
    prob = torch.softmax(cost.float(), dim=0)[None]
    return (depth_regression(prob, dv[None])[0],
            photometric_confidence(prob)[0])


def _depth_tail_kernel(cost_ptr, lo_ptr, step_ptr, depth_ptr, conf_ptr,
                       n_pix, D: tl.constexpr, D_PAD: tl.constexpr,
                       BLOCK: tl.constexpr):
    """Triton body for one block of BLOCK pixels (compiled by
    `_triton_kernel`; `tl` is bound when triton is first imported)."""
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    dd = tl.arange(0, D_PAD)
    pmask = offs < n_pix
    dmask = dd < D
    c = tl.load(cost_ptr + dd[:, None] * n_pix + offs[None, :],
                mask=dmask[:, None] & pmask[None, :], other=0.0)
    c = tl.where(dmask[:, None], c, float("-inf"))
    m = tl.max(c, axis=0)
    e = tl.exp(c - m[None, :])
    p = e / tl.sum(e, axis=0)[None, :]
    lo = tl.load(lo_ptr + offs, mask=pmask, other=0.0)
    st = tl.load(step_ptr + offs, mask=pmask, other=0.0)
    df = dd.to(tl.float32)
    dv = lo[None, :] + df[:, None] * st[None, :]
    depth = tl.sum(p * dv, axis=0)
    idx = tl.sum(p * df[:, None], axis=0).to(tl.int32)       # truncation
    idx = tl.minimum(tl.maximum(idx, 0), D - 1)
    win = (dd[:, None] >= idx[None, :] - 1) & (dd[:, None] <= idx[None, :] + 2)
    conf = tl.sum(tl.where(win, p, 0.0), axis=0)
    tl.store(depth_ptr + offs, depth, mask=pmask)
    tl.store(conf_ptr + offs, conf, mask=pmask)


_kernel = None


def _triton_kernel():
    """JIT-wrap the kernel at first use: triton is imported only here, so
    the module imports on a machine without it."""
    global _kernel, tl
    if _kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(_build.BUILD_DIR / "triton"))
        import triton
        import triton.language as tl
        _kernel = triton.jit(_depth_tail_kernel)
    return _kernel


def depth_tail(cost: torch.Tensor, lo: torch.Tensor, step: torch.Tensor):
    """Same contract as `depth_tail_plain`; the kernel on a CUDA tensor."""
    if cost.device.type == "cpu":
        return depth_tail_plain(cost, lo, step)
    D, h, w = cost.shape
    if D > MAX_DEPTH or lo.shape != (h, w) or step.shape != (h, w):
        raise ValueError(f"depth_tail: D <= {MAX_DEPTH} and lo/step "
                         f"[{h}, {w}] required, got {tuple(cost.shape)}")
    _build.require_cuda("depth_tail", cost, lo, step)
    n_pix = h * w
    depth = torch.empty((h, w), dtype=torch.float32, device=cost.device)
    conf = torch.empty_like(depth)
    d_pad = max(16, 1 << (D - 1).bit_length())
    kernel = _triton_kernel()
    kernel[(-(-n_pix // BLOCK),)](
        cost, lo, step, depth, conf, n_pix, D=D, D_PAD=d_pad, BLOCK=BLOCK,
        num_warps=4)
    depth_tail.launches += 1
    return depth, conf


depth_tail.launches = 0
