"""K4: fused softmax + depth regression + photometric confidence.

`depth_tail` launches the CUDA kernel `csrc/depth_tail.cu` for a CUDA
tensor; for a CPU tensor it returns `depth_tail_plain`: softmax over D,
`depth_regression` and the cumsum `photometric_confidence`, as
`rcmvsnet_tpu/models/cascade.py:40-68,281-288` compute them.

Replaces `rcmvsnet_tpu/ops/pallas_tail.py` `fused_depth_tail`, which takes
any D. The work is a per-pixel reduction over D with no reuse across
pixels, so it is bound by reading the cost volume once: one thread owns a
pixel and, for D ≤ MAX_DEPTH, keeps its D costs in registers (D a template
parameter of the kernel for the cascade's 8, 32 and 48 planes, nothing
padded), max, exp, Σ, Σp·dv and Σp·d with them; a warp's loads of each
plane are one coalesced line. Above MAX_DEPTH a streaming instance makes
one pass with an online max and rescaled sums, divides once, and re-reads
the ≤ 4 planes of the confidence window (its order of operations is in the
source's header).
The confidence is Σ_d p[d]·[i−1 ≤ d ≤ i+2] with i = clamp(trunc(Σp·d),
0, D−1), which equals the reference's pad-(1, 2) window-4 sum gathered at
i and needs no shifted copies.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_DEPTH = 64          # the largest D of the register instances


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
    """cost [D, h, w] float32 (the bf16 path's prob head writes float32,
    as the JAX tail takes it); hypotheses dv(d) = lo + d·step with lo,
    step [h, w]. Returns (depth, confidence), each [h, w] float32."""
    _float32_cost("depth_tail_plain", cost)
    D = cost.shape[0]
    idx = torch.arange(D, dtype=lo.dtype, device=lo.device)
    dv = lo[None] + idx[:, None, None] * step[None]
    prob = torch.softmax(cost.float(), dim=0)[None]
    return (depth_regression(prob, dv[None])[0],
            photometric_confidence(prob)[0])


def _float32_cost(name: str, cost: torch.Tensor) -> None:
    if cost.dtype != torch.float32:
        raise TypeError(f"{name}: the cost volume must be float32, got "
                        f"{cost.dtype}")


def _lib():
    fn = _build.load("depth_tail").depth_tail_f32
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def depth_tail(cost: torch.Tensor, lo: torch.Tensor, step: torch.Tensor):
    """Same contract as `depth_tail_plain`; the kernel on a CUDA tensor."""
    if cost.device.type == "cpu":
        return depth_tail_plain(cost, lo, step)
    _float32_cost("depth_tail", cost)
    D, h, w = cost.shape
    if lo.shape != (h, w) or step.shape != (h, w):
        raise ValueError(f"depth_tail: lo/step [{h}, {w}] required, got "
                         f"{tuple(lo.shape)}, {tuple(step.shape)}")
    _build.require_cuda("depth_tail", cost, lo, step)
    depth = torch.empty((h, w), dtype=torch.float32, device=cost.device)
    conf = torch.empty_like(depth)
    err = _lib()(cost.data_ptr(), lo.data_ptr(), step.data_ptr(),
                 depth.data_ptr(), conf.data_ptr(), h * w, D,
                 _build.stream_ptr(cost.device))
    _build.check(err, "depth_tail")
    depth_tail.launches += 1
    return depth, conf


depth_tail.launches = 0
