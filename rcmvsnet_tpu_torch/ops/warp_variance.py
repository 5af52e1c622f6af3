"""K1: fused plane-sweep warp + multi-view variance, and K6, its backward.

`warp_variance` launches the CUDA kernel `csrc/warp_variance.cu` for a
CUDA tensor; for a CPU tensor it returns `warp_variance_plain`, the same
function in plain PyTorch (`ops/warp.plane_sweep_variance` on the
[D, h, w] hypothesis volume built from (lo, step)). The kernel gives a
group of C/4 lanes to each reference pixel (one float4 of channels a
lane) and a block of 256 lanes walks a chunk of planes for its pixels
(the kernel's entry sizes the grid: `plan` in the source).

`warp_variance_bwd` (K6) is the cotangent of the features: the second entry
of the same source on a CUDA tensor, `warp_variance_bwd_plain` (autograd
through the plain version) on a CPU one. K6 sums in 64-bit fixed point
(`csrc/warp_bwd.cuh`), so two calls on the same inputs agree in every
bit. `warp_variance_train` wraps the pair in one `torch.autograd.Function`;
the projections and depth planes get no gradient (the sampling grid carries
none).

Replaces the TPU kernels `rcmvsnet_tpu/ops/pallas_warp2.py`
`plane_sweep_variance_lanes` (planes mode) and the backward of
`rcmvsnet_tpu/ops/pallas_warp_train.py` `plane_sweep_variance_fused_train`.
The TPU kernels' VMEM residency, band ladder and coverage counter are not
ported: the Hopper kernels sample straight from device memory and have no
such precondition.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.geometry import relative_projection
from . import _build
from .warp import plane_sweep_variance

CHANNELS = (8, 16, 32)
MAX_VIEWS = 16


def relative_projections(projs: torch.Tensor) -> torch.Tensor:
    """[V, 4, 4] K-folded projections → [V, 16] src @ inv(ref), row 0 the
    identity (the kernel reads the reference view in place)."""
    eye = torch.eye(4, dtype=torch.float32, device=projs.device)[None]
    rel = relative_projection(projs[1:].float(), projs[:1].float())
    return torch.cat([eye, rel]).reshape(-1, 16).contiguous()


def warp_variance_plain(feats: torch.Tensor, projs: torch.Tensor,
                        lo: torch.Tensor, step: torch.Tensor,
                        ndepth: int) -> torch.Tensor:
    """feats [V, h, w, C] (view 0 = reference), projs [V, 4, 4], lo/step
    [h, w] → variance [C, D, h, w] over dv(d) = lo + d·step."""
    idx = torch.arange(ndepth, dtype=lo.dtype, device=lo.device)
    dv = lo[None] + idx[:, None, None] * step[None]               # [D, h, w]
    V = feats.shape[0]
    var = plane_sweep_variance(
        feats[:1], [feats[v:v + 1] for v in range(1, V)],
        [projs[v:v + 1] for v in range(1, V)], projs[:1], dv[None])
    return var[0].permute(3, 0, 1, 2).contiguous()


def warp_variance_bwd_plain(feats: torch.Tensor, projs: torch.Tensor,
                            lo: torch.Tensor, step: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """Cotangent of feats [V, h, w, C] for the variance cotangent g
    [C, D, h, w]: autograd through `warp_variance_plain`."""
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        var = warp_variance_plain(f, projs, lo, step, g.shape[1])
        return torch.autograd.grad(var, f, g)[0]


def _lib(entry="warp_variance_f32", n_ptr=5):
    fn = getattr(_build.load("warp_variance"), entry)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bwd_scratch(source: str, feats: torch.Tensor) -> torch.Tensor:
    """The scratch a backward entry of `csrc/<source>.cu` takes for feats
    [V, h, w, C] (its fixed-point sums and their quantum), as bytes on
    feats' device; the entry `<source>_bwd_scratch_bytes` sizes it."""
    fn = getattr(_build.load(source), f"{source}_bwd_scratch_bytes")
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    return torch.empty(fn(*feats.shape), dtype=torch.uint8,
                       device=feats.device)


def _check(name, feats, lo, step):
    V, h, w, C = feats.shape
    if C not in CHANNELS or not 1 <= V <= MAX_VIEWS:
        raise ValueError(f"{name}: C in {CHANNELS} and 1 <= V <= "
                         f"{MAX_VIEWS}, got V={V} C={C}")
    if lo.shape != (h, w) or step.shape != (h, w):
        raise ValueError(f"{name}: lo/step must be {(h, w)}")


def warp_variance(feats: torch.Tensor, projs: torch.Tensor,
                  lo: torch.Tensor, step: torch.Tensor,
                  ndepth: int) -> torch.Tensor:
    """Same contract as `warp_variance_plain`; the kernel on a CUDA tensor."""
    if feats.device.type == "cpu":
        return warp_variance_plain(feats, projs, lo, step, ndepth)
    _check("warp_variance", feats, lo, step)
    V, h, w, C = feats.shape
    rel = relative_projections(projs)
    _build.require_cuda("warp_variance", feats, rel, lo, step)
    out = torch.empty((C, ndepth, h, w), dtype=torch.float32,
                      device=feats.device)
    err = _lib()(feats.data_ptr(), rel.data_ptr(), lo.data_ptr(),
                 step.data_ptr(), out.data_ptr(), V, h, w, C, ndepth,
                 _build.stream_ptr(feats.device))
    _build.check(err, "warp_variance")
    warp_variance.launches += 1
    return out


warp_variance.launches = 0


def warp_variance_bwd(feats: torch.Tensor, projs: torch.Tensor,
                      lo: torch.Tensor, step: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """Same contract as `warp_variance_bwd_plain`; K6 on a CUDA tensor."""
    if feats.device.type == "cpu":
        return warp_variance_bwd_plain(feats, projs, lo, step, g)
    _check("warp_variance_bwd", feats, lo, step)
    V, h, w, C = feats.shape
    D = g.shape[1]
    if tuple(g.shape) != (C, D, h, w):
        raise ValueError(f"warp_variance_bwd: g {tuple(g.shape)} is not "
                         f"[{C}, D, {h}, {w}]")
    rel = relative_projections(projs)
    _build.require_cuda("warp_variance_bwd", feats, rel, lo, step, g)
    dsrc = torch.empty_like(feats)
    scratch = bwd_scratch("warp_variance", feats)
    err = _lib("warp_variance_bwd_f32", 7)(
        feats.data_ptr(), rel.data_ptr(), lo.data_ptr(), step.data_ptr(),
        g.data_ptr(), dsrc.data_ptr(), scratch.data_ptr(), V, h, w, C, D,
        _build.stream_ptr(feats.device))
    _build.check(err, "warp_variance_bwd")
    warp_variance_bwd.launches += 1
    return dsrc


warp_variance_bwd.launches = 0


class _WarpVariance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, projs, lo, step, ndepth):
        ctx.save_for_backward(feats, projs, lo, step)
        return warp_variance(feats, projs, lo, step, ndepth)

    @staticmethod
    def backward(ctx, g):
        feats, projs, lo, step = ctx.saved_tensors
        dfeats = warp_variance_bwd(feats, projs, lo, step, g.contiguous())
        return dfeats, None, None, None, None


def warp_variance_train(feats: torch.Tensor, projs: torch.Tensor,
                        lo: torch.Tensor, step: torch.Tensor,
                        ndepth: int) -> torch.Tensor:
    """`warp_variance` with K6 as its backward (differentiable in feats)."""
    return _WarpVariance.apply(feats, projs, lo, step, ndepth)
