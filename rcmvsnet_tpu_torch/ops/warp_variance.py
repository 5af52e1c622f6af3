"""K1: fused plane-sweep warp + multi-view variance.

`warp_variance` launches the CUDA kernel `csrc/warp_variance.cu` for a
CUDA tensor; for a CPU tensor it returns `warp_variance_plain`, the same
function in plain PyTorch (`ops/warp.plane_sweep_variance` on the
[D, h, w] hypothesis volume built from (lo, step)).

Replaces the TPU kernel `rcmvsnet_tpu/ops/pallas_warp2.py`
`plane_sweep_variance_lanes` (planes mode). The TPU kernel's VMEM
residency, band ladder and coverage counter are not ported: the Hopper
kernel samples straight from device memory and has no such precondition.
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


def _lib():
    fn = _build.load("warp_variance").warp_variance_f32
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def warp_variance(feats: torch.Tensor, projs: torch.Tensor,
                  lo: torch.Tensor, step: torch.Tensor,
                  ndepth: int) -> torch.Tensor:
    """Same contract as `warp_variance_plain`; the kernel on a CUDA tensor."""
    if feats.device.type == "cpu":
        return warp_variance_plain(feats, projs, lo, step, ndepth)
    V, h, w, C = feats.shape
    if C not in CHANNELS or not 1 <= V <= MAX_VIEWS:
        raise ValueError(f"warp_variance: C in {CHANNELS} and 1 <= V <= "
                         f"{MAX_VIEWS}, got V={V} C={C}")
    if lo.shape != (h, w) or step.shape != (h, w):
        raise ValueError(f"warp_variance: lo/step must be {(h, w)}")
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
