"""Plane-sweep homography warp and the multi-view variance cost volume.

Counterparts of `rcmvsnet_tpu/ops/warp.py:22-101`, and the plain versions
of the warp kernels (`ops/warp_variance.py`, `ops/warp_volume.py`).
`homo_warp` warps features or images alike; the sampling grid carries no
gradient, the warped tensor does (through `F.grid_sample`). Views stream through
running Σx / Σx² accumulators in float32; the reference view is broadcast
over the depth axis.
"""
from __future__ import annotations

import torch

from ..core.geometry import project_to_grid, relative_projection
from .sampling import grid_sample_2d


def homo_warp(src_feat: torch.Tensor, src_proj: torch.Tensor,
              ref_proj: torch.Tensor,
              depth_values: torch.Tensor) -> torch.Tensor:
    """Warp src features into the ref view at every depth hypothesis.

    src_feat: [B, H, W, C]; src_proj/ref_proj: [B, 4, 4] (K-folded);
    depth_values: [B, D] or [B, D, H, W]. Returns [B, D, H, W, C]."""
    B, H, W, C = src_feat.shape
    D = depth_values.shape[1]
    with torch.no_grad():
        proj = relative_projection(src_proj, ref_proj)
        x, y = project_to_grid(proj, depth_values, H, W)
    return grid_sample_2d(src_feat, x, y).reshape(B, D, H, W, C)


def plane_sweep_variance(ref_feat: torch.Tensor, src_feats, src_projs,
                         ref_proj: torch.Tensor,
                         depth_values: torch.Tensor) -> torch.Tensor:
    """Biased variance E[x²] − E[x]² over {ref} ∪ {warped srcs}.

    ref_feat: [B, H, W, C]; src_feats / src_projs: lists of [B, H, W, C] /
    [B, 4, 4]; depth_values: [B, D] or [B, D, H, W].
    Returns [B, D, H, W, C] in the features' dtype."""
    B, H, W, C = ref_feat.shape
    D = depth_values.shape[1]
    num_views = len(src_feats) + 1
    ref_volume = ref_feat[:, None].expand(B, D, H, W, C).float()
    vol_sum = ref_volume
    vol_sq_sum = ref_volume * ref_volume
    for src_feat, src_proj in zip(src_feats, src_projs):
        wf = homo_warp(src_feat, src_proj, ref_proj, depth_values).float()
        vol_sum = vol_sum + wf
        vol_sq_sum = vol_sq_sum + wf * wf
    mean = vol_sum / num_views
    variance = vol_sq_sum / num_views - mean * mean
    return variance.to(ref_feat.dtype)


def plane_sweep_variance_no_ref(warped_srcs) -> torch.Tensor:
    """Variance over the warped source volumes only, divided by the FULL
    view count V = len(warped_srcs) + 1 — the reference's `no_ref`
    bookkeeping (its sum excludes the reference view, its divisor does
    not). warped_srcs: list of [B, D, H, W, C]."""
    num_views = len(warped_srcs) + 1
    vol_sum = 0.0
    vol_sq_sum = 0.0
    for w in warped_srcs:
        wf = w.float()
        vol_sum = vol_sum + wf
        vol_sq_sum = vol_sq_sum + wf * wf
    mean = vol_sum / num_views
    return (vol_sq_sum / num_views - mean * mean).to(warped_srcs[0].dtype)
