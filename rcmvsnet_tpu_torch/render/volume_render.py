"""Volumetric compositing: σ → alpha → transmittance-weighted rgb and
depth (counterpart of `rcmvsnet_tpu/render/volume_render.py`)."""
from __future__ import annotations

from typing import NamedTuple

import torch


def depth2dist(z_vals: torch.Tensor, cos_angle: torch.Tensor):
    """Inter-sample distances ·‖ray dir‖ with a 1e10 sentinel tail.
    z_vals [N, S]; cos_angle [N]. Returns [N, S]."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    return dists * cos_angle[..., None]


class RenderOutput(NamedTuple):
    rgb: torch.Tensor      # [N, 3]
    depth: torch.Tensor    # [N]
    weights: torch.Tensor  # [N, S]
    alpha: torch.Tensor    # [N, S]
    acc: torch.Tensor      # [N]


def volumetric_render(raw: torch.Tensor, z_vals: torch.Tensor,
                      dists: torch.Tensor) -> RenderOutput:
    """raw [N, S, 4] = (rgb, σ); alpha = 1 − exp(−σ) (the reference ignores
    dists here); T = exclusive ∏(1 − α + 1e−10)."""
    rgb = raw[..., :3]
    alpha = 1.0 - torch.exp(-raw[..., 3])
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    weights = alpha * trans
    rgb_map = (weights[..., None] * rgb).sum(-2)
    depth_map = (weights * z_vals).sum(-1)
    return RenderOutput(rgb_map, depth_map, weights, alpha, weights.sum(-1))
