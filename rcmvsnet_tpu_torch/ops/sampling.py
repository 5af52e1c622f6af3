"""Sampling primitives with the JAX package's conventions, in PyTorch.

Counterparts of `rcmvsnet_tpu/ops/sampling.py`. Layouts stay channels-last
at these public functions (images [B, H, W, C]), as in the JAX package, so
the tests compare like with like.

  * `grid_sample_2d`: bilinear, zeros padding per tap, **align_corners=True**
    (`F.grid_sample` defaults to False);
  * `resize_bilinear`: torch-interpolate bilinear, separable, H then W,
    with either align_corners convention;
  * `resize_nearest`: torch legacy nearest, src = floor(i·in/out).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(img: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img at normalized coords (align_corners=True,
    zeros padding).

    img: [B, H, W, C]; x, y: [B, *S] in [-1, 1]. Returns [B, *S, C]."""
    B, H, W, C = img.shape
    sample_shape = x.shape[1:]
    grid = torch.stack([x.reshape(B, -1), y.reshape(B, -1)], dim=-1)
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid[:, :, None, :],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)                  # [B, C, N, 1]
    return out[..., 0].permute(0, 2, 1).reshape(B, *sample_shape, C)


def _linear_axis_indices(in_size: int, out_size: int, align_corners: bool,
                         device):
    """Source taps and weight along one axis (torch's
    area_pixel_compute_source_index)."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        src = i * ((in_size - 1) / max(out_size - 1, 1))
    else:
        src = torch.clamp((i + 0.5) * (in_size / out_size) - 0.5, min=0.0)
    i0 = torch.clamp(torch.floor(src).long(), 0, in_size - 1)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    return i0, i1, src - i0.float()


def _resize_axis(x: torch.Tensor, axis: int, out_size: int, method: str,
                 align_corners: bool) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if method == "nearest":
        i = torch.arange(out_size, dtype=torch.float32, device=x.device)
        idx = torch.clamp(torch.floor(i * (in_size / out_size)).long(),
                          0, in_size - 1)
        return torch.index_select(x, axis, idx)
    i0, i1, w = _linear_axis_indices(in_size, out_size, align_corners,
                                     x.device)
    lo = torch.index_select(x, axis, i0)
    hi = torch.index_select(x, axis, i1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = w.reshape(shape).to(x.dtype)
    return lo * (1 - w) + hi * w


def resize_bilinear(x: torch.Tensor, height: int, width: int,
                    align_corners: bool = False) -> torch.Tensor:
    """x: [..., H, W, C] → [..., height, width, C]."""
    x = _resize_axis(x, x.ndim - 3, height, "linear", align_corners)
    return _resize_axis(x, x.ndim - 2, width, "linear", align_corners)


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x: [..., H, W, C] → [..., height, width, C] (torch 'nearest')."""
    x = _resize_axis(x, x.ndim - 3, height, "nearest", False)
    return _resize_axis(x, x.ndim - 2, width, "nearest", False)
