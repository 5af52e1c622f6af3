"""Sampling primitives with the JAX package's conventions, in PyTorch.

Counterparts of `rcmvsnet_tpu/ops/sampling.py`. Layouts stay channels-last
at these public functions (images [B, H, W, C]), as in the JAX package, so
the tests compare like with like.

  * `grid_sample_2d`: bilinear, zeros padding per tap (or border
    clamping), **align_corners=True** (`F.grid_sample` defaults to False);
  * `grid_sample_3d`: trilinear, zeros padding, align_corners=True;
  * `loss_bilinear_sample`: the photometric loss's hand-rolled sampler
    with its validity mask (`:128` there);
  * `resize_bilinear` / `resize_trilinear`: torch-interpolate (bi/tri)linear,
    separable, with either align_corners convention;
  * `resize_nearest`: torch legacy nearest, src = floor(i·in/out).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample img at normalized coords (align_corners=True;
    'zeros' drops each out-of-image tap, 'border' clamps).

    img: [B, H, W, C]; x, y: [B, *S] in [-1, 1]. Returns [B, *S, C]."""
    B, H, W, C = img.shape
    sample_shape = x.shape[1:]
    grid = torch.stack([x.reshape(B, -1), y.reshape(B, -1)], dim=-1)
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid[:, :, None, :],
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=True)                  # [B, C, N, 1]
    return out[..., 0].permute(0, 2, 1).reshape(B, *sample_shape, C)


def grid_sample_3d(vol: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """Trilinear sample at normalized coords (align_corners=True, zeros
    padding per tap).

    vol: [B, C, D, H, W] (channels first: the neural volume's layout);
    x→W, y→H, z→D each [B, *S] in [-1, 1]. Returns [B, *S, C]."""
    B, C = vol.shape[:2]
    sample_shape = x.shape[1:]
    grid = torch.stack([x.reshape(B, -1), y.reshape(B, -1),
                        z.reshape(B, -1)], dim=-1)            # [B, N, 3]
    out = F.grid_sample(vol, grid[:, :, None, None, :], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[..., 0, 0].permute(0, 2, 1).reshape(B, *sample_shape, C)


def loss_bilinear_sample(img: torch.Tensor, px: torch.Tensor,
                         py: torch.Tensor):
    """The photometric loss's sampler and validity mask.

    img [B, H, W, C]; px, py [B, H', W'] normalized to [-1, 1]. Returns
    (sampled [B, H', W', C], mask [B, H', W', 1]). The mask is the
    reference's (x0 >= 0) & (x1 <= W-1) & (y0 >= 0) & (y0 <= H-1) (y1 is
    not range-checked); taps are clamped before gathering. Differentiable
    in px, py (the depth's gradient path)."""
    B, H, W, C = img.shape
    out_shape = px.shape
    x = (px.reshape(B, -1) + 1.0) * (W - 1.0) / 2.0
    y = (py.reshape(B, -1) + 1.0) * (H - 1.0) / 2.0
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1, y1 = x0 + 1, y0 + 1
    mask = ((x0 >= 0) & (x1 <= W - 1) & (y0 >= 0)
            & (y0 <= H - 1)).to(img.dtype)
    x0c, x1c = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
    y0c, y1c = y0.clamp(0, H - 1), y1.clamp(0, H - 1)
    flat = img.reshape(B, H * W, C)
    tap = lambda yi, xi: torch.gather(
        flat, 1, (yi * W + xi)[..., None].expand(-1, -1, C))
    pa, pb = tap(y0c, x0c), tap(y1c, x0c)
    pc, pd = tap(y0c, x1c), tap(y1c, x1c)
    x1f, y1f = x1.to(img.dtype), y1.to(img.dtype)
    wa = ((x1f - x) * (y1f - y))[..., None]
    wb = ((x1f - x) * (1.0 - (y1f - y)))[..., None]
    wc = ((1.0 - (x1f - x)) * (y1f - y))[..., None]
    wd = ((1.0 - (x1f - x)) * (1.0 - (y1f - y)))[..., None]
    out = wa * pa + wb * pb + wc * pc + wd * pd
    return (out.reshape(B, *out_shape[1:], C),
            mask.reshape(B, *out_shape[1:], 1))


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


def resize_trilinear(x: torch.Tensor, depth: int, height: int, width: int,
                     align_corners: bool = False) -> torch.Tensor:
    """x: [..., D, H, W, C] → [..., depth, height, width, C]."""
    x = _resize_axis(x, x.ndim - 4, depth, "linear", align_corners)
    return resize_bilinear(x, height, width, align_corners)


def resize_axis_linear(x: torch.Tensor, axis: int, size: int,
                       align_corners: bool = False) -> torch.Tensor:
    """Linear resize of one axis (the neural volume's plane axis)."""
    return _resize_axis(x, axis, size, "linear", align_corners)


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x: [..., H, W, C] → [..., height, width, C] (torch 'nearest')."""
    x = _resize_axis(x, x.ndim - 3, height, "nearest", False)
    return _resize_axis(x, x.ndim - 2, width, "nearest", False)
