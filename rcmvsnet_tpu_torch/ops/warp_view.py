"""K10: one source view's warped feature volume, and the plane-sweep
variance built from such volumes.

`warp_view` launches the CUDA kernel `csrc/warp_view.cu` for a CUDA tensor;
for a CPU tensor it returns `warp_view_plain`, the same function through
`ops/sampling.grid_sample_2d`. `plane_sweep_variance_views` sums the
per-view volumes into the variance, which is K1's function computed view
by view (the JAX package does that sum in XLA, outside its kernel).

Replaces `rcmvsnet_tpu/ops/pallas_warp.py` `_pixel_coords` (`:139`),
`warp_volume_pallas` (`:88`, its `pallas_call` at `:109`) and
`plane_sweep_variance_fast` (`:194`). The TPU kernel's y-band, and the
`check_band_coverage` precondition that guards it, are not ported: the
Hopper kernel gathers its taps from device memory and needs no band.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .sampling import grid_sample_2d
from .warp_variance import relative_projections


def pixel_coords(proj: torch.Tensor, depth_values: torch.Tensor, h: int,
                 w: int):
    """Pixel-space sample coordinates of one source view.

    proj [B, 4, 4] relative projection (src @ inv(ref), K folded in);
    depth_values [B, D, h, w]. Returns px, py [B, D, h, w]:
    (X/Z, Y/Z) of rot·[x, y, 1]·dv + t with |Z| floored at 1e-6 (sign
    kept), px clipped to [-2, w+1] and py to [-2, h+1], where every
    out-of-image sample reads zero anyway. Each operation rounds on its
    own, in the order of K1's `warp::project` (`csrc/warp_common.cuh`), so
    on the card these coordinates are K1's bit for bit."""
    dv = depth_values.float()
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=proj.device),
        torch.arange(w, dtype=torch.float32, device=proj.device),
        indexing="ij")
    m = proj.float()[..., None, None]                      # [B, 4, 4, 1, 1]

    def row(i):
        r = (m[:, i, 0] * xs + m[:, i, 1] * ys) + m[:, i, 2]   # [B, h, w]
        return r[:, None] * dv + m[:, i, 3][:, None]           # [B, D, h, w]

    X, Y, Z = row(0), row(1), row(2)
    eps = torch.where(Z < 0, torch.full_like(Z, -1e-6),
                      torch.full_like(Z, 1e-6))
    Z = torch.where(Z.abs() < 1e-6, eps, Z)
    return (X / Z).clamp(-2.0, w + 1.0), (Y / Z).clamp(-2.0, h + 1.0)


def warp_view_plain(src: torch.Tensor, px: torch.Tensor,
                    py: torch.Tensor) -> torch.Tensor:
    """src [h, w, C] sampled at px, py [D, h, w] (pixels; bilinear, zeros
    padding per tap) → [D, h, w, C] float32.

    `grid_sample_2d` takes coordinates normalized to [-1, 1]; the
    pixel → normalized → pixel round trip runs in float64 so that it moves
    no sample (in float32 it moves one by up to an ulp of px, which shifts
    a value by that much of its neighbours' difference)."""
    h, w, _ = src.shape
    x = px.double() / ((w - 1) / 2.0) - 1.0
    y = py.double() / ((h - 1) / 2.0) - 1.0
    return grid_sample_2d(src.double()[None], x[None], y[None])[0].float()


def _lib():
    fn = _build.load("warp_view").warp_view_f32
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def warp_view(src: torch.Tensor, px: torch.Tensor,
              py: torch.Tensor) -> torch.Tensor:
    """K10, replacing `rcmvsnet_tpu/ops/pallas_warp.py:88`
    `warp_volume_pallas`: the contract of `warp_view_plain` (any C), the
    kernel on a CUDA tensor. The JAX kernel returns [D, h, C, W]; this
    returns [D, h, W, C], the layout its caller moves it to."""
    if src.device.type == "cpu":
        return warp_view_plain(src, px, py)
    h, w, C = src.shape
    D = px.shape[0]
    if px.shape != (D, h, w) or py.shape != px.shape:
        raise ValueError(f"warp_view: px {tuple(px.shape)} / py "
                         f"{tuple(py.shape)} must both be [D, {h}, {w}]")
    if D > 65535 or (h + 2) * (w + 2) * C > 2**31 - 1:
        raise ValueError(f"warp_view: D={D} planes or a [{h}, {w}, {C}] "
                         f"map is past the kernel's grid or its 32-bit "
                         f"tap offsets")
    _build.require_cuda("warp_view", src, px, py)
    out = torch.empty((D, h, w, C), dtype=torch.float32, device=src.device)
    err = _lib()(src.data_ptr(), px.data_ptr(), py.data_ptr(),
                 out.data_ptr(), h, w, C, D, _build.stream_ptr(src.device))
    _build.check(err, "warp_view")
    warp_view.launches += 1
    return out


warp_view.launches = 0


def plane_sweep_variance_views(ref_feat: torch.Tensor, src_feats, src_projs,
                               ref_proj: torch.Tensor,
                               depth_values: torch.Tensor) -> torch.Tensor:
    """Variance cost volume from one warped volume per source view.

    ref_feat [B, h, w, C]; src_feats / src_projs: lists of [B, h, w, C] /
    [B, 4, 4]; ref_proj [B, 4, 4]; depth_values [B, D, h, w]. Returns
    [B, D, h, w, C] float32.
    The reference is broadcast over D; Σx and Σx² run over the views in
    float32 and var = Σx²·(1/V) − (Σx·(1/V))², in the order K1 takes, so
    on the card this is K1's (`ops/warp_variance.warp_variance`) variance
    given the same hypotheses (held to 1e-5 of its largest value)."""
    B, h, w, C = ref_feat.shape
    D = depth_values.shape[1]
    inv_v = 1.0 / (len(src_feats) + 1)
    out = []
    for b in range(B):
        rel = relative_projections(torch.stack(
            [ref_proj[b]] + [p[b] for p in src_projs])).reshape(-1, 4, 4)
        vol_sum = ref_feat[b].float()[None].expand(D, h, w, C)
        vol_sq = vol_sum * vol_sum
        for v, src in enumerate(src_feats, start=1):
            px, py = pixel_coords(rel[v:v + 1], depth_values[b:b + 1], h, w)
            warped = warp_view(src[b].float().contiguous(), px[0].contiguous(),
                          py[0].contiguous())
            vol_sum = vol_sum + warped
            vol_sq = vol_sq + warped * warped
        mean = vol_sum * inv_v
        out.append(vol_sq * inv_v - mean * mean)
    return torch.stack(out)
