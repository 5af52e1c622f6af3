"""Gaussian-uniform ray sampling and the neural-volume / color-volume
lookups of the render branch.

Counterpart of `rcmvsnet_tpu/render/rays.py:41-113,173-198`. The random
draws are split from the deterministic rest so that a caller (or a test)
can inject them: `draw_rays` makes (xs, ys, normal, uniform) from a
`torch.Generator`, `sample_rays` is a pure function of them.

The reference pairs the i-th source image with the i-th camera of the full
view list (image of view i+1 sampled with the camera of view i);
`build_color_volume`'s caller reproduces that pairing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.geometry import world_to_ndc
from ..ops.sampling import grid_sample_2d, grid_sample_3d


class RayDraws(NamedTuple):
    """Random draws of one sample's rays."""
    xs: torch.Tensor        # [N] int64 pixel columns
    ys: torch.Tensor        # [N] int64 pixel rows
    normal: torch.Tensor    # [N, S] standard normal
    uniform: torch.Tensor   # [N - N//2, S] U[0, 1)


class RayBatch(NamedTuple):
    pts_world: torch.Tensor     # [N, S, 3]
    dirs_world: torch.Tensor    # [N, 3] unnormalized (‖d‖ = cos angle)
    target_rgb: torch.Tensor    # [N, 3]
    ndc: torch.Tensor           # [N, S, 3] in [0, 1]
    z_vals: torch.Tensor        # [N, S]
    origin: torch.Tensor        # [N, 3]
    pseudo_depth: torch.Tensor  # [N]


def draw_rays(generator: torch.Generator, height: int, width: int,
              n_rays: int, n_samples: int) -> RayDraws:
    """The draws `sample_rays` consumes, on the generator's device."""
    dev = generator.device
    xs = torch.randint(0, width, (n_rays,), generator=generator, device=dev)
    ys = torch.randint(0, height, (n_rays,), generator=generator, device=dev)
    normal = torch.randn(n_rays, n_samples, generator=generator, device=dev)
    uniform = torch.rand(n_rays - n_rays // 2, n_samples,
                         generator=generator, device=dev)
    return RayDraws(xs, ys, normal, uniform)


def sample_rays(draws: RayDraws, imgs: torch.Tensor,
                pseudo_depth: torch.Tensor, w2cs: torch.Tensor,
                c2ws: torch.Tensor, intrinsics: torch.Tensor,
                near_fars: torch.Tensor) -> RayBatch:
    """Rays through the drawn reference pixels with depth candidates
    N(pseudo-depth, min(|far−d|, |d−near|)/3), sorted per ray; the second
    half of the rays is overwritten with stratified-uniform near→far
    samples. imgs [V, H, W, 3] un-normalized; pseudo_depth [H, W];
    w2cs / c2ws [V, 4, 4]; intrinsics [V, 3, 3]; near_fars [V, 2]."""
    V, H, W, _ = imgs.shape
    xs, ys = draws.xs.to(imgs.device), draws.ys.to(imgs.device)
    n_rays, n_samples = draws.normal.shape
    xf, yf = xs.float(), ys.float()
    intr, c2w = intrinsics[0], c2ws[0]
    dirs = torch.stack([(xf - intr[0, 2]) / intr[0, 0],
                        (yf - intr[1, 2]) / intr[1, 1],
                        torch.ones_like(xf)], dim=-1)         # [N, 3]
    rays_d = torch.matmul(dirs, c2w[:3, :3].T)
    rays_o = c2w[:3, 3][None].expand(n_rays, 3)
    target_rgb = imgs[0][ys, xs]
    rays_depth = pseudo_depth[ys, xs]
    near, far = near_fars[0, 0], near_fars[0, 1]

    std = torch.minimum((far - rays_depth).abs(),
                        (rays_depth - near).abs()) / 3.0
    gauss = rays_depth[:, None] + std[:, None] * draws.normal.to(imgs.device)
    gauss = torch.sort(gauss, dim=-1).values

    half = n_rays // 2
    n_uni = n_rays - half
    t = torch.linspace(0.0, 1.0, n_samples, device=imgs.device)[None]
    uniform = (near * (1.0 - t) + far * t).expand(n_uni, n_samples)
    mids = 0.5 * (uniform[:, 1:] + uniform[:, :-1])
    upper = torch.cat([mids, uniform[:, -1:]], dim=-1)
    lower = torch.cat([uniform[:, :1], mids], dim=-1)
    stratified = lower + (upper - lower) * draws.uniform.to(imgs.device)
    z_vals = torch.cat([gauss[:half], stratified], dim=0)

    pts = rays_o[:, None] + z_vals[..., None] * rays_d[:, None]
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=imgs.device)
    ndc = world_to_ndc(pts, w2cs[0], intrinsics[0], inv_scale, near, far)
    return RayBatch(pts, rays_d, target_rgb, ndc, z_vals, rays_o,
                    rays_depth)


def index_point_feature(volume: torch.Tensor,
                        ndc: torch.Tensor) -> torch.Tensor:
    """Trilinear neural-volume lookup at ray NDC coordinates.
    volume [C, D, H, W]; ndc [N, S, 3] in [0, 1] ordered (x, y, z).
    Returns [N, S, C] (grid = 2·ndc − 1, align_corners=True, zeros)."""
    grid = ndc * 2.0 - 1.0
    return grid_sample_3d(volume[None], grid[None, ..., 0],
                          grid[None, ..., 1], grid[None, ..., 2])[0]


def build_color_volume(pts_world: torch.Tensor, imgs_src: torch.Tensor,
                       w2cs: torch.Tensor, intrinsics: torch.Tensor,
                       img_wh) -> torch.Tensor:
    """Per-view (r, g, b, in-bounds mask) at the sample points.
    pts_world [N, S, 3]; imgs_src [V', H, W, 3]; w2cs / intrinsics
    [V', 4, 4] / [V', 3, 3] (the cameras used for the projection). Colors
    use border padding; masks are (grid > −1) & (grid < 1). Returns
    [N, S, 4·V']."""
    W, H = img_wh
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=pts_world.device)
    feats = []
    for i in range(imgs_src.shape[0]):
        ndc = world_to_ndc(pts_world, w2cs[i], intrinsics[i], inv_scale,
                           near=2.0, far=6.0)
        grid = ndc[..., :2] * 2.0 - 1.0
        color = grid_sample_2d(imgs_src[i][None], grid[None, ..., 0],
                               grid[None, ..., 1], padding_mode="border")[0]
        inside = (grid > -1.0) & (grid < 1.0)
        in_mask = (inside[..., 0] & inside[..., 1]).to(color.dtype)
        feats.append(torch.cat([color, in_mask[..., None]], dim=-1))
    return torch.cat(feats, dim=-1)
