"""Rendering-consistency branch: neural volume + NeRF MLP, supervised by
ray colors and the backbone's pseudo-depth.

Counterpart of `rcmvsnet_tpu/models/render_net.py`
(`RenderingConsistencyNet`, `ray_major_lookup` off):
positional encoding (MULTIRES = 10) of the NDC sample points, raw view
directions, per-sample features = VOLUME_CHANNELS = 8 neural-volume
channels + 4 per paired source view (color, in-bounds mask), the 6×128
MLP of `nn/mlp.py` picked by `net_type`: 'v0' `NerfMLP` (multiplicative
conditioning), 'v1' `AttentionNerfMLP` (its extra color-prior channels
are ignored by the compositor), 'v2' `NerfMLP` (additive). The
per-sample work runs batched over
all rays × samples; the batch axis is a loop (B = 1 on the train path).

`train_dtype` (`BackboneConfig.train_dtype`): the neural volume's resize
and U-Net run in that dtype (`nn/neural_volume.py`); everything else here
is float32. `remat`: the neural volume's U-Net is rematerialized in the
backward (`nn/neural_volume.py`; JAX `models/render_net.py:70,94`).

Parameter names are the reference's `*_nerf.ckpt` names:
`MVSNet.cost_reg_2.*` (the neural-volume U-Net) and `network_fn.nerf.*`
(the MLP). The random draws of each sample's rays are an input
(`render/rays.RayDraws`), made by the caller.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..nn.costreg import RenderCostReg
from ..nn.mlp import AttentionNerfMLP, NerfMLP, positional_encoding
from ..nn.neural_volume import neural_volume
from ..render.rays import (build_color_volume, index_point_feature,
                           sample_rays)
from ..render.volume_render import depth2dist, volumetric_render

MULTIRES = 10           # frequencies of the points' positional encoding
VOLUME_CHANNELS = 8     # channels of the neural volume
N_COLOR_VIEWS = 3       # source views whose colors each sample reads


def unpreprocess(imgs: torch.Tensor) -> torch.Tensor:
    """Invert the ImageNet normalization ([..., 3] channels-last)."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=imgs.dtype,
                           device=imgs.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=imgs.dtype, device=imgs.device)
    return imgs * std + mean


class RenderResult(NamedTuple):
    rgb: torch.Tensor          # [B, N, 3]
    depth: torch.Tensor        # [B, N]
    target_rgb: torch.Tensor   # [B, N, 3]
    rays_depth: torch.Tensor   # [B, N] pseudo-depth supervision
    weights: torch.Tensor      # [B, N, S]
    alpha: torch.Tensor        # [B, N, S]


class RenderingConsistencyNet(nn.Module):
    def __init__(self, volume_in_channels: int, num_planes: int = 128,
                 net_type: str = "v0",
                 train_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.num_planes = num_planes
        self.train_dtype = train_dtype
        self.remat = remat
        self.MVSNet = nn.ModuleDict({"cost_reg_2": RenderCostReg(
            volume_in_channels, VOLUME_CHANNELS)})
        kw = dict(in_ch_pts=3 + 6 * MULTIRES,
                  in_ch_feat=VOLUME_CHANNELS + 4 * N_COLOR_VIEWS)
        if net_type == "v1":
            nerf = AttentionNerfMLP(**kw)
        elif net_type in ("v0", "v2"):
            nerf = NerfMLP(**kw, bias_mode=("add" if net_type == "v2"
                                            else "multiply"))
        else:
            raise ValueError(f"net_type {net_type!r}: v0, v1 or v2")
        self.network_fn = nn.ModuleDict({"nerf": nerf})

    def forward(self, volume_feature, pseudo_depth, imgs, w2cs, c2ws,
                intrinsics, near_fars, draws, plain: bool = False):
        """volume_feature [B, 3(V−1)+C, D0, h, w] (the stage-1 no-ref
        volume, not detached); pseudo_depth [B, H, W] (detached); imgs
        [B, V, H, W, 3] ImageNet-normalized; w2cs / c2ws [B, V, 4, 4];
        intrinsics [B, V, 3, 3] full-res; near_fars [B, V, 2]; draws: one
        `RayDraws` per sample. `plain` runs the U-Net's convs in plain
        PyTorch instead of K8."""
        volume = neural_volume(self.MVSNet["cost_reg_2"], volume_feature,
                               self.num_planes, plain, self.train_dtype,
                               self.remat)              # [B, 8, P, h, w]
        B, V, H, W, _ = imgs.shape
        imgs_un = unpreprocess(imgs)
        nc = N_COLOR_VIEWS
        outs = []
        for b in range(B):
            rays = sample_rays(draws[b], imgs_un[b], pseudo_depth[b],
                               w2cs[b], c2ws[b], intrinsics[b], near_fars[b])
            cos_angle = torch.linalg.norm(rays.dirs_world, dim=-1)
            viewdirs = torch.matmul(rays.dirs_world / cos_angle[:, None],
                                    w2cs[b, 0, :3, :3].T)
            ray_feats = index_point_feature(volume[b], rays.ndc)
            # the reference pairs the last source images with the cameras
            # of the first views (see render/rays.py)
            color = build_color_volume(rays.pts_world, imgs_un[b, -nc:],
                                       w2cs[b, :nc], intrinsics[b, :nc],
                                       (W, H))
            feats = torch.cat([ray_feats, color], dim=-1)
            pts_enc = positional_encoding(rays.ndc, MULTIRES)
            views = viewdirs[:, None].expand(*rays.ndc.shape[:2], 3)
            raw = self.network_fn["nerf"](pts_enc, feats, views)
            out = volumetric_render(raw, rays.z_vals,
                                    depth2dist(rays.z_vals, cos_angle))
            outs.append((out.rgb, out.depth, rays.target_rgb,
                         rays.pseudo_depth, out.weights, out.alpha))
        return RenderResult(*(torch.stack(t) for t in zip(*outs)))
