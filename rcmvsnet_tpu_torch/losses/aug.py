"""Data-augmentation consistency loss: a second, occluded pass of the
backbone regressed against the first pass's detached depth.

Counterpart of `rcmvsnet_tpu/losses/aug.py`. The rectangle origin of
`random_image_mask` is an explicit input ([B, 2] integer (x0, y0)), drawn
by `draw_mask_origins` from a `torch.Generator` unless the caller gives it
(the tests hand in the JAX step's own draws).
"""
from __future__ import annotations

import torch

from ..ops.image import masked_mean, smooth_l1
from ..ops.sampling import resize_nearest
from .unsup import STAGE_DOWNSCALE


def draw_mask_origins(generator: torch.Generator, batch: int, height: int,
                      width: int, filter_hw) -> torch.Tensor:
    """[B, 2] (x0, y0) with x0 ∈ [0, W − fw), y0 ∈ [0, H − fh)."""
    fh, fw = filter_hw
    dev = generator.device
    x0 = torch.randint(0, width - fw, (batch,), generator=generator,
                       device=dev)
    y0 = torch.randint(0, height - fh, (batch,), generator=generator,
                       device=dev)
    return torch.stack([x0, y0], dim=1)


def random_image_mask(img: torch.Tensor, filter_hw, origins: torch.Tensor):
    """Zero one (fh, fw) rectangle per sample, at origins[b] = (x0, y0).
    img [B, H, W, C]. Returns (masked img, filter_mask [B, H, W, C] with 0
    inside the hole)."""
    fh, fw = filter_hw
    B, H, W, C = img.shape
    origins = origins.to(img.device)
    xs = torch.arange(W, device=img.device)
    ys = torch.arange(H, device=img.device)
    x0 = origins[:, 0, None, None]
    y0 = origins[:, 1, None, None]
    inside = ((ys[None, :, None] >= y0) & (ys[None, :, None] < y0 + fh)
              & (xs[None, None, :] >= x0) & (xs[None, None, :] < x0 + fw))
    fm = torch.where(inside, 0.0, 1.0).to(img.dtype)[..., None]
    fm = fm.expand(B, H, W, C)
    return img * fm, fm


def aug_loss_multi_stage(outputs, pseudo_depth, filter_mask,
                         dlossw=(0.5, 1.0, 2.0)):
    """Σ_k dlossw[k] · smooth-L1(depth_k, pseudo-depth ↓k) over the
    unmasked pixels. pseudo_depth [B, H, W]; filter_mask [B, H, W, C]."""
    total = 0.0
    scalars = {}
    pseudo = pseudo_depth[..., None]
    B, H, W, _ = pseudo.shape
    for stage_idx in range(len(dlossw)):
        key = f"stage{stage_idx + 1}"
        s = STAGE_DOWNSCALE[stage_idx]
        pseudo_t = resize_nearest(pseudo, H // s, W // s)[..., 0]
        mask = resize_nearest(filter_mask, H // s, W // s)[..., 0] > 0.5
        loss = masked_mean(smooth_l1(outputs[key]["depth"], pseudo_t), mask)
        total = total + dlossw[stage_idx] * loss
        scalars[f"aug_loss_{key}"] = loss
    return total, scalars


def adjust_w_aug(epoch_idx: int, w_aug: float) -> float:
    """Double w_aug at epochs ≥ 1, 3, 5, 7, 9."""
    for threshold in (2, 4, 6, 8, 10):
        if epoch_idx >= threshold - 1:
            w_aug *= 2
    return w_aug
