"""Image-space ops of the self-supervised losses: 3×3 average-pool SSIM,
edge-aware depth smoothness, finite-difference gradients, smooth-L1 and a
masked mean.

Counterparts of `rcmvsnet_tpu/ops/image.py`. Tensors are channels-last
([B, H, W, C]) at these functions, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def avg_pool_2d(x: torch.Tensor, window: int = 3,
                stride: int = 1) -> torch.Tensor:
    """VALID average pool over H, W of an NHWC tensor."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def ssim(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """Masked SSIM distance map: mask_pooled · clip((1−SSIM)/2, 0, 1).
    x, y [B, H, W, C]; mask [B, H, W, 1] → [B, H-2, W-2, C]."""
    mu_x = avg_pool_2d(x)
    mu_y = avg_pool_2d(y)
    sigma_x = avg_pool_2d(x * x) - mu_x * mu_x
    sigma_y = avg_pool_2d(y * y) - mu_y * mu_y
    sigma_xy = avg_pool_2d(x * y) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return avg_pool_2d(mask) * torch.clamp((1 - ssim_n / ssim_d) / 2, 0, 1)


def gradient_x(img: torch.Tensor) -> torch.Tensor:
    """img[:, :, :-1] − img[:, :, 1:] over width."""
    return img[:, :, :-1, :] - img[:, :, 1:, :]


def gradient_y(img: torch.Tensor) -> torch.Tensor:
    """img[:, :-1] − img[:, 1:] over height."""
    return img[:, :-1, :, :] - img[:, 1:, :, :]


def gradient(pred: torch.Tensor):
    """(dx, dy) forward differences, the sign opposite to gradient_x/_y
    (the reference keeps both conventions; the reconstruction loss uses
    this one)."""
    d_dy = pred[:, 1:, :, :] - pred[:, :-1, :, :]
    d_dx = pred[:, :, 1:, :] - pred[:, :, :-1, :]
    return d_dx, d_dy


def depth_smoothness(depth: torch.Tensor, img: torch.Tensor,
                     lambda_wt: float = 1.0) -> torch.Tensor:
    """Edge-aware first-order smoothness mean|∇d·exp(−λ·mean|∇I|)|.
    depth [B, H, W, 1]; img [B, H, W, C]. Scalar."""
    weights_x = torch.exp(-lambda_wt * gradient_x(img).abs().mean(
        3, keepdim=True))
    weights_y = torch.exp(-lambda_wt * gradient_y(img).abs().mean(
        3, keepdim=True))
    return ((gradient_x(depth) * weights_x).abs().mean()
            + (gradient_y(depth) * weights_y).abs().mean())


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (beta 1), before any reduction."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Σ v·m / max(Σ m, 1e-10): the mean over the masked entries."""
    mask = mask.to(values.dtype)
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1e-10)
