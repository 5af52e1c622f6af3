"""Ray-space losses and metrics of the render branch (counterpart of
`rcmvsnet_tpu/losses/rays.py`)."""
from __future__ import annotations

import math

import torch

from ..ops.image import masked_mean, smooth_l1


def sl1_loss(depth_pred, depth_gt, mask=None):
    """Masked smooth-L1 × 0.5 on rays."""
    if mask is None:
        mask = depth_gt > 0
    return masked_mean(smooth_l1(depth_pred, depth_gt), mask) * 0.5


def img2mse(pred, target):
    return ((pred - target) ** 2).mean()


def mse2psnr(mse):
    return -10.0 * torch.log(mse) / math.log(10.0)


def abs_error(depth_pred, depth_gt, mask):
    return masked_mean((depth_pred - depth_gt).abs(), mask)


def acc_threshold(depth_pred, depth_gt, mask, threshold):
    """Share of masked rays with |err| < threshold."""
    ok = ((depth_pred - depth_gt).abs() < threshold).float()
    return masked_mean(ok, mask)
