"""Ray-space losses and metrics of the render branch (counterpart of
`rcmvsnet_tpu/losses/rays.py`). The masked ones take an optional process
group and then reduce over every rank's rays
(`parallel/mesh.global_masked_mean`)."""
from __future__ import annotations

import math

import torch

from ..ops.image import smooth_l1
from ..parallel.mesh import global_masked_mean


def sl1_loss(depth_pred, depth_gt, mask=None, group=None):
    """Masked smooth-L1 × 0.5 on rays."""
    if mask is None:
        mask = depth_gt > 0
    return global_masked_mean(smooth_l1(depth_pred, depth_gt), mask,
                              group) * 0.5


def img2mse(pred, target):
    return ((pred - target) ** 2).mean()


def mse2psnr(mse):
    return -10.0 * torch.log(mse) / math.log(10.0)


def abs_error(depth_pred, depth_gt, mask, group=None):
    return global_masked_mean((depth_pred - depth_gt).abs(), mask, group)


def acc_threshold(depth_pred, depth_gt, mask, threshold, group=None):
    """Share of masked rays with |err| < threshold."""
    ok = ((depth_pred - depth_gt).abs() < threshold).float()
    return global_masked_mean(ok, mask, group)
