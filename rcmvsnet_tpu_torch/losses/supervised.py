"""Supervised depth metrics, for monitoring only (counterpart of the
metric half of `rcmvsnet_tpu/losses/supervised.py`): per-image means over
the masked pixels, NaN for an image whose mask is empty."""
from __future__ import annotations

import torch


def _masked_mean_or_nan(x, mask):
    m = mask.to(x.dtype)
    cnt = m.sum()
    return torch.where(cnt > 0, (x * m).sum() / torch.clamp(cnt, min=1.0),
                       torch.full_like(cnt, float("nan")))


def thres_metric(depth_est, depth_gt, mask, thres):
    """Mean over images of the share of masked pixels with error > thres."""
    err = ((depth_est - depth_gt).abs() > thres).float()
    return torch.stack([_masked_mean_or_nan(e, m)
                        for e, m in zip(err, mask)]).mean()


def abs_depth_error_metric(depth_est, depth_gt, mask):
    """Mean over images of the mean |error| over masked pixels."""
    err = (depth_est - depth_gt).abs()
    return torch.stack([_masked_mean_or_nan(e, m)
                        for e, m in zip(err, mask)]).mean()
