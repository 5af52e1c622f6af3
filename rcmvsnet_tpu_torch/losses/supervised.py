"""Supervised depth loss and metrics, for validation and monitoring only
(training itself is unsupervised). Counterparts of
`rcmvsnet_tpu/losses/supervised.py`: `cas_mvsnet_loss`, the stages'
weighted masked smooth-L1; the metrics are per-image means over the masked
pixels, NaN for an image whose mask is empty. With a process group the
loss is the global batch's masked mean
(`parallel/mesh.global_masked_mean`)."""
from __future__ import annotations

import torch

from ..ops.image import masked_mean, smooth_l1
from ..parallel.mesh import global_masked_mean


def cas_mvsnet_loss(outputs, depth_gt_ms, mask_ms, dlossw=(0.5, 1.0, 2.0),
                    group=None):
    """Σ_k dlossw[k]·smooth-L1(est_k[mask], gt_k[mask]); also returns the
    last stage's unweighted loss (the reference's `depth_loss`)."""
    total = 0.0
    depth_loss = 0.0
    for stage_idx in range(len(dlossw)):
        key = f"stage{stage_idx + 1}"
        est = outputs[key]["depth"]
        gt = depth_gt_ms[key]
        mask = mask_ms[key] > 0.5
        depth_loss = global_masked_mean(smooth_l1(est, gt), mask, group)
        total = total + dlossw[stage_idx] * depth_loss
    return total, depth_loss


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
