"""Unsupervised multi-stage photometric loss.

Counterpart of `rcmvsnet_tpu/losses/unsup.py`, with its reproduced quirks
of the reference's UnSupLoss:
  * each view's reconstruction loss is reduced to a SCALAR, then broadcast
    against the per-pixel 1e4·(1−mask) penalty, so the per-pixel top-1 over
    views picks the best view's scalar at every valid pixel;
  * SSIM accumulates over the first ≤ 2 source views only (view < 3);
  * stage images are downscaled with torch-default NEAREST interpolation.
With a process group the per-view reconstruction scalar, which the
per-pixel top-1 then uses, is the global batch's, as in JAX
(`parallel/mesh.global_mean`); the other means are each rank's own.
"""
from __future__ import annotations

import torch

from ..ops.image import depth_smoothness, gradient, smooth_l1, ssim
from ..ops.sampling import loss_bilinear_sample, resize_nearest
from ..parallel.mesh import global_mean

STAGE_DOWNSCALE = {0: 4, 1: 2, 2: 1}


def inverse_warping(img: torch.Tensor, ref_cam: torch.Tensor,
                    src_cam: torch.Tensor, depth: torch.Tensor):
    """Warp a source image into the reference view through the reference
    depth map. img [B, H, W, C] (stage resolution); ref_cam / src_cam
    [B, 2, 4, 4] ({extrinsic, intrinsic}); depth [B, H, W].
    Returns (warped [B, H, W, C], mask [B, H, W, 1])."""
    B, H, W, C = img.shape
    R_ref, t_ref = ref_cam[:, 0, :3, :3], ref_cam[:, 0, :3, 3:4]
    R_src, t_src = src_cam[:, 0, :3, :3], src_cam[:, 0, :3, 3:4]
    K_ref = ref_cam[:, 1, :3, :3]
    R_rel = torch.matmul(R_src, R_ref.transpose(1, 2))
    t_rel = t_src - torch.matmul(R_rel, t_ref)

    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=img.dtype, device=img.device),
        torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(H * W, dtype=img.dtype,
                                   device=img.device)])          # [3, HW]
    cam = (torch.einsum("bij,jn->bin", torch.linalg.inv(K_ref), grid)
           * depth.reshape(B, 1, H * W))
    cam_h = torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1)
    K_hom = torch.zeros(B, 4, 4, dtype=img.dtype, device=img.device)
    K_hom[:, :3, :3] = K_ref
    K_hom[:, 3, 3] = 1.0
    bottom = torch.tensor([0, 0, 0, 1], dtype=img.dtype,
                          device=img.device).expand(B, 1, 4)
    transform = torch.cat([torch.cat([R_rel, t_rel], dim=2), bottom], dim=1)
    proj = torch.matmul(K_hom, transform)
    pc = torch.einsum("bij,bjn->bin", proj, cam_h)
    x_src = pc[:, 0] / (pc[:, 2] + 1e-10)
    y_src = pc[:, 1] / (pc[:, 2] + 1e-10)
    px = (x_src / (W - 1) * 2.0 - 1.0).reshape(B, H, W)
    py = (y_src / (H - 1) * 2.0 - 1.0).reshape(B, H, W)
    return loss_bilinear_sample(img, px, py)


def _compute_reconstr_loss(warped, ref, mask, group=None):
    """0.5·photo smooth-L1 + 0.5·gradient smooth-L1, each mean-reduced to
    a scalar (over every rank's batch)."""
    alpha = 0.5
    ref_dx, ref_dy = gradient(ref * mask)
    warped_dx, warped_dy = gradient(warped * mask)
    photo = global_mean(smooth_l1(warped * mask, ref * mask), group)
    grad = (global_mean(smooth_l1(warped_dx, ref_dx), group)
            + global_mean(smooth_l1(warped_dy, ref_dy), group))
    return (1 - alpha) * photo + alpha * grad


def unsup_stage_loss(imgs, cams, depth, stage_idx: int, group=None):
    """Single-stage UnSupLoss. imgs [B, V, H, W, 3] per-image-normalized
    'center' images at full resolution; cams [B, V, 2, 4, 4] stage
    projection pairs; depth [B, h, w]. Returns (loss, components)."""
    B, V, H, W, _ = imgs.shape
    scale = STAGE_DOWNSCALE[stage_idx]
    h, w = H // scale, W // scale
    ref_img = resize_nearest(imgs[:, 0], h, w)
    ref_cam = cams[:, 0]
    reproj_maps = []
    ssim_loss = 0.0
    for view in range(1, V):
        view_img = resize_nearest(imgs[:, view], h, w)
        warped, mask = inverse_warping(view_img, ref_cam, cams[:, view],
                                       depth)
        reconstr = _compute_reconstr_loss(warped, ref_img, mask, group)
        reproj_maps.append(reconstr + 1e4 * (1.0 - mask))     # [B,h,w,1]
        if view < 3:
            ssim_loss = ssim_loss + ssim(ref_img, warped, mask).mean()
    smooth_loss = depth_smoothness(depth[..., None], ref_img, 1.0)
    top_vals = torch.stack(reproj_maps, dim=-1).min(dim=-1).values
    top_mask = (top_vals < 1e4).to(top_vals.dtype)
    reconstr_loss = (top_vals * top_mask).mean()
    loss = 12.0 * reconstr_loss + 6.0 * ssim_loss + 0.18 * smooth_loss
    return loss, {"reconstr_loss": reconstr_loss, "ssim_loss": ssim_loss,
                  "smooth_loss": smooth_loss}


def unsup_loss_multi_stage(outputs, imgs, proj_matrices,
                           dlossw=(0.5, 1.0, 2.0), group=None):
    """Σ_k dlossw[k] · UnSupLoss(stage k). Returns (total, scalars) with
    the JAX package's scalar names."""
    total = 0.0
    scalars = {}
    for stage_idx in range(len(dlossw)):
        key = f"stage{stage_idx + 1}"
        loss, comps = unsup_stage_loss(imgs, proj_matrices[key],
                                       outputs[key]["depth"], stage_idx,
                                       group)
        total = total + dlossw[stage_idx] * loss
        scalars[f"depth_loss_{key}"] = loss
        for name, v in comps.items():
            scalars[f"{name}_{key}"] = v
    return total, scalars
