"""The fused RC-MVSNet unsupervised train step:

    L = L_photometric(clean pass)
      + w_aug · L_aug(masked-aug pass vs the detached pseudo-depth)
      + L_rgb(rendered rays) + L_depth(rendered rays vs pseudo-depth)

with ONE backward and one Adam step, as the reference's three sub-steps
share one zero_grad / backward / step. Counterpart of
`rcmvsnet_tpu/train/step.py:37-197`. The render losses reach the backbone
through the NON-detached stage-1 volume; the pseudo-depth targets are
detached. BatchNorm running statistics update in forward order: clean
pass → aug pass → render pass.

The step's random draws (the aug rectangle's origin, each sample's ray
pixels and depth noise) are an input, `StepDraws`; `draw_step` makes them
from a `torch.Generator`.

`make_val_step` is the supervised validation step (JAX
`train/step.py:200-226`): the eval forward (`CascadeMVSNet.forward`, BN
folded from the running statistics) and `cas_mvsnet_loss` with the
monitoring metrics, under `torch.no_grad()`.

Data parallelism (`group`, `parallel/mesh.py`): each rank holds rows
[r·B, (r+1)·B) of the global batch (the loader's process shard) and the
models with their BatchNorms swapped for `parallel/sync_bn`'s (statistics
over the global batch). The draws are the global batch's, made from the
same seed on every rank; each rank takes its rows. After the one backward
the gradients are averaged over the ranks (`allreduce_gradients`) before
Adam, so every rank applies the same update. The batch reductions, and
how each runs over the global batch:
  * plain means over equal per-rank shapes stay each rank's own mean (the
    averaged gradients are the global mean's): in `losses/unsup.py` the
    SSIM term, the two smoothness terms (`ops/image.depth_smoothness`)
    and the top-1 reconstruction mean; `losses/rays.img2mse`;
    `losses/supervised.thres_metric` and `abs_depth_error_metric` (means
    of per-image values);
  * the per-view reconstruction scalar of `losses/unsup.py` (its photo
    and gradient means), which every pixel's top-1 over the views then
    uses, is the global mean (`parallel/mesh.global_mean`);
  * masked means take the global numerator and denominator
    (`parallel/mesh.global_masked_mean`): `losses/aug.aug_loss_multi_
    stage` (the occlusion rectangle and the resize make the ranks' counts
    differ), `losses/rays.sl1_loss`, `abs_error`, `acc_threshold` (ray
    masks) and `losses/supervised.cas_mvsnet_loss`.
The returned metrics are then averaged over the ranks in one all-reduce
(`parallel/mesh.average_scalars`), PSNR formed from the averaged MSE:
every metric is the global batch's, the same on every rank. With no group
(one rank) none of this runs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..losses.aug import (aug_loss_multi_stage, draw_mask_origins,
                          random_image_mask)
from ..losses.rays import (abs_error, acc_threshold, img2mse, mse2psnr,
                           sl1_loss)
from ..losses.supervised import (abs_depth_error_metric, cas_mvsnet_loss,
                                 thres_metric)
from ..losses.unsup import unsup_loss_multi_stage
from ..parallel.mesh import (allreduce_gradients, average_scalars,
                             group_rank)
from ..render.rays import draw_rays
from .state import TrainState


class StepDraws(NamedTuple):
    mask_origin: torch.Tensor      # [B, 2] int64 (x0, y0)
    rays: tuple                    # one render.rays.RayDraws per sample


def draw_step(generator: torch.Generator, config: Config, batch: int,
              height: int, width: int) -> StepDraws:
    """The draws of a batch of `batch` samples (in data parallelism the
    global batch: every rank draws the same and takes its rows)."""
    origins = draw_mask_origins(generator, batch, height, width,
                                (height // 3, width // 3))
    rays = tuple(draw_rays(generator, height, width, config.render.n_rays,
                           config.render.n_samples) for _ in range(batch))
    return StepDraws(origins, rays)


def rank_draws(draws: StepDraws, rank: int, batch: int) -> StepDraws:
    """Rows [rank·batch, (rank+1)·batch) of the global batch's draws."""
    rows = slice(rank * batch, (rank + 1) * batch)
    return StepDraws(draws.mask_origin[rows], draws.rays[rows])


def batch_to(batch: dict, device) -> dict:
    """A numpy / tensor batch → float32 tensors on device (nested dicts)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.as_tensor(v, dtype=torch.float32).to(device)
    return {k: conv(v) for k, v in batch.items()}


def _depth_metrics(est, gt, mask) -> dict:
    return {
        "abs_depth_error": abs_depth_error_metric(est, gt, mask),
        "thres2mm_error": thres_metric(est, gt, mask, 2.0),
        "thres4mm_error": thres_metric(est, gt, mask, 4.0),
        "thres8mm_error": thres_metric(est, gt, mask, 8.0),
    }


def make_train_step(config: Config, plain: bool = False,
                    with_images: bool = False, group=None):
    """Returns train_step(state, batch, draws) -> metrics (0-d tensors).

    batch (tensors on the models' device, batch-major): imgs, imgs_aug,
    center_imgs [B, V, H, W, 3]; proj_matrices {stageK: [B, V, 2, 4, 4]};
    depth_values [B, Dfull]; w_aug (scalar); w2cs, c2ws [B, V, 4, 4];
    intrinsics [B, V, 3, 3]; near_fars [B, V, 2]; optionally depth / mask
    {stageK: [B, h, w]} for the supervised monitoring metrics.
    `plain=True` runs every kernel's plain version under autograd.
    with_images adds metrics["images"], the reference's image summaries
    (depth estimate of each pass, masked and not, the ref image and,
    where the batch has them, stage-1 gt and mask and the error map).
    group: the ranks the global batch spans (see the module doc); draws
    are then the global batch's, and state's models must hold
    `parallel/sync_bn` BatchNorms over the same group."""
    dlossw = tuple(config.loss.dlossw)
    rank = group_rank(group)

    def train_step(state: TrainState, batch: dict,
                   draws: StepDraws) -> dict:
        cascade, render = state.cascade, state.render
        imgs = batch["imgs"]
        B, V, H, W, _ = imgs.shape
        projs, dvals = batch["proj_matrices"], batch["depth_values"]
        if group is not None:
            draws = rank_draws(draws, rank, B)

        # clean pass + photometric self-supervision
        outputs, volume_feature = cascade.forward_train(
            imgs, projs, dvals, return_volume=True, plain=plain)
        loss_base, unsup_scalars = unsup_loss_multi_stage(
            outputs, batch["center_imgs"], projs, dlossw, group)
        pseudo_depth = outputs["depth"].detach()

        # aug pass vs the pseudo-depth
        imgs_aug = batch["imgs_aug"]
        ref_masked, filter_mask = random_image_mask(
            imgs_aug[:, 0], (H // 3, W // 3), draws.mask_origin)
        imgs_aug = torch.cat([ref_masked[:, None], imgs_aug[:, 1:]], dim=1)
        outputs_aug = cascade.forward_train(imgs_aug, projs, dvals,
                                            plain=plain)
        loss_aug, aug_scalars = aug_loss_multi_stage(
            outputs_aug, pseudo_depth, filter_mask, dlossw, group)

        # rendering consistency
        result = render(volume_feature, pseudo_depth, imgs, batch["w2cs"],
                        batch["c2ws"], batch["intrinsics"],
                        batch["near_fars"], draws.rays, plain=plain)
        img_loss = img2mse(result.rgb, result.target_rgb)
        ray_mask = result.rays_depth > 0
        depth_loss = sl1_loss(result.depth, result.rays_depth, ray_mask,
                              group)

        w_aug = batch["w_aug"]
        total = loss_base + w_aug * loss_aug + img_loss + depth_loss

        lr = state.schedule(state.step)
        for pg in state.optimizer.param_groups:
            pg["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        allreduce_gradients([p for g in state.optimizer.param_groups
                             for p in g["params"]], group)
        state.optimizer.step()
        state.step += 1

        metrics = {
            "loss": total, "repr_loss": loss_base,
            "aug_loss": w_aug * loss_aug,
            "img_loss": img_loss, "ray_depth_loss": depth_loss,
            "psnr": mse2psnr(img_loss),
            "ray_abs_err": abs_error(result.depth, result.rays_depth,
                                     ray_mask, group),
            "ray_acc_2mm": acc_threshold(result.depth, result.rays_depth,
                                         ray_mask, 2.0, group),
            **unsup_scalars, **aug_scalars,
        }
        supervised = "depth" in batch and "mask" in batch
        key = f"stage{len(dlossw)}"
        if supervised:
            gt = batch["depth"][key]
            metrics.update(_depth_metrics(pseudo_depth, gt,
                                          batch["mask"][key] > 0.5))
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        if group is not None:
            metrics = average_scalars(metrics, group)
            metrics["psnr"] = mse2psnr(metrics["img_loss"])
        metrics["lr"] = torch.tensor(lr)
        if with_images:
            est_aug = outputs_aug["depth"].detach()
            images = {"depth_est_nomask": pseudo_depth,
                      "aug_depth_est_nomask": est_aug,
                      "nerf_depth_est_nomask": pseudo_depth,
                      "ref_img": imgs[:, 0]}
            if supervised:
                fmask = batch["mask"][key]
                images.update({
                    "depth_est": pseudo_depth * fmask,
                    "aug_depth_est": est_aug * fmask,
                    "nerf_depth_est": pseudo_depth * fmask,
                    # the reference logs the stage-1 gt and mask images
                    "depth_gt": batch["depth"]["stage1"],
                    "mask": batch["mask"]["stage1"],
                    "errormap": (pseudo_depth - gt).abs() * fmask,
                })
            metrics["images"] = images
        return metrics

    return train_step


def make_val_step(config: Config, plain: bool = False,
                  with_depth: bool = False, group=None):
    """Returns val_step(state, batch) -> metrics (0-d tensors): loss and
    depth_loss (`cas_mvsnet_loss`) and the four monitoring metrics at the
    last stage. batch: imgs [B, V, H, W, 3] as the val loader gives them,
    proj_matrices, depth_values, depth / mask {stageK: [B, h, w]}.
    Neither the BN buffers nor the models' train mode change. with_depth
    adds metrics["depth"], the last stage's depth [B, H, W]. group: the
    metrics are the global batch's, the same on every rank."""
    dlossw = tuple(config.loss.dlossw)

    def val_step(state: TrainState, batch: dict) -> dict:
        with torch.no_grad():
            outputs = state.cascade(batch["imgs"], batch["proj_matrices"],
                                    batch["depth_values"], plain=plain)
            loss, depth_loss = cas_mvsnet_loss(outputs, batch["depth"],
                                               batch["mask"], dlossw, group)
            key = f"stage{len(dlossw)}"
            metrics = average_scalars(
                {"loss": loss, "depth_loss": depth_loss,
                 **_depth_metrics(outputs["depth"], batch["depth"][key],
                                  batch["mask"][key] > 0.5)}, group)
        if with_depth:
            metrics["depth"] = outputs["depth"]
        return metrics

    return val_step
