"""CascadeMVSNet: 3-stage coarse-to-fine plane-sweep depth network.

Counterpart of `rcmvsnet_tpu/models/cascade.py:292-508` (`refine=False`).
Parameter names follow the reference (`feature.*`,
`cost_regularization.{i}.*`), so a reference `*_cas.ckpt` state_dict loads
with `strict=True`.

Eval (`forward`), per stage and batch element:
  features (K5) → warp + variance (K1) → 3D U-Net (K2) → softmax,
  depth and confidence (K4),
with the per-pixel hypothesis schedule dv(d) = lo + d·step feeding K1 and
K4 directly; the [D, h, w] hypothesis volume exists only inside the plain
versions. FeatureNet's three heads (out1, out2 and stage 3's fused
lateral head) write the [V, h, w, C] layout K1 reads, so no feature map
is permuted or copied between K5 and K1.
With `config.eval_dtype == "bfloat16"` the eval path is the JAX eval
CLI's on its chip (`cli/eval_dtu.build_forward`: the packed bf16 FeatureNet,
the fused warp and lanes U-Net at their bf16 defaults): the images are
cast to bf16 on the device, K5, K1 and K2 run their bf16 instances on
bf16 activations and weights rounded once, the prob head writes the
float32 cost, and K4 is unchanged.

Train (`forward_train`, BatchNorm in train mode): FeatureNet as modules;
per stage and sample the differentiable warp — K7 (variance, no-ref
variance and warped source images in one sweep, the last two written
straight into the render branch's volume_feature layout) at stage 1 when
the render branch's volume is asked for, K1 with K6 as its backward
otherwise — then the U-Net through K8 once over the batch (its BatchNorm
statistics the batch's, as in JAX), then softmax + depth regression in
plain PyTorch
(the JAX train tail is XLA code). With `grad_detach` the previous stage's
depth is detached before it sets the next window.
With `config.train_dtype == "bfloat16"` the train forward is the JAX
cascade's under train_dtype bfloat16 (`models/cascade.py:377-378`): the
images are cast to bf16, so FeatureNet, the warps (K1 with K6, K7 on the
bf16 features and the stage's bf16 images) and the U-Nets (K8) run their
bf16 instances; the prob head writes the float32 cost, and the softmax,
depth and confidence are float32 (`:285`).
With `remat` (`train/state.make_models` sets it from `RunConfig.remat`
and `remat_modules`) the train forward runs FeatureNet and each stage's
CostRegNet through `nn/remat.remat`, as the JAX cascade wraps them in
`nn.remat` under train (`models/cascade.py:254-255,267-268,384-385`):
their activations are recomputed in the backward, their BatchNorm
statistics updated once. The eval `forward` is never wrapped.

`plain=True` runs every kernel's plain version (on a CPU tensor the
wrappers do so anyway), with autograd through them on the train path.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch
from torch import nn

from ..config import BackboneConfig, compute_dtype
from ..core.geometry import compose_projection
from ..nn.costreg import CostRegNet
from ..nn.featurenet import FeatureNet
from ..nn.remat import remat
from ..ops.depth_tail import (depth_regression, depth_tail,
                              depth_tail_plain, photometric_confidence)
from ..ops.sampling import resize_bilinear
from ..ops.warp_variance import (warp_variance, warp_variance_plain,
                                 warp_variance_train)
from ..ops.warp_volume import warp_volume_train

STAGE_SCALES = (4, 2, 1)


def eval_dtype(config: BackboneConfig) -> torch.dtype:
    """The eval path's compute dtype named by `config.eval_dtype` (None:
    float32, as in JAX; "float32" names it too, as `--eval_dtype` does)."""
    return compute_dtype(config.eval_dtype)


def train_dtype(config: BackboneConfig) -> torch.dtype:
    """The train forward's compute dtype named by `config.train_dtype`."""
    return compute_dtype(config.train_dtype)


class CascadeMVSNet(nn.Module):
    def __init__(self, config: BackboneConfig = BackboneConfig(),
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.remat = remat
        self.feature = FeatureNet(config.base_channels)
        self.cost_regularization = nn.ModuleList([
            CostRegNet(self.feature.out_channels[i], config.cr_base_chs[i])
            for i in range(len(config.ndepths))])

    def forward(self, imgs: torch.Tensor, proj_matrices: dict,
                depth_values: torch.Tensor, plain: bool = False) -> dict:
        """imgs [B, V, H, W, 3] (channels-last, ImageNet-normalized);
        proj_matrices {stageK: [B, V, 2, 4, 4]}; depth_values [B, Dfull].

        Returns {stage1..3: {depth, photometric_confidence}, depth,
        photometric_confidence}, each map [B, h, w] float32."""
        warp = warp_variance_plain if plain else warp_variance
        tail = depth_tail_plain if plain else depth_tail
        B, V, H, W, _ = imgs.shape
        x = imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2).contiguous()
        feats = self.feature.forward_folded(x, plain=plain,
                                            out_layout="warp",
                                            dtype=eval_dtype(self.config))

        outputs = {}
        depth = None
        for s, nd in enumerate(self.config.ndepths):
            key = f"stage{s + 1}"
            h, w = H // STAGE_SCALES[s], W // STAGE_SCALES[s]
            lo, step = self._planes(s, depth, depth_values, H, W)
            fs = feats[key]                          # [B·V, h, w, C]
            fs = fs.reshape(B, V, h, w, fs.shape[-1])
            projs = compose_projection(proj_matrices[key].float())
            depths, confs = [], []
            for b in range(B):
                var = warp(fs[b], projs[b], lo[b], step[b], nd)
                cost = self.cost_regularization[s].forward_folded(
                    var[None], plain=plain)
                d_b, c_b = tail(cost[0, 0], lo[b].contiguous(),
                                step[b].contiguous())
                depths.append(d_b)
                confs.append(c_b)
            depth = torch.stack(depths)
            outputs[key] = {"depth": depth,
                            "photometric_confidence": torch.stack(confs)}
        last = outputs[f"stage{len(self.config.ndepths)}"]
        outputs["depth"] = last["depth"]
        outputs["photometric_confidence"] = last["photometric_confidence"]
        return outputs

    def _planes(self, s: int, depth, depth_values: torch.Tensor, H: int,
                W: int):
        """Stage s's hypothesis schedule dv(d) = lo + d·step: (lo, step),
        each [B, h, w]: the full sweep at stage 1, a window of
        ndepths[s] planes around the previous depth after it."""
        cfg = self.config
        nd = cfg.ndepths[s]
        B = depth_values.shape[0]
        h, w = H // STAGE_SCALES[s], W // STAGE_SCALES[s]
        d_min = depth_values[:, 0]
        d_max = depth_values[:, -1]
        if depth is None:
            step1 = (d_max - d_min) / (nd - 1)
            lo = d_min[:, None, None].expand(B, h, w).contiguous()
            return lo, step1[:, None, None].expand(B, h, w).contiguous()
        # two-step resize, as the reference's full-res round trip
        cur = resize_bilinear(depth[..., None], H, W)[..., 0]
        if (h, w) != (H, W):
            cur = resize_bilinear(cur[..., None], h, w)[..., 0]
        depth_interval = (d_max - d_min) / depth_values.shape[1]
        interval = (cfg.depth_intervals_ratio[s]
                    * depth_interval)[:, None, None]
        lo = cur - nd / 2.0 * interval
        hi = cur + nd / 2.0 * interval
        return lo, (hi - lo) / (nd - 1)

    def forward_train(self, imgs: torch.Tensor, proj_matrices: dict,
                      depth_values: torch.Tensor,
                      return_volume: bool = False, plain: bool = False):
        """Train-mode forward (inputs as `forward`). Returns the outputs
        dict ({stage1..3: {depth, photometric_confidence}}, depth,
        photometric_confidence) and, with return_volume, the stage-1
        volume_feature_no_ref [B, 3(V−1)+C, D, h, w]: the warped source
        images (view-major) then the no-ref variance, channels first."""
        cfg = self.config
        dtype = train_dtype(cfg)
        warp = partial(warp_variance_train, plain=plain)
        volume = partial(warp_volume_train, plain=plain)
        imgs = imgs.to(dtype)
        B, V, H, W, _ = imgs.shape
        x = imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2).contiguous()
        feats = remat(self.feature, [self.feature], x, enabled=self.remat)

        outputs = {}
        depth = None
        volume_feature = None
        for s, nd in enumerate(cfg.ndepths):
            key = f"stage{s + 1}"
            h, w = H // STAGE_SCALES[s], W // STAGE_SCALES[s]
            prev = depth
            if prev is not None and cfg.grad_detach:
                prev = prev.detach()
            lo, step = self._planes(s, prev, depth_values, H, W)
            C = feats[key].shape[1]
            fs = feats[key].reshape(B, V, C, h, w).permute(0, 1, 3, 4, 2)
            projs = compose_projection(proj_matrices[key].float())
            want_volume = return_volume and s == 0
            if want_volume:
                imgs_s = resize_bilinear(imgs.reshape(B * V, H, W, 3), h,
                                         w).reshape(B, V, h, w, 3)
            variances, vols = [], []
            for b in range(B):
                f_b = fs[b].contiguous()
                if want_volume:
                    var, vol = volume(f_b, imgs_s[b].contiguous(), projs[b],
                                      lo[b], step[b], nd)
                    vols.append(vol)
                else:
                    var = warp(f_b, projs[b], lo[b], step[b], nd)
                variances.append(var)
            # one U-Net call over the batch: train-mode BN takes its
            # statistics over every sample, as JAX's batched U-Net does
            x = variances[0][None] if B == 1 else torch.stack(variances)
            net = self.cost_regularization[s]
            costs = remat(partial(net.forward_train, plain=plain), [net], x,
                          enabled=self.remat)[:, 0]          # [B, D, h, w]
            depths, confs = [], []
            idx = torch.arange(nd, dtype=lo.dtype, device=lo.device)
            for b in range(B):
                prob = torch.softmax(costs[b], dim=0)[None]
                dv = lo[b][None] + idx[:, None, None] * step[b][None]
                depths.append(depth_regression(prob, dv[None])[0])
                confs.append(photometric_confidence(prob.detach())[0])
            depth = torch.stack(depths)
            outputs[key] = {"depth": depth,
                            "photometric_confidence": torch.stack(confs)}
            if want_volume:        # K7 writes the layout: no copy at B=1
                volume_feature = vols[0][None] if B == 1 else torch.stack(
                    vols)
        last = outputs[f"stage{len(cfg.ndepths)}"]
        outputs["depth"] = last["depth"]
        outputs["photometric_confidence"] = last["photometric_confidence"]
        if return_volume:
            return outputs, volume_feature
        return outputs


def infer_views(model: CascadeMVSNet, samples, device,
                plain: bool = False):
    """Run the cascade once per sample (one reference view each, B=1).

    samples: iterable of {"imgs" [V, H, W, 3], "proj_matrices"
    {stageK: [V, 2, 4, 4]}, "depth_values" [Dfull]} (DTUTestDataset items
    or equivalent in-memory dicts). Returns a list of (depth, confidence),
    float32 numpy [H, W] each, in sample order."""
    as_t = lambda a: torch.from_numpy(
        np.require(a, np.float32, ["C", "W"]))[None].to(device)
    results = []
    with torch.no_grad():
        for s in samples:
            out = model(as_t(s["imgs"]),
                        {k: as_t(v) for k, v in s["proj_matrices"].items()},
                        as_t(s["depth_values"]), plain=plain)
            results.append((out["depth"][0].cpu().numpy(),
                            out["photometric_confidence"][0].cpu().numpy()))
    return results


def infer_views_sharded(model: CascadeMVSNet, samples, device, rank: int = 0,
                        world: int = 1, plain: bool = False):
    """Rank `rank` of `world`'s share of `infer_views`: the reference views
    i with i % world == rank, one at a time, each through `infer_views`.
    samples: a sequence (a dataset or a list) of `infer_views` samples;
    sample i + world is fetched on a worker thread while view i runs.
    Yields (i, sample, depth, confidence) in order. No collectives: each
    rank's views are independent (JAX `cli/eval_dtu.py:254-268` gives
    each device its own reference views the same way)."""
    views = range(rank, len(samples), world)
    if not views:
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(samples.__getitem__, views[0])
        for k, i in enumerate(views):
            sample = pending.result()
            if k + 1 < len(views):
                pending = pool.submit(samples.__getitem__, views[k + 1])
            depth, conf = infer_views(model, [sample], device, plain)[0]
            yield i, sample, depth, conf
