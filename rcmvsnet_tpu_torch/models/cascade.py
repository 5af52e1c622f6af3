"""CascadeMVSNet eval: 3-stage coarse-to-fine plane-sweep depth network.

Counterpart of the eval branch of `rcmvsnet_tpu/models/cascade.py:292-508`
(`train=False`, `refine=False`). Parameter names follow the reference
(`feature.*`, `cost_regularization.{i}.*`), so a reference `*_cas.ckpt`
state_dict loads with `strict=True`.

Per stage, for each batch element:
  features (K5) → warp + variance (K1) → 3D U-Net (K2) → softmax,
  depth and confidence (K4),
with the per-pixel hypothesis schedule dv(d) = lo + d·step feeding K1 and
K4 directly; the [D, h, w] hypothesis volume exists only inside the plain
versions. `plain=True` runs every kernel's plain version (on a CPU tensor
the wrappers do so anyway).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import BackboneConfig
from ..core.geometry import compose_projection
from ..nn.costreg import CostRegNet
from ..nn.featurenet import FeatureNet
from ..ops.depth_tail import depth_tail, depth_tail_plain
from ..ops.sampling import resize_bilinear
from ..ops.warp_variance import warp_variance, warp_variance_plain

STAGE_SCALES = (4, 2, 1)


class CascadeMVSNet(nn.Module):
    def __init__(self, config: BackboneConfig = BackboneConfig()):
        super().__init__()
        self.config = config
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
        cfg = self.config
        warp = warp_variance_plain if plain else warp_variance
        tail = depth_tail_plain if plain else depth_tail
        B, V, H, W, _ = imgs.shape
        d_min = depth_values[:, 0]
        d_max = depth_values[:, -1]
        depth_interval = (d_max - d_min) / depth_values.shape[1]      # [B]

        x = imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2).contiguous()
        feats = self.feature.forward_folded(x, plain=plain)

        outputs = {}
        depth = None
        for s, nd in enumerate(cfg.ndepths):
            key = f"stage{s + 1}"
            h, w = H // STAGE_SCALES[s], W // STAGE_SCALES[s]
            if depth is None:
                step1 = (d_max - d_min) / (nd - 1)
                lo = d_min[:, None, None].expand(B, h, w).contiguous()
                step = step1[:, None, None].expand(B, h, w).contiguous()
            else:
                # two-step resize, as the reference's full-res round trip
                cur = resize_bilinear(depth[..., None], H, W)[..., 0]
                if (h, w) != (H, W):
                    cur = resize_bilinear(cur[..., None], h, w)[..., 0]
                interval = (cfg.depth_intervals_ratio[s]
                            * depth_interval)[:, None, None]
                lo = cur - nd / 2.0 * interval
                hi = cur + nd / 2.0 * interval
                step = (hi - lo) / (nd - 1)
            fs = feats[key]
            C = fs.shape[1]
            fs = fs.reshape(B, V, C, h, w).permute(0, 1, 3, 4, 2)
            projs = compose_projection(proj_matrices[key].float())
            depths, confs = [], []
            for b in range(B):
                var = warp(fs[b].contiguous(), projs[b], lo[b], step[b], nd)
                cost = self.cost_regularization[s].forward_folded(
                    var[None], plain=plain)
                d_b, c_b = tail(cost[0, 0], lo[b].contiguous(),
                                step[b].contiguous())
                depths.append(d_b)
                confs.append(c_b)
            depth = torch.stack(depths)
            outputs[key] = {"depth": depth,
                            "photometric_confidence": torch.stack(confs)}
        last = outputs[f"stage{len(cfg.ndepths)}"]
        outputs["depth"] = last["depth"]
        outputs["photometric_confidence"] = last["photometric_confidence"]
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
