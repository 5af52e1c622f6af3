"""FPN feature extractor: 3-scale pyramid, strides 1/2/4.

Counterpart of `rcmvsnet_tpu/nn/featurenet.py:38-75` (`FeatureNet`) and of
its folded eval path `rcmvsnet_tpu/nn/featurenet_fast.featurenet_packed`.
Tensors are NCHW. Outputs: stage1 [N, 4c, H/4, W/4], stage2
[N, 2c, H/2, W/2], stage3 [N, c, H, W].

  * `forward`: the modules as they stand (Conv → BN → ReLU). On bf16
    images (the bf16 train path, JAX `FeatureNet` under train_dtype
    bfloat16: flax convs at dtype bf16) every conv runs on bf16 tensors
    with its float32 weight rounded to bf16 per call (cuDNN on the card:
    JAX computes these convs in XLA, outside any Pallas kernel), BN takes
    float32 statistics and applies them in bf16 with each factor rounded
    (`nn/layers.bn_apply_rounded`), the inner heads' biases are added in
    bf16 after the conv, and the three outputs are bf16.
  * `forward_folded`: the eval path through K5 (`ops/conv2d`): BN as a
    scale/shift epilogue; inner1 fused with the nearest-×2 upsample-add;
    stage 3's head as one `lateral_conv2d` call, which forms
    nearest-×2(intra) + inner2(conv0) + b tile by tile and never writes
    that full-resolution sum; with out_layout="warp" the three heads
    write [N, h, w, C], the layout K1 reads. `plain=True` runs K5's plain
    versions instead (for comparing the two on the card). With
    dtype=torch.bfloat16 (the bf16 eval path) the images are cast to
    bf16 and every call runs K5's bf16 instance on bf16 weights, BN's
    scale folded in float32 into the bf16-rounded conv weight and the
    product rounded again (`featurenet_packed` casts the kernel before
    `conv2d_cm` folds the scale and casts), its shift the float32 bias;
    the activations and the three outputs are bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv2d import (conv2d, conv2d_plain, lateral_conv2d,
                          lateral_conv2d_plain)
from .layers import ConvBNAct, batch_stats, bn_apply_rounded, bn_scale_shift


def _conv_bf16(m: nn.Conv2d, t: torch.Tensor) -> torch.Tensor:
    """m on bf16 t with its weight rounded to bf16; a bias is rounded and
    added after the conv, in bf16."""
    bf = lambda w: w.to(torch.bfloat16)
    y = F.conv2d(t, bf(m.weight), None, m.stride, m.padding)
    return y if m.bias is None else y + bf(m.bias)[:, None, None]


def block_train_bf16(blk: ConvBNAct, x: torch.Tensor) -> torch.Tensor:
    """One train-mode Conv → BN → ReLU block on bf16 x (see the module
    doc)."""
    y = _conv_bf16(blk.conv, x)
    return torch.relu(bn_apply_rounded(blk.bn, y, *batch_stats(blk.bn, y)))


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8):
        super().__init__()
        c = base_channels
        self.conv0 = nn.Sequential(ConvBNAct(3, c, 3, 1, 1),
                                   ConvBNAct(c, c, 3, 1, 1))
        self.conv1 = nn.Sequential(ConvBNAct(c, 2 * c, 5, 2, 2),
                                   ConvBNAct(2 * c, 2 * c, 3, 1, 1),
                                   ConvBNAct(2 * c, 2 * c, 3, 1, 1))
        self.conv2 = nn.Sequential(ConvBNAct(2 * c, 4 * c, 5, 2, 2),
                                   ConvBNAct(4 * c, 4 * c, 3, 1, 1),
                                   ConvBNAct(4 * c, 4 * c, 3, 1, 1))
        # heads: out* without bias, inner* (1×1 laterals) with bias
        self.out1 = nn.Conv2d(4 * c, 4 * c, 1, bias=False)
        self.inner1 = nn.Conv2d(2 * c, 4 * c, 1, bias=True)
        self.inner2 = nn.Conv2d(c, 4 * c, 1, bias=True)
        self.out2 = nn.Conv2d(4 * c, 2 * c, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(4 * c, c, 3, padding=1, bias=False)
        self.out_channels = (4 * c, 2 * c, c)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        if x.dtype == torch.bfloat16:
            return self._forward_bf16(x)
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        intra = self.conv2(conv1)
        out = {"stage1": self.out1(intra)}
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") \
            + self.inner1(conv1)
        out["stage2"] = self.out2(intra)
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") \
            + self.inner2(conv0)
        out["stage3"] = self.out3(intra)
        return out

    def _forward_bf16(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """`forward` on bf16 images (see the module doc)."""
        acts = []
        for seq in (self.conv0, self.conv1, self.conv2):
            for blk in seq:
                x = block_train_bf16(blk, x)
            acts.append(x)
        return self.heads_bf16(*acts)

    def heads_bf16(self, conv0: torch.Tensor, conv1: torch.Tensor,
                   intra: torch.Tensor) -> dict[str, torch.Tensor]:
        """The FPN heads of the bf16 forward on the three trunk outputs."""
        out = {"stage1": _conv_bf16(self.out1, intra)}
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") \
            + _conv_bf16(self.inner1, conv1)
        out["stage2"] = _conv_bf16(self.out2, intra)
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") \
            + _conv_bf16(self.inner2, conv0)
        out["stage3"] = _conv_bf16(self.out3, intra)
        return out

    def forward_folded(self, x: torch.Tensor, plain: bool = False,
                       out_layout: str = "nchw",
                       dtype: torch.dtype = torch.float32
                       ) -> dict[str, torch.Tensor]:
        """Eval forward through K5; the outputs of `forward`, as NCHW or
        (out_layout="warp") as [N, h, w, C], in `dtype` (float32 or
        bfloat16)."""
        conv = conv2d_plain if plain else conv2d
        lateral = lateral_conv2d_plain if plain else lateral_conv2d
        bf16 = dtype == torch.bfloat16
        cast = (lambda w: w.to(torch.bfloat16)) if bf16 else (lambda w: w)
        x = x.to(dtype)
        acts = []
        for seq in (self.conv0, self.conv1, self.conv2):
            for blk in seq:
                scale, shift = bn_scale_shift(blk.bn)
                weight = blk.conv.weight
                if bf16:
                    weight = cast(cast(weight) * scale[:, None, None, None])
                    scale = None
                x = conv(x, weight, scale, shift,
                         stride=blk.conv.stride[0],
                         padding=blk.conv.padding[0], relu=True)
            acts.append(x)
        conv0, conv1, intra = acts
        out = {"stage1": conv(intra, cast(self.out1.weight),
                              out_layout=out_layout)}
        intra = conv(conv1, cast(self.inner1.weight), shift=self.inner1.bias,
                     up=intra)
        out["stage2"] = conv(intra, cast(self.out2.weight), padding=1,
                             out_layout=out_layout)
        out["stage3"] = lateral(intra, conv0, cast(self.inner2.weight),
                                self.inner2.bias, cast(self.out3.weight),
                                out_layout=out_layout)
        return out
