"""3D U-Net cost regularizers.

Counterparts of `rcmvsnet_tpu/nn/costreg.py` (`CostRegNet`,
`RenderCostReg`) and of the folded eval path
`rcmvsnet_tpu/ops/pallas_costreg.costreg_lanes` (`:538-561`). Volumes are
NCDHW.

Encoder 8→16→32→64 with stride-2 conv1/3/5; decoder transposed conv7/9/11
whose skip add comes AFTER their BN (+ReLU); CostRegNet's `prob` has no BN
and no bias; RenderCostReg has no ReLU anywhere and returns the
base-channel volume.

  * `CostRegNet.forward`: the modules as they stand.
  * `CostRegNet.forward_folded`: the eval path, all 11 layers through K2
    (`ops/conv3d.conv3d`) on BN-folded weights. `plain=True` runs K2's
    plain version instead. A bf16 volume runs K2's bf16 instance: the
    weights folded in float32 and rounded to bf16 once, the biases
    float32, bf16 activations, and the prob head writes the float32 cost
    (`pallas_costreg.costreg_lanes` at compute_dtype bf16).
  * `forward_train` (both nets): every conv through K8
    (`ops/conv3d_train.conv3d_train`) with train-mode BatchNorm, ReLU and
    the skip adds in autograd between them; `plain=True` runs the plain
    PyTorch conv under autograd instead. A bf16 volume (the bf16 train
    path, JAX `nn/costreg.py` `_LanesConvBN` at compute dtype bf16): K8's
    bf16 instances on the float32 weights, BatchNorm statistics float32
    and its apply float32 rounded once (`nn/layers.batch_stats`,
    `bn_apply_f32`), the skips added in bf16, and CostRegNet's prob head
    writing the float32 cost.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.conv3d import conv3d, conv3d_plain
from ..ops.conv3d_train import conv3d_train, conv3d_train_plain
from .layers import (ConvBNAct, DeconvBNAct, batch_stats, bn_apply_f32,
                     fold_block)

# (block, mode) of the U-Net trunk, in forward order; the decoder blocks'
# outputs are added to the encoder outputs of SKIPS
TRUNK = (("conv0", "s1"), ("conv1", "s2"), ("conv2", "s1"), ("conv3", "s2"),
          ("conv4", "s1"), ("conv5", "s2"), ("conv6", "s1"), ("conv7", "t2"),
          ("conv9", "t2"), ("conv11", "t2"))
SKIPS = {"conv7": "conv4", "conv9": "conv2", "conv11": "conv0"}


def conv_bn(block):
    """(conv, bn) of a ConvBNAct / DeconvBNAct or of an
    nn.Sequential(conv, bn)."""
    if isinstance(block, nn.Sequential):
        return block[0], block[1]
    return block.conv, block.bn


def block_train(conv: nn.Module, bn: nn.Module, x: torch.Tensor, mode: str,
                relu: bool, plain: bool = False) -> torch.Tensor:
    """One train-mode U-Net block: conv (K8, or plain) → BN (batch
    statistics; running stats updated) → [ReLU] (x float32 or bf16)."""
    t = (conv3d_train_plain if plain else conv3d_train)(x, conv.weight, mode)
    if x.dtype == torch.bfloat16:
        t = bn_apply_f32(bn, t, *batch_stats(bn, t))
    else:
        t = bn(t)
    return torch.relu(t) if relu else t


def unet_train(net: nn.Module, x: torch.Tensor, relu: bool,
               plain: bool = False) -> torch.Tensor:
    """The shared trunk in train mode (`block_train` per block), skips
    added after."""
    out = {}
    t = x
    for name, mode in TRUNK:
        t = block_train(*conv_bn(getattr(net, name)), t, mode, relu, plain)
        if name in SKIPS:
            t = out[SKIPS[name]] + t
        out[name] = t
    return t


class CostRegNet(nn.Module):
    def __init__(self, in_channels: int, base_channels: int = 8):
        super().__init__()
        c = base_channels
        blk = lambda ci, co, s: ConvBNAct(ci, co, 3, s, 1, dims=3)
        self.conv0 = blk(in_channels, c, 1)
        self.conv1 = blk(c, 2 * c, 2)
        self.conv2 = blk(2 * c, 2 * c, 1)
        self.conv3 = blk(2 * c, 4 * c, 2)
        self.conv4 = blk(4 * c, 4 * c, 1)
        self.conv5 = blk(4 * c, 8 * c, 2)
        self.conv6 = blk(8 * c, 8 * c, 1)
        self.conv7 = DeconvBNAct(8 * c, 4 * c)
        self.conv9 = DeconvBNAct(4 * c, 2 * c)
        self.conv11 = DeconvBNAct(2 * c, c)
        self.prob = nn.Conv3d(c, 1, 3, stride=1, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)

    def forward_folded(self, x: torch.Tensor,
                       plain: bool = False) -> torch.Tensor:
        """x [N, C, D, H, W] → cost [N, 1, D, H, W] float32; same as
        `forward` (x float32 or bfloat16)."""
        conv = conv3d_plain if plain else conv3d
        dt = x.dtype

        def f(name):
            w, b = fold_block(getattr(self, name))
            return w.to(dt), b

        conv0 = conv(x, *f("conv0"), "s1")
        t = conv(conv0, *f("conv1"), "s2")
        conv2 = conv(t, *f("conv2"), "s1")
        t = conv(conv2, *f("conv3"), "s2")
        conv4 = conv(t, *f("conv4"), "s1")
        t = conv(conv4, *f("conv5"), "s2")
        t = conv(t, *f("conv6"), "s1")
        t = conv(t, *f("conv7"), "t2", skip=conv4)
        t = conv(t, *f("conv9"), "t2", skip=conv2)
        t = conv(t, *f("conv11"), "t2", skip=conv0)
        zero = torch.zeros(1, dtype=torch.float32, device=x.device)
        return conv(t, self.prob.weight.to(dt), zero, "s1", relu=False,
                    out_dtype=torch.float32)

    def forward_train(self, x: torch.Tensor,
                      plain: bool = False) -> torch.Tensor:
        """Train mode: x [N, C, D, H, W] → cost [N, 1, D, H, W] (float32;
        x float32 or bf16)."""
        t = unet_train(self, x, relu=True, plain=plain)
        conv = conv3d_train_plain if plain else conv3d_train
        if x.dtype == torch.bfloat16:
            return conv(t, self.prob.weight, "s1", out_dtype=torch.float32)
        return conv(t, self.prob.weight, "s1")


class RenderCostReg(nn.Module):
    """The render branch's U-Net: conv + BN with NO ReLU, output
    `base_channels` wide. Reference names: conv0..conv6 `.conv`/`.bn`,
    conv7/9/11 `nn.Sequential(ConvTranspose3d, BatchNorm3d)` (`.0`/`.1`)."""

    def __init__(self, in_channels: int, base_channels: int = 8):
        super().__init__()
        c = base_channels
        blk = lambda ci, co, s: ConvBNAct(ci, co, 3, s, 1, dims=3)
        dec = lambda ci, co: nn.Sequential(
            nn.ConvTranspose3d(ci, co, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            nn.BatchNorm3d(co))
        self.conv0 = blk(in_channels, c, 1)
        self.conv1 = blk(c, 2 * c, 2)
        self.conv2 = blk(2 * c, 2 * c, 1)
        self.conv3 = blk(2 * c, 4 * c, 2)
        self.conv4 = blk(4 * c, 4 * c, 1)
        self.conv5 = blk(4 * c, 8 * c, 2)
        self.conv6 = blk(8 * c, 8 * c, 1)
        self.conv7 = dec(8 * c, 4 * c)
        self.conv9 = dec(4 * c, 2 * c)
        self.conv11 = dec(2 * c, c)

    def forward_train(self, x: torch.Tensor,
                      plain: bool = False) -> torch.Tensor:
        """x [N, C, D, H, W] → [N, base, D, H, W]."""
        return unet_train(self, x, relu=False, plain=plain)
