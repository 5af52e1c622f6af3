"""Conv + BatchNorm + ReLU blocks with the reference's parameter names.

Counterparts of `rcmvsnet_tpu/nn/layers.py` (`ConvBNAct`, `DeconvBNAct`).
Each block holds `.conv` and `.bn`, so a reference `state_dict` reads
`feature.conv0.0.conv.weight` / `feature.conv0.0.bn.running_var` and loads
with `strict=True`. The bare heads (`out*`, `inner*`, `prob`) are plain
`nn.Conv2d` / `nn.Conv3d`, as in the reference. BatchNorm runs in eval mode
on the inference path (running statistics, eps 1e-5).

Train-mode BatchNorm on bf16 activations (the bf16 train path) keeps its
statistics float32 (`batch_stats`, JAX `TorchBatchNorm` and
`pallas_costreg_train.bn_stats_lanes`: mean and E[x²] − mean² of the
float32 values, the running statistics updated as PyTorch does) and is
applied as JAX applies it: `bn_apply_rounded` in FeatureNet, each factor
rounded to bf16 and the arithmetic bf16 (`nn/layers.py:101-102` there),
`bn_apply_f32` in the 3D U-Nets, float32 arithmetic rounded once
(`bn_apply_lanes`).
"""
from __future__ import annotations

import torch
from torch import nn


class ConvBNAct(nn.Module):
    """Conv{2,3}d (no bias) → BatchNorm → ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dims: int = 2):
        super().__init__()
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        bn = nn.BatchNorm2d if dims == 2 else nn.BatchNorm3d
        self.conv = conv(in_ch, out_ch, kernel_size, stride, padding,
                         bias=False)
        self.bn = bn(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class DeconvBNAct(nn.Module):
    """ConvTranspose3d (k3, s2, p1, output_padding 1, no bias) → BN →
    ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(in_ch, out_ch, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        self.bn = nn.BatchNorm3d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def bn_scale_shift(bn: nn.modules.batchnorm._BatchNorm):
    """Eval BatchNorm as per-channel (scale, shift): y = x·scale + shift."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


def fold_bn(kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
            out_dim: int = 0):
    """Fold eval BatchNorm into (kernel, bias) so that conv(x, kernel) +
    bias == BN(conv(x)). `out_dim` is the kernel's output-channel axis: 0
    for Conv, 1 for ConvTranspose. Counterpart of
    `rcmvsnet_tpu/ops/pallas_costreg.fold_bn`."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    shape = [1] * kernel.ndim
    shape[out_dim] = -1
    return kernel.float() * s.reshape(shape), bias.float() - mean.float() * s


def fold_block(block) -> tuple[torch.Tensor, torch.Tensor]:
    """(kernel, bias) of a ConvBNAct / DeconvBNAct with its BN folded in."""
    bn = block.bn
    out_dim = 1 if isinstance(block.conv, nn.ConvTranspose3d) else 0
    return fold_bn(block.conv.weight, bn.weight, bn.bias, bn.running_mean,
                   bn.running_var, bn.eps, out_dim)


def _channel_shape(x: torch.Tensor):
    return (1, x.shape[1]) + (1,) * (x.dim() - 2)


def batch_stats(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor):
    """Train-mode (mean, biased var) of x [N, C, ...] per channel, float32,
    from x's float32 values; bn's running statistics updated (momentum,
    the unbiased variance, as `nn.BatchNorm*d`). A cross-rank BatchNorm
    (`parallel/sync_bn`) takes them over every rank."""
    own = getattr(bn, "batch_stats", None)
    if own is not None:
        return own(x)
    xf = x.float()
    dims = [0] + list(range(2, x.dim()))
    n = xf.numel() / xf.shape[1]
    mean = xf.mean(dims)
    var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(m * mean)
        bn.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        bn.num_batches_tracked.add_(1)
    return mean, var


def bn_apply_f32(bn, x: torch.Tensor, mean: torch.Tensor,
                 var: torch.Tensor) -> torch.Tensor:
    """(x − mean)·rsqrt(var + eps)·γ + β in float32, rounded to x's dtype
    once."""
    shape = _channel_shape(x)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x.float() - mean.reshape(shape)) * inv.reshape(shape) \
        + bn.bias.reshape(shape)
    return y.to(x.dtype)


def bn_apply_rounded(bn, x: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor) -> torch.Tensor:
    """(x − mean)·inv + β in x's dtype, mean, inv = rsqrt(var + eps)·γ and
    β each rounded to it first."""
    shape = _channel_shape(x)
    cast = lambda t: t.to(x.dtype).reshape(shape)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - cast(mean)) * cast(inv) + cast(bn.bias)
