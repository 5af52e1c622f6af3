"""BatchNorm whose train-mode statistics span every rank's batch.

Counterpart of the JAX package's `TorchBatchNorm` under a data-parallel
mesh (`rcmvsnet_tpu/nn/layers.py:58-99`), where the batch reduction is
global by construction. Per channel each rank sums (Σx, Σx²) over its
own batch, x taken from the running mean c (the same on every rank);
one all-reduce with autograd (`parallel/mesh.all_sum`, that is
`torch.distributed.nn.functional.all_reduce`, whose backward all-reduces
the statistics' gradients) gives the global sums, and then, with n the
global count, as JAX forms them (JAX with c = 0):
    d = Σ(x − c) / n,  mean = c + d,
    var = max(Σ(x − c)² / n − d², 0)   (normalises),
    running_mean ← (1 − m)·running_mean + m·mean,
    running_var  ← (1 − m)·running_var + m·var·n / (n − 1).
The shift leaves the function as it is and spares the float32 variance
the cancellation of E[x²] − mean² where |mean| ≫ std: a trained model's
running mean sits near the batch's (at the golden backbone it halves the
gap to PyTorch's own BatchNorm, `tests/test_torch_parallel.py`).

The sums do not depend on how the batch is split: each sample's (row's)
sums come from a reduction of that row alone, and the rows' sums add in
a fixed tree that halves the rows first (the sum of 2k rows is the sum of
the first k plus the sum of the last k). Two ranks holding k rows each
therefore reach, through one all-reduce (a + b, in either order), the
bits one process reaches over all 2k rows with this layer: the
data-parallel step's forward is then the single-process step's, bit for
bit, wherever its other operations are per sample (`chip_smoke.py` phase
11 holds two ranks to that step). The ranks' shards have the same shape,
so n is the local count times the number of ranks. Eval mode uses the running
statistics as `nn.BatchNorm*d` does.

bf16 input (the bf16 train path): the sums and statistics are float32,
from x's float32 values; `forward` applies them in float32 and rounds the
result to bf16 once. `batch_stats` gives the statistics alone, for the
callers that apply them as JAX does at that layer (`nn/layers.py`).

Not `nn.SyncBatchNorm`: that is a library layer, and it refuses CPU
tensors, where the tests run it. `convert(module, group)` swaps every
`nn.BatchNorm2d` / `nn.BatchNorm3d` of a model for this layer, with the
same parameters, buffers and state_dict names; with no group (one rank)
it swaps nothing, so a one-device run keeps PyTorch's own BatchNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import bn_apply_f32
from .mesh import all_sum, group_size


def _tree(parts: list) -> torch.Tensor:
    """Σ parts in a fixed binary tree, halves first."""
    if len(parts) == 1:
        return parts[0]
    h = len(parts) // 2
    return _tree(parts[:h]) + _tree(parts[h:])


class CrossRankBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm{2,3}d with its batch statistics over every rank of
    `group` (see the module doc)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, group=None):
        super().__init__(num_features, eps, momentum, affine=True,
                         track_running_stats=True)
        self.group = group

    def _check_input_dim(self, x):
        if x.dim() < 3:
            raise ValueError(f"expected a [N, C, ...] input, got {x.dim()}D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        return bn_apply_f32(self, x, *self.batch_stats(x))

    def batch_stats(self, x: torch.Tensor):
        """Train-mode (mean, biased var), float32, over every rank of the
        group; the running statistics updated."""
        N, C = x.shape[:2]
        shape = (1, C) + (1,) * (x.dim() - 2)
        c = self.running_mean.detach().clone()
        xc = (x.float() - c.reshape(shape)).reshape(N, C, -1)
        stats = all_sum(_tree([torch.cat([r.sum(1), (r * r).sum(1)])
                               for r in xc]), self.group)
        n = float(xc.shape[2] * N * group_size(self.group))
        d = stats[:C] / n
        mean = c + d
        var = torch.clamp(stats[C:2 * C] / n - d * d, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)
        return mean, var


def convert(module: nn.Module, group, one_rank: bool = False) -> nn.Module:
    """Swap every nn.BatchNorm2d / nn.BatchNorm3d under `module` (in
    place) for a CrossRankBatchNorm over `group` that holds the same
    parameter and buffer tensors (an optimizer over them stays valid).
    group None: nothing is swapped, unless one_rank (the layer's arithmetic
    in one process: the reference a data-parallel run is held to).
    Returns module."""
    if group is None and not one_rank:
        return module
    for name, child in module.named_children():
        if isinstance(child, (nn.BatchNorm2d, nn.BatchNorm3d)):
            bn = CrossRankBatchNorm(child.num_features, child.eps,
                                    child.momentum, group)
            bn.weight, bn.bias = child.weight, child.bias
            for buf in ("running_mean", "running_var",
                        "num_batches_tracked"):
                setattr(bn, buf, getattr(child, buf))
            bn.train(child.training)
            setattr(module, name, bn)
        else:
            convert(child, group, one_rank)
    return module
