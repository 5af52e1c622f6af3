"""Rematerialization with BatchNorm statistics updated once.

Counterpart of the JAX package's `jax.checkpoint` around the train step's
three passes (`rcmvsnet_tpu/train/step.py:58-92`) and `nn.remat` around
FeatureNet, each CostRegNet and the render U-Net under train
(`models/cascade.py:254-255,267-268,384-385`, `nn/neural_volume.py:44-45`),
switched by `RunConfig.remat` / `remat_modules`. `remat(fn, modules,
*args)` runs fn(*args) under `torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)`: the tensors fn's operations save for the backward
are dropped, and the backward reruns fn to get them back. Nothing that fn
returns changes, and neither does a gradient; the peak memory and the
time do.

BatchNorm. JAX's remat is functional and drops the `batch_stats` that a
recompute returns. PyTorch's recompute reruns each train-mode BatchNorm,
and every path here (`nn.BatchNorm*d` called as a module, `nn/layers.
batch_stats`, the cross-rank layer of `parallel/sync_bn`) updates its
running statistics as it goes: without a guard they would move again at
each recompute, twice a pass at one level and three times with both. So
on the forward `remat` copies the running_mean, running_var and
num_batches_tracked of every BatchNorm under `modules`, and the recompute
runs with each module's buffers swapped for a fresh copy of those values.
It reads what the first forward read (the cross-rank layer shifts its
sums by the running mean, so its bits depend on it) and writes into the
copy, which is dropped on exit when the module's own buffers are swapped
back. The buffers thus advance once per forward, in forward order, and a
recompute neither writes them nor bumps their version counters. An inner
`remat` whose first forward runs inside an outer recompute copies the
outer copy's values, which are the ones its own first forward saw.

A cross-rank BatchNorm all-reduces again in the recompute; every rank
recomputes the same passes in the same order, so the collectives pair up.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def batchnorms(modules) -> list:
    """Every BatchNorm with running statistics under `modules`."""
    return [m for root in modules for m in root.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats]


def _copies(tensors: list) -> list:
    """Fresh copies of tensors, one multi-tensor copy per dtype."""
    out = [torch.empty_like(t) for t in tensors]
    for dtype in {t.dtype for t in tensors}:
        pick = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        torch._foreach_copy_([out[i] for i in pick],
                             [tensors[i] for i in pick])
    return out


class _Recompute:
    """The recompute's context: each BatchNorm's buffers swapped for a
    fresh copy of the first forward's values, swapped back on exit."""

    def __init__(self, bns: list, saved: list):
        self.bns, self.saved, self.own = bns, saved, None

    def _swap(self, tensors: list) -> None:
        it = iter(tensors)
        for m in self.bns:
            for name in BUFFERS:
                m._buffers[name] = next(it)

    def __enter__(self):
        self.own = [m._buffers[name] for m in self.bns for name in BUFFERS]
        self._swap(_copies(self.saved))

    def __exit__(self, *exc):
        self._swap(self.own)
        self.own = None


def remat(fn, modules, *args, enabled: bool = True):
    """fn(*args), rematerialized in the backward when `enabled` and grad
    mode is on (else a plain call). modules: the nn.Modules whose
    BatchNorms fn runs (see the module doc)."""
    if not enabled or not torch.is_grad_enabled():
        return fn(*args)
    bns = batchnorms(modules)

    def contexts():
        saved = _copies([getattr(m, name) for m in bns for name in BUFFERS])
        return nullcontext(), _Recompute(bns, saved)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)
