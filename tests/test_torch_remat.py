"""Rematerialization of the port's train step (`RunConfig.remat` /
`remat_modules`, `nn/remat.py`), on the CPU through the plain versions,
at 32×32, V=3, 48/32/8 planes, 16 rays × 8 samples, 16 neural-volume
planes, from a seeded init.

  * The step with remat at both levels (the default) and at pass level
    only (`remat_modules=False`) against the step without remat, in
    float32 and in bf16 (`train_dtype` bfloat16): two steps each, equal in
    every bit: every metric, every parameter gradient, every BatchNorm
    buffer (num_batches_tracked included) and every parameter after Adam.
  * Forward calls per step of FeatureNet, CostRegNet and the render U-Net
    (their entry points wrapped by a counter): JAX's 3 / 2 / 1 times the
    no-remat count with both levels / pass level / none, the recompute
    running to its end (PyTorch's early stop cuts none of these calls).
  * Each BatchNorm path keeps its buffers through a recompute: PyTorch's
    `nn.BatchNorm3d` called as a module, `nn/layers.batch_stats` (the bf16
    blocks) and the cross-rank layer (`parallel/sync_bn`, at one rank),
    each in a block run twice (as the clean and aug passes run the
    cascade) under nested remats: outputs, input gradients, parameter
    gradients and buffers equal in every bit to the run without remat,
    and the buffers untouched by the backward (the same tensors, at the
    same version). `torch.utils.checkpoint` alone updates them again in
    its recompute.
The two-rank step under remat is in tests/test_torch_parallel.py."""
from functools import partial

import pytest
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rcmvsnet_tpu_torch.config import (BackboneConfig, Config, RenderConfig,
                                       RunConfig)
from rcmvsnet_tpu_torch.data.synthetic import make_synthetic_batch
from rcmvsnet_tpu_torch.nn.costreg import (CostRegNet, RenderCostReg,
                                           block_train)
from rcmvsnet_tpu_torch.nn.featurenet import FeatureNet
from rcmvsnet_tpu_torch.nn.layers import ConvBNAct
from rcmvsnet_tpu_torch.nn.remat import remat
from rcmvsnet_tpu_torch.parallel.sync_bn import convert
from rcmvsnet_tpu_torch.train.state import create_train_state
from rcmvsnet_tpu_torch.train.step import (batch_to, draw_step,
                                           make_train_step)

torch.set_num_threads(2)
H = W = 32
V = 3
CFG = Config(render=RenderConfig(n_rays=16, n_samples=8, num_planes=16))
# (remat, remat_modules) of each setting
SETTINGS = {"none": (False, True), "pass": (True, False),
            "both": (True, True)}
# forward calls per step without remat: FeatureNet and the three
# CostRegNets in the clean and aug passes, the render U-Net once
NO_REMAT_CALLS = {"FeatureNet": 2, "CostRegNet": 6, "RenderCostReg": 1}
FACTOR = {"none": 1, "pass": 2, "both": 3}


def _named(state, kind):
    out = {f"render.{k}": v for k, v in getattr(state.render, kind)()}
    out.update(getattr(state.cascade, kind)())
    return out


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def runs(request):
    """{setting: [per step: (metrics, grads, buffers, params, calls)]} of
    two steps from one init, batch and draws."""
    batch = batch_to(make_synthetic_batch(B=1, V=V, H=H, W=W, ndepth=32,
                                          seed=3), "cpu")
    batch["w_aug"] = torch.tensor(0.01)
    calls = {}

    def counting(cls, fn):
        def method(self, *a, **kw):
            calls[cls] = calls.get(cls, 0) + 1
            return fn(self, *a, **kw)
        return method

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for cls, name in ((FeatureNet, "forward"),
                          (CostRegNet, "forward_train"),
                          (RenderCostReg, "forward_train")):
            mp.setattr(cls, name, counting(cls.__name__, getattr(cls, name)))
        for setting, (rm, mods) in SETTINGS.items():
            cfg = CFG.replace(
                backbone=BackboneConfig(train_dtype=request.param),
                run=RunConfig(remat=rm, remat_modules=mods))
            draws = draw_step(torch.Generator().manual_seed(4), cfg, 1, H, W)
            state = create_train_state(cfg, V, 100, "cpu", seed=2)
            step = make_train_step(cfg)
            out[setting] = []
            for _ in range(2):
                calls.clear()
                metrics = step(state, batch, draws)
                out[setting].append((
                    {k: v.clone() for k, v in metrics.items()},
                    {k: p.grad.clone()
                     for k, p in _named(state, "named_parameters").items()},
                    {k: b.clone()
                     for k, b in _named(state, "named_buffers").items()},
                    {k: p.detach().clone()
                     for k, p in _named(state, "named_parameters").items()},
                    dict(calls)))
    return out


@pytest.mark.parametrize("setting", ["pass", "both"])
def test_remat_step_equals_no_remat_step(runs, setting):
    for i, (got, want) in enumerate(zip(runs[setting], runs["none"])):
        for part, what in enumerate(("metric", "gradient", "buffer",
                                     "parameter")):
            assert set(got[part]) == set(want[part])
            differ = [k for k, v in want[part].items()
                      if not torch.equal(got[part][k], v)]
            assert not differ, (f"step {i + 1}", what, differ[:5])
    tracked = {int(v) for k, v in runs[setting][1][2].items()
               if k.endswith("num_batches_tracked")}
    assert tracked == {4, 2}          # cascade: 2 passes a step; render: 1


def test_forward_calls_per_step(runs):
    for setting, steps in runs.items():
        for step in steps:
            assert step[4] == {k: FACTOR[setting] * n
                               for k, n in NO_REMAT_CALLS.items()}, setting


# ------------------------------------------------------- BatchNorm paths --

def _block(path: str) -> nn.Module:
    """A two-layer conv + BN block on one of the three BatchNorm paths."""
    torch.manual_seed(0)
    net = nn.Sequential(ConvBNAct(4, 8, 3, 1, 1, dims=3),
                        ConvBNAct(8, 8, 3, 1, 1, dims=3))
    with torch.no_grad():          # running statistics away from 0 and 1
        for m in net.modules():
            if isinstance(m, nn.BatchNorm3d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    if path == "cross_rank":
        convert(net, None, one_rank=True)
    return net.train()


def _run_block(net, x, path):
    if path == "batch_stats_bf16":
        for blk in net:
            x = block_train(blk.conv, blk.bn, x, "s1", relu=True, plain=True)
        return x
    return net(x)


def _forward(net, path, x, use):
    """The block on x, then again on 2x (two passes over one set of
    BatchNorms), each pass under a remat around an inner remat of its
    second layer."""
    def one(t):
        h = _run_block(net[:1], t, path)
        return remat(partial(_run_block, net[1:], path=path), [net[1:]], h,
                     enabled=use)
    return [remat(one, [net], t, enabled=use) for t in (x, 2 * x)]


@pytest.mark.parametrize("path", ["module", "batch_stats_bf16",
                                  "cross_rank"])
def test_batchnorm_buffers_untouched_by_recompute(path):
    dtype = torch.bfloat16 if path == "batch_stats_bf16" else torch.float32
    x0 = torch.randn(2, 4, 4, 6, 6, generator=torch.Generator()
                     .manual_seed(1)).to(dtype)
    res = {}
    for use in (False, True):
        net = _block(path)
        x = x0.clone().requires_grad_(True)
        outs = _forward(net, path, x, use)
        before = [(n, b, b._version, b.clone())
                  for n, b in net.named_buffers()]
        sum((o.float() ** 2).sum() for o in outs).backward()
        after = dict(net.named_buffers())
        for n, b, version, value in before:
            assert after[n] is b and b._version == version, (path, use, n)
            assert torch.equal(b, value), (path, use, n)
        res[use] = ([o.detach() for o in outs], x.grad,
                    [p.grad for p in net.parameters()],
                    [b.clone() for _, b in net.named_buffers()])
    for got, want in zip(res[True], res[False]):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), path
    assert [int(b) for n, b in net.named_buffers()
            if n.endswith("num_batches_tracked")] == [2, 2]


def test_plain_checkpoint_updates_batchnorm_again():
    """The hazard `remat` guards against: a recompute through
    `torch.utils.checkpoint` alone reruns BatchNorm's update."""
    bn = nn.BatchNorm3d(4).train()
    x = torch.randn(2, 4, 3, 3, 3, requires_grad=True)
    checkpoint(bn, x, use_reentrant=False).sum().backward()
    assert int(bn.num_batches_tracked) == 2
    bn2 = nn.BatchNorm3d(4).train()
    remat(bn2, [bn2], x).sum().backward()
    assert int(bn2.num_batches_tracked) == 1
    assert not torch.equal(bn.running_mean, bn2.running_mean)


def test_remat_is_a_plain_call_without_grad():
    net = _block("module")
    x = torch.randn(1, 4, 4, 6, 6)
    calls = []
    with torch.no_grad():
        y = remat(lambda t: calls.append(1) or net(t), [net], x)
    assert calls == [1] and not y.requires_grad
