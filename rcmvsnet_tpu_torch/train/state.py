"""Train state: both models, their BatchNorm running statistics (module
buffers) and one Adam optimizer over backbone ∪ render parameters.

Counterpart of `rcmvsnet_tpu/train/state.py`. The optimizer is
`torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)` with its L2
`weight_decay` (the decay is added to the gradient before the moments),
which is what `optax.chain(add_decayed_weights, adam)` computes; both
divide by sqrt(v̂) + eps, eps outside the root. The learning rate is set
from `warmup_multistep_schedule` before every step.

In data parallelism (`group`) every rank initialises from the same seed,
its BatchNorms are swapped for the cross-rank ones (`parallel/sync_bn`)
and rank 0's models are broadcast to the others (`parallel/mesh.
replicate`), so every rank starts from the same state.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import Config, compute_dtype
from ..models.cascade import CascadeMVSNet
from ..models.render_net import RenderingConsistencyNet
from ..parallel import sync_bn
from ..parallel.mesh import replicate
from .schedule import warmup_multistep_schedule


@dataclass
class TrainState:
    cascade: CascadeMVSNet
    render: RenderingConsistencyNet
    optimizer: torch.optim.Adam
    schedule: object
    step: int = 0


def make_models(config: Config, num_views: int):
    """(CascadeMVSNet, RenderingConsistencyNet) for V = num_views, both
    at the backbone's train dtype (JAX `train/state.py:41,58`, its CLI
    setting the render branch's from the same flag); their parameters
    are float32. Both rematerialize their modules under train when
    `run.remat and run.remat_modules` (JAX `train/state.py:44,55`)."""
    remat = config.run.remat and config.run.remat_modules
    cascade = CascadeMVSNet(config.backbone, remat=remat)
    vol_ch = 3 * (num_views - 1) + cascade.feature.out_channels[0]
    render = RenderingConsistencyNet(
        vol_ch, num_planes=config.render.num_planes,
        net_type=config.render.net_type,
        train_dtype=compute_dtype(config.backbone.train_dtype), remat=remat)
    return cascade, render


def make_optimizer(config: Config, params, steps_per_epoch: int):
    run = config.run
    schedule = warmup_multistep_schedule(
        run.lr, [m * steps_per_epoch for m in run.lr_milestone_epochs],
        gamma=run.lr_gamma)
    opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=run.weight_decay)
    return opt, schedule


def create_train_state(config: Config, num_views: int, steps_per_epoch: int,
                       device, seed: int = 0, state_dicts=None,
                       group=None) -> TrainState:
    """Both models on `device`, initialized from `seed`, then loaded from
    `state_dicts` = (cascade, render) reference-named state_dicts where
    given (either may be None), and the optimizer over their
    parameters. group: the data-parallel ranks (see the module doc)."""
    torch.manual_seed(seed)
    cascade, render = make_models(config, num_views)
    for model, sd in zip((cascade, render), state_dicts or (None, None)):
        if sd is not None:
            model.load_state_dict(sd, strict=True)
    cascade.to(device).train()
    render.to(device).train()
    if group is not None:
        sync_bn.convert(cascade, group)
        sync_bn.convert(render, group)
        replicate(cascade, render, group=group)
    params = list(cascade.parameters()) + list(render.parameters())
    opt, schedule = make_optimizer(config, params, steps_per_epoch)
    return TrainState(cascade, render, opt, schedule)
