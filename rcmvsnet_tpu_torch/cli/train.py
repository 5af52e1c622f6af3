"""Unsupervised RC-MVSNet training, one device (PyTorch port).

Counterpart of `rcmvsnet_tpu/cli/train.py` on a single device: the fused
train step (`train/step.py`: clean, aug and render passes, one backward,
one Adam step) for `--max_steps` steps per epoch, with the JAX CLI's flag
names for the flags it keeps, plus `--device` (default `cuda`; a missing
card is an error, not a CPU run). Scalars go to `<logdir>/scalars.jsonl`
every `--summary_freq` steps.

Only `--trainpath synthetic` is supported (textured-plane scenes, no data
on disk, render branch cut to 128 rays x 32 samples x 32 planes as the JAX
CLI cuts it); the DTU train / val datasets, validation, checkpoints and
`--resume` are not ported yet.

Usage:
  python -m rcmvsnet_tpu_torch.cli.train --trainpath synthetic \\
      --max_steps 10 --logdir ./rc-mvsnet [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..config import (BackboneConfig, Config, LossConfig, RenderConfig,
                      RunConfig)
from ..data.synthetic_dataset import SyntheticDataset
from ..losses.aug import adjust_w_aug
from ..train.logging import DictAverageMeter, MetricLogger
from ..train.state import create_train_state
from ..train.step import batch_to, draw_step, make_train_step
from .eval_dtu import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RC-MVSNet training (PyTorch)")
    p.add_argument("--trainpath", required=True,
                   help="'synthetic' (the only dataset ported so far)")
    p.add_argument("--logdir", default="./rc-mvsnet")
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lrepochs", default="10,12,14:2",
                   help="'e1,e2,..:g' — scale lr by 1/g at those epochs")
    p.add_argument("--wd", type=float, default=0.0,
                   help="L2-into-gradient weight decay (torch Adam style)")
    p.add_argument("--grad_method", default="detach",
                   choices=["detach", "undetach"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_view", type=int, default=3)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--dlossw", default="0.5,1.0,2.0")
    p.add_argument("--cr_base_chs", default="8,8,8")
    p.add_argument("--w_aug", type=float, default=0.01)
    p.add_argument("--n_rays", type=int, default=1024)
    p.add_argument("--n_samples", type=int, default=128)
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--summary_freq", type=int, default=10)
    p.add_argument("--max_steps", type=int, default=None,
                   help="cap steps/epoch (smoke runs)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def config_from_args(a) -> Config:
    csv = lambda s, t: tuple(t(x) for x in s.split(",") if x)
    milestones, _, gamma = a.lrepochs.partition(":")
    return Config(
        backbone=BackboneConfig(ndepths=csv(a.ndepths, int),
                                depth_intervals_ratio=csv(a.depth_inter_r,
                                                          float),
                                cr_base_chs=csv(a.cr_base_chs, int),
                                grad_detach=a.grad_method == "detach"),
        render=RenderConfig(n_rays=a.n_rays, n_samples=a.n_samples),
        loss=LossConfig(dlossw=csv(a.dlossw, float), w_aug=a.w_aug),
        run=RunConfig(epochs=a.epochs, lr=a.lr, batch_size=a.batch_size,
                      lr_milestone_epochs=csv(milestones, int),
                      lr_gamma=1.0 / float(gamma or 2.0), weight_decay=a.wd,
                      seed=a.random_seed, logdir=a.logdir,
                      summary_freq=a.summary_freq))


def collate(items) -> dict:
    """Stack dataset items (nested dicts of arrays) along a batch axis."""
    out = {}
    for k, v in items[0].items():
        if isinstance(v, dict):
            out[k] = {kk: np.stack([it[k][kk] for it in items])
                      for kk in v}
        else:
            out[k] = np.stack([it[k] for it in items])
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.trainpath != "synthetic":
        raise SystemExit(f"--trainpath {args.trainpath}: only 'synthetic' "
                         "is supported (the DTU train datasets are not "
                         "ported yet)")
    device = resolve_device(args.device)
    config = config_from_args(args)
    config = config.replace(render=dataclasses.replace(
        config.render, n_rays=min(config.render.n_rays, 128),
        n_samples=min(config.render.n_samples, 32), num_planes=32))
    B = config.run.batch_size
    nviews = args.num_view + 1
    ds = SyntheticDataset(n_samples=8 * B, nviews=nviews,
                          ndepths=args.numdepth, seed=config.run.seed)
    steps_per_epoch = len(ds) // B
    if args.max_steps:
        steps_per_epoch = min(steps_per_epoch, args.max_steps)

    state = create_train_state(config, nviews, steps_per_epoch, device,
                               seed=config.run.seed)
    train_step = make_train_step(config)
    gen = torch.Generator(device=device).manual_seed(config.run.seed)
    order_rng = np.random.RandomState(config.run.seed)
    logger = MetricLogger(config.run.logdir)
    for epoch in range(config.run.epochs):
        w_aug = adjust_w_aug(epoch, config.loss.w_aug)
        meter = DictAverageMeter()
        order = order_rng.permutation(len(ds))
        for step_idx in range(steps_per_epoch):
            t0 = time.time()
            items = [ds[int(i)] for i in order[step_idx * B:(step_idx + 1) * B]]
            batch = batch_to(collate(items), device)
            batch["w_aug"] = torch.tensor(w_aug, device=device)
            H, W = batch["imgs"].shape[2:4]
            draws = draw_step(gen, config, B, H, W)
            metrics = train_step(state, batch, draws)
            gstep = epoch * steps_per_epoch + step_idx + 1
            if gstep % config.run.summary_freq == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["step_time"] = time.time() - t0
                logger.log("train", host, gstep)
                meter.update(host)
                print(f"epoch {epoch} step {step_idx}/{steps_per_epoch} "
                      f"loss {host['loss']:.3f} "
                      f"time {host['step_time']:.2f}s", flush=True)
        if meter.count:
            logger.log("fulltrain", meter.mean(),
                       (epoch + 1) * steps_per_epoch)
    logger.close()


if __name__ == "__main__":
    main()
