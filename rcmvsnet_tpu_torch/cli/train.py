"""Unsupervised RC-MVSNet training (PyTorch port), on one device or
data-parallel over several.

Counterpart of `rcmvsnet_tpu/cli/train.py`, with the JAX CLI's flag names
for the flags it keeps, plus `--device` (default `cuda`; a missing card is
an error, not a CPU run). `--no_pallas` runs every kernel's plain
PyTorch version (`plain=True`), as the JAX flag runs the XLA path.
`--train_dtype bfloat16` sets the train dtype of the backbone and of the
render U-Net (`BackboneConfig.train_dtype`), as the JAX CLI does on its
chip: the bf16 instances of K1, K6, K7, K2
and K8 dw (or, with `--no_pallas`, their bf16 plain versions); the
checkpoints hold the float32 parameters either way. As in the JAX CLI
the step rematerializes its three passes and, inside them, FeatureNet, the
CostRegNets and the render U-Net (`RunConfig.remat`, `nn/remat.py`):
the lowest peak memory, at the price of recomputing each forward in the
backward. `--no_remat` keeps every activation instead, which is faster
where the batch fits the card's memory. Per
epoch: the fused train step (`train/step.py`: clean, aug and render
passes, one backward, one Adam step) over the shuffled train loader
(`data/loader.py`, its order fixed by (seed, epoch)); every
`--summary_freq` steps a `train` record in `<logdir>/scalars.jsonl` and
the image summaries under `<logdir>/images/`;
at the epoch's end a `fulltrain` record and, every `--save_freq` epochs,
the reference-format pair `model_{epoch:06d}_cas.ckpt` /
`model_{epoch:06d}_nerf.ckpt`; every `--eval_freq` epochs (and the last)
the supervised validation (`make_val_step`) as a `fulltest` record.
`--resume` restores the newest pair and continues at the next epoch; the
random draws restart from the seed, as the JAX CLI's do.

Data parallelism (`parallel/mesh.py`; one process per device, where the
JAX CLI runs one process per host): `--n_devices N` on one host spawns N
workers, worker r on `cuda:r` (or the CPU under `--device cpu`), joined
through a file store; `--coordinator_address host:port --num_processes P
--process_id i` joins a P-process group across hosts, and `--multihost`
alone reads `torchrun`'s environment. The global batch is `--batch_size`
× the number of processes; BatchNorm statistics, losses and gradients are
the global batch's (`train/step.py`); only rank 0 logs, prints and
checkpoints; a `--resume` whose ranks restored different states is
refused. NCCL on the card, Gloo on the CPU. `--n_devices` that disagrees
with a multi-process run's world size is refused, as JAX refuses it.

Datasets: `--trainpath synthetic` (textured-plane scenes, no data on disk,
render branch cut to 128 rays x 32 samples x 32 planes as the JAX CLI cuts
it, a val set from seed + 1000), or a DTU tree in the reference's layout
(`DTUTrainDataset` from `--trainpath` / `--trainlist`, `DTUValDataset`
with 5 views from `--testpath` / `--testlist`). `fit` holds the loop, so
other callers can drive it on in-memory datasets.

Usage:
  python -m rcmvsnet_tpu_torch.cli.train --trainpath /data/dtu \\
      --trainlist lists/dtu/train.txt --testlist lists/dtu/test.txt \\
      --logdir ./rc-mvsnet [--epochs 15] [--net_type v0] [--resume]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from ..config import (BackboneConfig, Config, DataConfig, LossConfig,
                      RenderConfig, RunConfig)
from ..core.geometry import set_full_precision
from ..data.dtu_train import DTUTrainDataset
from ..data.dtu_val import DTUValDataset
from ..data.loader import DataLoader
from ..data.synthetic_dataset import SyntheticDataset
from ..losses.aug import adjust_w_aug
from ..parallel import mesh
from ..train.checkpoint import (check_restored, restore_checkpoint,
                                save_checkpoint)
from ..train.logging import DictAverageMeter, MetricLogger
from ..train.state import create_train_state
from ..train.step import batch_to, draw_step, make_train_step, make_val_step
from .eval_dtu import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RC-MVSNet training (PyTorch)")
    p.add_argument("--trainpath", required=True,
                   help="a DTU train tree, or 'synthetic'")
    p.add_argument("--testpath", default=None,
                   help="the DTU tree of the val set (default: trainpath)")
    p.add_argument("--trainlist", default="lists/dtu/train.txt")
    p.add_argument("--testlist", default="lists/dtu/test.txt")
    p.add_argument("--logdir", default="./rc-mvsnet")
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lrepochs", default="10,12,14:2",
                   help="'e1,e2,..:g' — scale lr by 1/g at those epochs")
    p.add_argument("--wd", type=float, default=0.0,
                   help="L2-into-gradient weight decay (torch Adam style)")
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--grad_method", default="detach",
                   choices=["detach", "undetach"])
    p.add_argument("--net_type", default="v0", choices=["v0", "v1", "v2"],
                   help="renderer MLP variant (v0 mult-bias / v1 attention "
                        "/ v2 additive)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_view", type=int, default=3)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--dlossw", default="0.5,1.0,2.0")
    p.add_argument("--cr_base_chs", default="8,8,8")
    p.add_argument("--w_aug", type=float, default=0.01)
    p.add_argument("--n_rays", type=int, default=1024)
    p.add_argument("--n_samples", type=int, default=128)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--summary_freq", type=int, default=10)
    p.add_argument("--max_steps", type=int, default=None,
                   help="cap steps (and val batches) per epoch (smoke runs)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace N train steps (from step 3) with "
                        "torch.profiler into <logdir>/profile")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); with "
                        "--n_devices, cuda or cpu")
    p.add_argument("--no_pallas", action="store_true",
                   help="run every kernel's plain PyTorch version")
    p.add_argument("--train_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the backbone and the render "
                        "U-Net in training (params, BN statistics and "
                        "losses stay float32)")
    p.add_argument("--no_remat", action="store_true",
                   help="disable sub-pass/U-Net rematerialization (faster "
                        "when the batch fits the card's memory without "
                        "it; the default remat keeps the lowest peak "
                        "memory)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel over this many devices of this "
                        "host, one process each (default 1)")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-host run from torchrun's environment "
                        "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                        "MASTER_PORT)")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0: join a multi-host run of "
                        "--num_processes processes as --process_id")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def config_from_args(a) -> Config:
    csv = lambda s, t: tuple(t(x) for x in s.split(",") if x)
    milestones, _, gamma = a.lrepochs.partition(":")
    return Config(
        backbone=BackboneConfig(ndepths=csv(a.ndepths, int),
                                depth_intervals_ratio=csv(a.depth_inter_r,
                                                          float),
                                cr_base_chs=csv(a.cr_base_chs, int),
                                grad_detach=a.grad_method == "detach",
                                train_dtype=a.train_dtype),
        render=RenderConfig(n_rays=a.n_rays, n_samples=a.n_samples,
                            net_type=a.net_type),
        loss=LossConfig(dlossw=csv(a.dlossw, float), w_aug=a.w_aug),
        data=DataConfig(datapath=a.trainpath, testpath=a.testpath or "",
                        train_list=a.trainlist, test_list=a.testlist,
                        num_views=a.num_view + 1,
                        numdepth=a.numdepth, interval_scale=a.interval_scale),
        run=RunConfig(epochs=a.epochs, lr=a.lr, batch_size=a.batch_size,
                      lr_milestone_epochs=csv(milestones, int),
                      lr_gamma=1.0 / float(gamma or 2.0), weight_decay=a.wd,
                      save_freq=a.save_freq, eval_freq=a.eval_freq,
                      seed=a.random_seed, logdir=a.logdir,
                      summary_freq=a.summary_freq, remat=not a.no_remat))


def build_datasets(config: Config, world: int = 1):
    """(config, train_ds, val_ds) for `config.data`: the synthetic sets
    (with the render branch cut to size; sized by the global batch of
    `world` ranks) or the DTU train and val sets."""
    data = config.data
    if data.datapath == "synthetic":
        B = config.run.batch_size * world
        config = config.replace(render=dataclasses.replace(
            config.render, n_rays=min(config.render.n_rays, 128),
            n_samples=min(config.render.n_samples, 32), num_planes=32))
        train_ds = SyntheticDataset(n_samples=8 * B, nviews=data.num_views,
                                    ndepths=data.numdepth,
                                    seed=config.run.seed)
        val_ds = SyntheticDataset(n_samples=2 * B, nviews=data.num_views,
                                  ndepths=data.numdepth,
                                  seed=config.run.seed + 1000)
        return config, train_ds, val_ds
    train_ds = DTUTrainDataset(data.datapath, data.train_list,
                               nviews=data.num_views, ndepths=data.numdepth,
                               interval_scale=data.interval_scale,
                               seed=config.run.seed)
    val_ds = DTUValDataset(data.testpath or data.datapath, data.test_list,
                           nviews=data.eval_num_views, ndepths=data.numdepth,
                           interval_scale=data.interval_scale)
    return config, train_ds, val_ds


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_loaders(config: Config, train_ds, val_ds, rank: int = 0,
                 world: int = 1):
    """(train, val) loaders of rank `rank` of `world`: the train set
    shuffled per (seed, epoch), the val set in order with its last partial
    batch on one rank, without it on several (unequal shards would leave
    collectives unmatched, as JAX's val loader drops it)."""
    B = config.run.batch_size
    return (DataLoader(train_ds, B, shuffle=True, seed=config.run.seed,
                       process_index=rank, process_count=world),
            DataLoader(val_ds, B, shuffle=False, drop_last=world > 1,
                       process_index=rank, process_count=world))


def fit(config: Config, train_ds, val_ds, device, *, resume: bool = False,
        max_steps=None, profile_steps: int = 0, state_dicts=None,
        plain: bool = False, group=None) -> dict:
    """The training loop. train_ds / val_ds: indexable datasets of numpy
    items (DTUTrainDataset / DTUValDataset keys); state_dicts: optional
    (cascade, render) reference-named state_dicts to start from, as
    `create_train_state` takes them (a checkpoint restored by `resume`
    overrides them); plain: every kernel's plain version; group: the
    data-parallel ranks (this process one of them; None for one device),
    each rank loading its shard and only rank 0 logging, profiling and
    saving. Returns {"state", "start_epoch", "start_step",
    "train_steps", "epoch_s" (each epoch's train loop, host loading and
    logging included), "load_s" and "log_s" (the shares of it spent
    waiting for and uploading batches, and writing the summaries),
    "val_batches", "val_s", "save_s" (one per save), "restore_s"}."""
    run = config.run
    logdir = run.logdir
    B = run.batch_size
    rank, world = mesh.group_rank(group), mesh.group_size(group)
    main_rank = rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    train_loader, val_loader = make_loaders(config, train_ds, val_ds, rank,
                                            world)
    steps_per_epoch = len(train_loader)
    if max_steps:
        steps_per_epoch = min(steps_per_epoch, max_steps)

    state = create_train_state(config, config.data.num_views,
                               steps_per_epoch, device, seed=run.seed,
                               state_dicts=state_dicts, group=group)
    start_epoch, restore_s = 0, None
    if resume:
        t0 = time.perf_counter()
        state, start_epoch = restore_checkpoint(logdir, state)
        restore_s = time.perf_counter() - t0
        check_restored(state, start_epoch, group)
        say(f"resumed at epoch {start_epoch}", flush=True)
    stats = {"start_epoch": start_epoch, "start_step": state.step,
             "train_steps": 0, "epoch_s": [], "load_s": 0.0, "log_s": 0.0,
             "val_batches": 0,
             "val_s": 0.0, "save_s": [], "restore_s": restore_s}

    train_step = make_train_step(config, plain=plain, with_images=True,
                                 group=group)
    val_step = make_val_step(config, plain=plain, group=group)
    gen = torch.Generator(device=device).manual_seed(run.seed)
    logger = MetricLogger(logdir) if main_rank else None
    prof, profile_until = None, None
    for epoch in range(start_epoch, run.epochs):
        train_loader.set_epoch(epoch)
        w_aug = adjust_w_aug(epoch, config.loss.w_aug)
        meter = DictAverageMeter()
        gstep0 = epoch * steps_per_epoch
        _sync(device)
        t_epoch = t_load = time.perf_counter()
        for step_idx, batch in enumerate(train_loader):
            if max_steps and step_idx >= max_steps:
                break
            t0 = time.time()
            batch = batch_to(batch, device)
            batch["w_aug"] = torch.tensor(w_aug, device=device)
            stats["load_s"] += time.perf_counter() - t_load
            H, W = batch["imgs"].shape[2:4]
            if (profile_steps and main_rank and step_idx == 3
                    and epoch == start_epoch):
                prof = _start_profile(device)
                profile_until = gstep0 + step_idx + profile_steps
            with torch.profiler.record_function("train_step"):
                metrics = train_step(state, batch,
                                     draw_step(gen, config, B * world, H,
                                               W))
            gstep = gstep0 + step_idx + 1
            stats["train_steps"] += 1
            if prof is not None and gstep >= profile_until:
                prof = _stop_profile(prof, logdir, device)
            images = metrics.pop("images")
            if main_rank and gstep % run.summary_freq == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["step_time"] = time.time() - t0
                t_log = time.perf_counter()
                logger.log("train", host, gstep)
                logger.log_images("train", {k: v.cpu().numpy()
                                            for k, v in images.items()},
                                  gstep)
                meter.update(host)
                print(f"epoch {epoch} step {step_idx}/{steps_per_epoch} "
                      f"loss {host['loss']:.3f} "
                      f"time {host['step_time']:.2f}s", flush=True)
                stats["log_s"] += time.perf_counter() - t_log
            t_load = time.perf_counter()
        if prof is not None:
            # the epoch ended mid-trace: flush it before saving/validating
            prof = _stop_profile(prof, logdir, device)
        _sync(device)
        stats["epoch_s"].append(time.perf_counter() - t_epoch)
        gstep = (epoch + 1) * steps_per_epoch
        if meter.count:                    # rank 0 alone logs steps
            logger.log("fulltrain", meter.mean(), gstep)
            if (epoch + 1) % run.save_freq == 0:
                t0 = time.perf_counter()
                save_checkpoint(logdir, state, epoch)
                stats["save_s"].append(time.perf_counter() - t0)

        # supervised validation (monitoring only)
        if epoch % run.eval_freq == 0 or epoch == run.epochs - 1:
            vmeter = DictAverageMeter()
            t0 = time.perf_counter()
            for vi, batch in enumerate(val_loader):
                if max_steps and vi >= max_steps:
                    break
                vmetrics = val_step(state, batch_to(batch, device))
                vmeter.update({k: float(v) for k, v in vmetrics.items()})
            stats["val_s"] += time.perf_counter() - t0
            stats["val_batches"] += vmeter.count
            if main_rank:
                logger.log("fulltest", vmeter.mean(), gstep)
            say(f"epoch {epoch} val: {vmeter.mean()}", flush=True)
    if main_rank:
        logger.close()
    return {"state": state, **stats}


def _start_profile(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, logdir, device):
    _sync(device)
    prof.stop()
    out = Path(logdir) / "profile"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"profile trace -> {out}", flush=True)
    return None


def _banner(world: int, config: Config) -> None:
    """The JAX CLI's line; here one device per process."""
    print(f"mesh: {world} devices / {world} process(es), global batch "
          f"{config.run.batch_size * world}", flush=True)


def _fit_kwargs(args) -> dict:
    return dict(resume=args.resume, max_steps=args.max_steps,
                profile_steps=args.profile_steps, plain=args.no_pallas)


def _train_rank(rank: int, world: int, device, args) -> None:
    """One rank of a data-parallel run (its group already joined)."""
    if device.type == "cuda":
        set_full_precision()
    config = config_from_args(args)
    if rank == 0:
        _banner(world, config)
    config, train_ds, val_ds = build_datasets(config, world)
    fit(config, train_ds, val_ds, device, group=mesh.batch_group(),
        **_fit_kwargs(args))


def main(argv=None):
    args = parse_args(argv)
    dev_type = torch.device(args.device).type
    if args.multihost or any(v is not None for v in (
            args.coordinator_address, args.num_processes, args.process_id)):
        device = mesh.initialize_multihost(
            args.coordinator_address, args.num_processes, args.process_id,
            device_type=dev_type)
        try:
            world = mesh.world_size()
            if args.n_devices not in (None, world):
                raise SystemExit(
                    f"--n_devices {args.n_devices} disagrees with the "
                    f"{world}-process run (one device per process); omit "
                    "it")
            _train_rank(mesh.rank(), world, device, args)
        finally:
            mesh.dist.destroy_process_group()
        return
    if (args.n_devices or 1) > 1:
        mesh.spawn(_train_rank, args.n_devices, (args,),
                   device_type=dev_type)
        return
    device = resolve_device(args.device)
    config = config_from_args(args)
    _banner(1, config)
    config, train_ds, val_ds = build_datasets(config)
    fit(config, train_ds, val_ds, device, **_fit_kwargs(args))


if __name__ == "__main__":
    main()
