"""Checkpoints in the reference's two-artifact torch format.

Counterpart of `rcmvsnet_tpu/train/checkpoint.py` (`save_checkpoint`,
`latest_epoch`, `restore_checkpoint`), writing the reference's own files
(its train_rcmvsnet.py:214-226) instead of msgpack:
  * `model_{epoch:06d}_cas.ckpt`  = {"epoch", "model": the cascade's
    state_dict, "optimizer": the Adam state_dict (backbone ∪ render
    parameters, one optimizer), "step"};
  * `model_{epoch:06d}_nerf.ckpt` = {"model": the render branch's
    state_dict}.
Names are the reference's, so the JAX package's `train/convert.py` and the
port's `weights.load_state_dict` read them. Resuming takes the newest
epoch (the reference's resume scan, train_rcmvsnet.py:542-557). In data
parallelism only rank 0 writes (`save_checkpoint` does nothing on the
others); every rank restores, and `check_restored` refuses ranks that
restored different states.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

from ..parallel.mesh import gather_probe, is_main_process
from .state import TrainState

_CAS_RE = re.compile(r"model_(\d+)_cas\.ckpt$")


def checkpoint_paths(logdir, epoch: int) -> tuple[Path, Path]:
    """(cas, nerf) paths of `epoch` under `logdir`."""
    logdir = Path(logdir)
    return (logdir / f"model_{epoch:06d}_cas.ckpt",
            logdir / f"model_{epoch:06d}_nerf.ckpt")


def save_checkpoint(logdir, state: TrainState, epoch: int) -> None:
    """Write epoch's cas and nerf files (on rank 0 only)."""
    if not is_main_process():
        return
    Path(logdir).mkdir(parents=True, exist_ok=True)
    cas, nerf = checkpoint_paths(logdir, epoch)
    torch.save({"epoch": epoch, "model": state.cascade.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, cas)
    torch.save({"model": state.render.state_dict()}, nerf)


def latest_epoch(logdir) -> Optional[int]:
    epochs = []
    if os.path.isdir(logdir):
        for fn in os.listdir(logdir):
            m = _CAS_RE.search(fn)
            if m:
                epochs.append(int(m.group(1)))
    return max(epochs) if epochs else None


def restore_checkpoint(logdir, state: TrainState,
                       epoch: Optional[int] = None):
    """Load the newest (or the given) epoch's pair into `state` in place:
    both models (strict), the optimizer (its tensors land on the
    parameters' device) and the step, so the lr schedule continues.
    Returns (state, start_epoch); (state, 0) when there is none."""
    if epoch is None:
        epoch = latest_epoch(logdir)
    if epoch is None:
        return state, 0
    cas_path, nerf_path = checkpoint_paths(logdir, epoch)
    cas = torch.load(cas_path, map_location="cpu")
    nerf = torch.load(nerf_path, map_location="cpu")
    state.cascade.load_state_dict(cas["model"], strict=True)
    state.render.load_state_dict(nerf["model"], strict=True)
    state.optimizer.load_state_dict(cas["optimizer"])
    state.step = int(cas["step"])
    return state, int(cas["epoch"]) + 1


def check_restored(state: TrainState, start_epoch: int, group) -> None:
    """Refuse a data-parallel resume whose ranks restored different states
    (JAX `cli/train.py:247-270`): every rank's (epoch, step, Σ|p| of the
    first 8 parameter tensors) is gathered and must agree."""
    if group is None:
        return
    params = list(state.cascade.parameters()) + list(
        state.render.parameters())
    probe = [float(start_epoch), float(state.step)] + [
        float(p.detach().abs().sum()) for p in params[:8]]
    got = gather_probe(probe, group)
    if not torch.allclose(got, got[0].expand_as(got)):
        raise SystemExit("data-parallel --resume restored inconsistent "
                         "state across ranks (epoch, step or parameters "
                         "differ): every rank must read the same "
                         f"checkpoint\n{got.numpy()}")
