"""Data parallelism over `torch.distributed`: one process per device.

Counterpart of `rcmvsnet_tpu/parallel/mesh.py`, with the semantics its
mesh gives a train step: the global batch is `batch_size × world`; every
BatchNorm statistic and every loss is taken over the global batch; the
gradients are those of the global loss; every rank holds the same
parameters after every step; only rank 0 logs and checkpoints.

The process model is PyTorch's own, which is where the port deviates from
the JAX package (one process per host, `jit` over a mesh of its devices):
one process owns one device, as in the reference's `mp.spawn` + DDP
launch (its train_rcmvsnet.py:502-606).
  * `spawn(fn, world, ...)` starts `world` workers on one host that meet
    through a `FileStore` in a fresh temporary directory (no TCP port to
    race for); worker r binds `devices[r]` (`cuda:r` by default).
  * `initialize_multihost(...)` joins a group that spans hosts:
    `tcp://host:port` with an explicit world size and rank, or, with no
    arguments, `torchrun`'s environment (`RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) in place of JAX's cluster
    autodetection.
  * The backend is NCCL on CUDA and Gloo on the CPU unless named (Gloo
    also reduces CUDA tensors, which lets two ranks share one card; NCCL
    refuses that).

The reductions. A loss term that is a plain mean over equal per-rank
shapes stays each rank's own mean: the ranks' gradients of their own
means, summed and divided by the world size (`allreduce_gradients`), are
the gradient of the global mean. A sum across ranks is needed where a
rank's own rows do not give the global value's gradient: a BatchNorm
statistic (`sync_bn.py`), a masked mean (`global_masked_mean`: the
ranks' mask counts differ) and the per-view reconstruction scalar that
every rank's pixels then use (`global_mean`). Each is `all_sum`, an
all-reduce with autograd (`torch.distributed.nn.functional.all_reduce`,
whose backward all-reduces the gradient, since the ranks use the sum each
in their own way): each rank's backward then yields world × its share of
the gradient, which the divide in `allreduce_gradients` brings back. The
logged values, the plain means among them, are averaged over the ranks
once after the step (`average_scalars`, one flattened buffer).
The train step does not wrap the models in `DistributedDataParallel`: it
runs the same modules three times before its one backward, and DDP's
reducer fires per parameter in autograd-hook order.

`shard_batch`'s role is the loader's: `data/loader.DataLoader` with
`process_index` / `process_count` gives each rank its rows of the global
batch (the same number on every rank, the tail dropped).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from ..ops.image import masked_mean


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process(rank: int, world: int, init_method: str, device,
                 backend: Optional[str] = None) -> torch.device:
    """Bind `device` (`torch.cuda.set_device` for a card, so the ctypes
    kernels launch there) and join the group. Returns the device."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend or backend_for(device),
                            init_method=init_method, world_size=world,
                            rank=rank)
    return device


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device_type: str = "cuda",
                         backend: Optional[str] = None) -> torch.device:
    """Join a group across hosts: `coordinator_address` (host:port of
    rank 0) with `num_processes` and `process_id`, or, with all three
    None, `torchrun`'s environment. The device is `cuda:<local rank>`
    (LOCAL_RANK, else the rank modulo the host's card count), or the CPU
    under device_type "cpu"."""
    explicit = (coordinator_address, num_processes, process_id)
    if all(v is None for v in explicit):
        env = {k: os.environ.get(k) for k in
               ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
        missing = [k for k, v in env.items() if v is None]
        if missing:
            raise SystemExit(f"--multihost: {missing} not set (run under "
                             f"torchrun, or pass --coordinator_address, "
                             f"--num_processes and --process_id)")
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = "env://"
        local = os.environ.get("LOCAL_RANK")
    elif any(v is None for v in explicit):
        raise SystemExit("--coordinator_address, --num_processes and "
                         "--process_id go together")
    else:
        rank, world = process_id, num_processes
        init_method = f"tcp://{coordinator_address}"
        local = None
    if device_type == "cpu":
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise SystemExit("multi-host run: no CUDA device available "
                             "(pass --device cpu to run on the CPU)")
        idx = int(local) if local is not None else (
            rank % torch.cuda.device_count())
        device = torch.device("cuda", idx)
    return init_process(rank, world, init_method, device, backend)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 guard for logging and checkpoints (the reference's
    `dist.get_rank() == 0`)."""
    return rank() == 0


def batch_group():
    """The group the global batch spans, or None when there is one rank
    (then nothing reduces across ranks and the single-device path runs as
    it is)."""
    return dist.group.WORLD if world_size() > 1 else None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of x, with autograd (the backward all-reduces the
    gradient; see the module doc); x itself when group is None."""
    return x if group is None else dist_nn.all_reduce(x, group=group)


def global_mean(x: torch.Tensor, group) -> torch.Tensor:
    """x.mean() over every rank's x (each rank's x the same shape):
    Σ_r mean_r / world, with autograd (see the module doc)."""
    if group is None:
        return x.mean()
    return all_sum(x.mean(), group) / group_size(group)


def global_masked_mean(values: torch.Tensor, mask: torch.Tensor,
                       group) -> torch.Tensor:
    """`ops/image.masked_mean` over every rank's entries: Σ v·m and Σ m
    each summed over the ranks (the denominator detached). A mean of
    per-rank masked means would not be this when the counts differ."""
    if group is None:
        return masked_mean(values, mask)
    mask = mask.to(values.dtype)
    num = all_sum((values * mask).sum(), group)
    den = all_sum(mask.sum().detach(), group)
    return num / torch.clamp(den, min=1e-10)


def average_scalars(values: dict, group) -> dict:
    """{name: 0-d tensor} averaged over the ranks in one flattened
    all-reduce (in the dict's order); `values` itself when group is
    None."""
    if group is None:
        return values
    keys = list(values)
    buf = torch.stack([values[k].detach().reshape(()) for k in keys])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    buf /= group_size(group)
    return dict(zip(keys, buf.unbind()))


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> None:
    """Apply the in-place collective `op` to the tensors, flattened into
    one buffer per dtype (in their order), and copy the result back."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        op(flat)
        off = 0
        for t in ts:
            n = t.numel()
            t.detach().copy_(flat[off:off + n].view_as(t))
            off += n


def allreduce_gradients(params, group) -> None:
    """Every parameter's gradient summed over the ranks and divided by
    their number (see the module doc): one flattened buffer in parameter
    order, one all-reduce. Parameters without a gradient (the same ones
    on every rank: the ranks run the same graph) are left without one."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    world = group_size(group)

    def mean(buf):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        buf.div_(world)
    _flat_collective(grads, mean)


def replicate(*modules, group, src: int = 0) -> None:
    """Broadcast every parameter and buffer of the modules from rank
    `src` of `group` (None: one rank, nothing to do), in place, so every
    rank starts from the same state (a same-seed init gives it already;
    rank-dependent loading need not)."""
    if group is None:
        return
    tensors = [t for m in modules
               for t in m.state_dict(keep_vars=True).values()]
    _flat_collective(tensors, lambda b: dist.broadcast(b, src=src,
                                                       group=group))


def gather_probe(values: Sequence[float], group) -> torch.Tensor:
    """[world, len(values)] float64: every rank's `values`, in rank
    order (on the CPU; a NCCL group gathers on the rank's card)."""
    t = torch.tensor(list(values), dtype=torch.float64)
    if group is None:
        return t[None]
    if dist.get_backend(group) == "nccl":
        t = t.cuda()
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out).cpu()


def _worker(local_rank: int, fn: Callable, world: int, init_method: str,
            devices: Sequence, backend: Optional[str], threads: int,
            args: tuple) -> None:
    device = torch.device(devices[local_rank])
    if device.type == "cpu":
        torch.set_num_threads(threads)
    device = init_process(local_rank, world, init_method, device, backend)
    try:
        fn(local_rank, world, device, *args)
    finally:
        dist.destroy_process_group()


def default_devices(world: int, device_type: str) -> list:
    """cuda:0 … cuda:world−1, or the CPU `world` times."""
    if device_type == "cpu":
        return ["cpu"] * world
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device available (pass --device cpu to "
                         "run on the CPU)")
    if torch.cuda.device_count() < world:
        raise SystemExit(f"{world} devices asked for, "
                         f"{torch.cuda.device_count()} CUDA devices here")
    return [f"cuda:{r}" for r in range(world)]


def spawn(fn: Callable, world: int, args: tuple = (), *,
          devices: Optional[Sequence] = None, device_type: str = "cuda",
          backend: Optional[str] = None,
          timeout: Optional[float] = None) -> None:
    """Run fn(rank, world, device, *args) in `world` new processes of this
    host (start method "spawn"), joined into one group through a
    FileStore in a fresh temporary directory. devices: one per rank
    (default `default_devices`); two ranks may share a card under the
    Gloo backend. A worker that raises fails the call (the others are
    stopped); past `timeout` seconds every worker is killed and
    TimeoutError raised. On the CPU each worker takes its share of the
    host's cores, or OMP_NUM_THREADS."""
    import torch.multiprocessing as mp
    devices = list(devices or default_devices(world, device_type))
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    threads = int(os.environ.get("OMP_NUM_THREADS", 0)) or max(
        1, (os.cpu_count() or 1) // world)
    store = tempfile.mkdtemp(prefix="rcmvsnet_dp_")
    ctx = mp.start_processes(
        _worker, args=(fn, world, f"file://{store}/store", devices, backend,
                       threads, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s; killed")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
