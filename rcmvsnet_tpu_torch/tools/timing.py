"""Timing and device labels shared by the profiling tools and chip_smoke.py.

On a CUDA device a time is the median of `reps` CUDA-event timings of one
call each, after `warmup` calls. On the CPU (`--device cpu`, for tests)
it is the same median on the host clock, and every line says so: no CPU
number stands for a device metric.

An event time spans whatever the device does between the two events,
the host's launch latency included when the device waits for it. Two
more times split it: `device_ms`, the kernels' own durations as
`torch.profiler` (CUPTI) records them, and `host_ms`, the host clock
around one call with the device idle before it (the wrapper's checks,
allocations and launch).
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or a
    note that times are host-clock CPU times."""
    if device.type != "cuda":
        return "cpu (host clock; no device metric)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return smi[device.index or 0]


def make_timer(device: torch.device, reps: int = 7, warmup: int = 2):
    """timer(fn) → median ms of one fn() call on `device`."""
    def one_call(fn) -> float:
        if device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def timer(fn) -> float:
        for _ in range(warmup):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return statistics.median(one_call(fn) for _ in range(reps))
    return timer


def device_ms(fn, device: torch.device, reps: int = 20, warmup: int = 2,
              match: str | None = None):
    """(mean device ms of one fn() call, kernel names): the summed
    durations of the CUDA kernels `torch.profiler` records over `reps`
    calls (those whose name holds `match`, where given), divided by reps.
    (None, []) on the CPU, or where the profiler records no such device
    activity ("not measured")."""
    if device.type != "cuda":
        return None, []
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (match is None or match in e.name)]
    if not kernels:
        return None, []
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return us / 1e3 / reps, sorted({e.name for e in kernels})


def host_ms(fn, device: torch.device, reps: int = 20, warmup: int = 2):
    """Median host-clock ms of one fn() call with the device idle before
    it: the time the caller's thread spends in the call (on a CUDA device,
    to check, allocate and enqueue; on the CPU, the whole call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return statistics.median(times)
