"""Timing and device labels shared by the profiling tools and chip_smoke.py.

On a CUDA device a time is the median of `reps` CUDA-event timings of one
call each, after `warmup` calls. On the CPU (`--device cpu`, for tests)
it is the same median on the host clock, and every line says so: no CPU
number stands for a device metric.
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
