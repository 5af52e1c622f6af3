"""A/B timing of K6 (`ops/warp_variance.warp_variance_bwd`) and K7's
backward (`ops/warp_volume.warp_volume_bwd`) for builds of their CUDA
sources, in turns, on one card.

Each argument is a directory holding `warp_variance.cu`, `warp_volume.cu`,
`warp_common.cuh` and `warp_bwd.cuh` with the package's C interface
(default: the package's own `ops/csrc/`). Every build runs the same inputs,
the train step's warps (`tools/repeat_warp_bwd.train_inputs`: K6 at the
three stages, K7's backward at stage 1); the builds take turns A, B, ...,
B, A, each call's time is the smaller of its build's two turns (each the
median of 7 CUDA-event timings, `tools/timing`), and before it is timed
each result is held to its plain version (1e-4 of the largest value) and
to a second call of itself (every bit).

Usage:
  python -m rcmvsnet_tpu_torch.tools.ab_warp_bwd [SRC_DIR ...]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..cli.eval_dtu import resolve_device
from ..ops import _build
from .repeat_warp_bwd import SEED, differ, train_inputs
from .timing import device_label, make_timer

LIBS = ("warp_variance", "warp_volume")


def run(device, srcs) -> dict:
    """{label: [ms of each build]} and the totals, printed per call."""
    builds = [_build.load_from(Path(s), LIBS) for s in srcs]
    gen = torch.Generator(device=device).manual_seed(SEED)
    calls = train_inputs(device, gen)
    timer = make_timer(device)
    order = list(range(len(builds))) + list(reversed(range(len(builds))))
    ms = {label: [float("inf")] * len(builds) for label, _, _ in calls}
    for i in order:
        _build._libs.update(builds[i])    # the wrappers now launch build i
        for label, fk, fp in calls:
            got, again, want = fk(), fk(), fp()
            err = max(float((a - p).abs().max() / p.abs().max())
                      for a, p in zip(got, want))
            if not err <= 1e-4 or differ(got, again)["differing"]:
                raise AssertionError(f"{srcs[i]} {label}: error {err:.2e}, "
                                     f"repeat {differ(got, again)}")
            ms[label][i] = min(ms[label][i], timer(fk))
    for label, row in ms.items():
        print(f"{label:36s} " + "  ".join(f"{t:8.3f}" for t in row))
    totals = [sum(row[i] for row in ms.values()) for i in range(len(srcs))]
    print(f"{'total ms':36s} " + "  ".join(f"{t:8.3f}" for t in totals))
    return {"ms": ms, "total_ms": totals}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("srcs", nargs="*", default=[str(_build.CSRC)])
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    label = device_label(device)
    print(f"device: {label} | builds: {' '.join(args.srcs)}")
    res = run(device, args.srcs)
    print(json.dumps({"device": label, "builds": args.srcs, **res}))
    return res


if __name__ == "__main__":
    main()
