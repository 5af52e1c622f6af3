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
each result is held to its plain version (1e-4 of the largest value; a
bf16 instance one bf16 ulp of each element + 1e-4), to a second call of
itself and to the first build's result (every bit, `torch.equal`); the
tool exits non-zero after its report if a build's output differs from the
first build's. The bf16 instances ("bf16 ..." calls) run on the builds
whose libraries export them ("n/a" elsewhere).

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
from .repeat_warp_bwd import (BF16_ENTRY, SEED, differ, train_inputs,
                              within_plain)
from .timing import device_label, make_timer

LIBS = ("warp_variance", "warp_volume")


def run(device, srcs) -> dict:
    """{label: [ms of each build]} and the totals, printed per call."""
    builds = [_build.load_from(Path(s), LIBS) for s in srcs]
    gen = torch.Generator(device=device).manual_seed(SEED)
    calls = train_inputs(device, gen)
    timer = make_timer(device)
    order = list(range(len(builds))) + list(reversed(range(len(builds))))
    ms = {label: [None] * len(builds) for label, _, _ in calls}
    equal = {label: [True] * len(builds) for label, _, _ in calls}
    first = {}
    for i in order:
        _build._libs.update(builds[i])    # the wrappers now launch build i
        for label, fk, fp in calls:
            entry = (BF16_ENTRY[label.split()[1]]
                     if label.startswith("bf16 ") else None)
            if entry and not hasattr(builds[i][entry[0]], entry[1]):
                continue                  # this build has no such instance
            got, again, want = fk(), fk(), fp()
            ok = all(within_plain(a, p) for a, p in zip(got, want))
            if not ok or differ(got, again)["differing"]:
                raise AssertionError(f"{srcs[i]} {label}: beyond the plain "
                                     f"version's tolerance ({ok}) or "
                                     f"repeat {differ(got, again)}")
            ref = first.setdefault(label, got)
            equal[label][i] &= all(bool(torch.equal(a, b))
                                   for a, b in zip(got, ref))
            t = timer(fk)
            ms[label][i] = t if ms[label][i] is None else min(ms[label][i], t)
    fmt = lambda t: "     n/a" if t is None else f"{t:8.3f}"
    for label, row in ms.items():
        print(f"{label:41s} " + "  ".join(
            f"{fmt(t)}{'' if e else ' (differs)'}"
            for t, e in zip(row, equal[label])))
    f32 = [label for label in ms if not label.startswith("bf16 ")]
    totals = [sum(ms[label][i] for label in f32) for i in range(len(srcs))]
    print(f"{'total ms (float32)':41s} " + "  ".join(f"{t:8.3f}"
                                                     for t in totals))
    return {"ms": ms, "total_ms": totals, "equal_to_first": equal}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("srcs", nargs="*", default=[str(_build.CSRC)])
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    label = device_label(device)
    print(f"device: {label} | builds: {' '.join(args.srcs)}")
    res = run(device, args.srcs)
    print(json.dumps({"device": label, "builds": args.srcs, **res}))
    if not all(all(v) for v in res["equal_to_first"].values()):
        raise SystemExit("ab_warp_bwd: a build's output differs from the "
                         "first build's")
    return res


if __name__ == "__main__":
    main()
