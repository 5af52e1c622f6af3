"""A/B timing of K6 (`ops/warp_variance.warp_variance_bwd`) and K7's
backward (`ops/warp_volume.warp_volume_bwd`) for builds of their CUDA
sources, in turns, on one card.

Each argument is a directory holding `warp_variance.cu`, `warp_volume.cu`,
`warp_common.cuh` and `warp_bwd.cuh` with the package's C interface and,
where the build has them, `warp_variance_bf16.cu`, `warp_volume_bf16.cu`
and `warp_bf16.cuh` (older builds export K6-bf16 from `warp_variance.cu`
and K7bwd-bf16 from `warp_volume.cu`: `ab_warp_fwd.load_builds`);
default: the package's own `ops/csrc/`. Every build runs the same inputs,
the train step's warps (`tools/repeat_warp_bwd.train_inputs`: K6 at the
three stages, K7's backward at stage 1); the builds take turns A, B, ...,
B, A, A, B, ... for `--rounds` rounds (default 2), each call's time is the
least of its build's turns (each the median of 7 CUDA-event timings,
`tools/timing`), and before it is timed
each result is held to its plain version (1e-4 of the largest value; a
bf16 instance one bf16 ulp of each element + 1e-4), to a second call of
itself and to the first build's result (every bit, `torch.equal`); the
tool exits non-zero after its report if a build's output differs from the
first build's. The bf16 instances ("bf16 ..." calls) run on the builds
whose libraries export them ("n/a" elsewhere). The report ends with the
float32 and bf16 totals, of K6 over its three stages and of all calls.

Usage:
  python -m rcmvsnet_tpu_torch.tools.ab_warp_bwd [--rounds N] [SRC_DIR ...]
"""
from __future__ import annotations

import argparse
import json

import torch

from ..cli.eval_dtu import resolve_device
from ..ops import _build
from .ab_warp_fwd import load_builds, total_ms, turns
from .repeat_warp_bwd import (BF16_ENTRY, SEED, differ, train_inputs,
                              within_plain)
from .timing import device_label, make_timer


def run(device, srcs, rounds=2) -> dict:
    """{label: [ms of each build]} and the totals, printed per call."""
    builds = load_builds(srcs)
    gen = torch.Generator(device=device).manual_seed(SEED)
    calls = train_inputs(device, gen)
    timer = make_timer(device)
    order = turns(len(builds), rounds)
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
    totals = {kind: total_ms(ms, [label for label in ms
                                  if label.startswith(prefix)], len(srcs))
              for kind, prefix in (
                  ("K6 float32", "warp_variance_bwd "),
                  ("K6 bf16", "bf16 warp_variance_bwd "),
                  ("float32", "warp_"), ("bf16", "bf16 "))}
    for kind, row in totals.items():
        print(f"{'total ms, ' + kind:41s} " + "  ".join(fmt(t) for t in row))
    return {"ms": ms, "total_ms": totals, "equal_to_first": equal}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("srcs", nargs="*", default=[str(_build.CSRC)])
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    label = device_label(device)
    print(f"device: {label} | builds: {' '.join(args.srcs)}")
    res = run(device, args.srcs, args.rounds)
    print(json.dumps({"device": label, "builds": args.srcs, **res}))
    if not all(all(v) for v in res["equal_to_first"].values()):
        raise SystemExit("ab_warp_bwd: a build's output differs from the "
                         "first build's")
    return res


if __name__ == "__main__":
    main()
