"""A/B timing of K2 (`ops/conv3d.conv3d`) and K8's weight gradient
(`ops/conv3d_train.conv3d_dw`) for builds of their CUDA sources, in turns,
on one card.

Each argument is a directory holding `conv3d.cu`, `conv3d_dw.cu` and
`tc_conv3d.cuh` with the package's C interface (default: the package's own
`ops/csrc/`). Every build runs the same inputs at the main paths' heaviest
shapes (CASES); the builds take turns A, B, ..., B, A, each case's time is
the smaller of its build's two turns (each the median of 7 CUDA-event
timings, `tools/timing`), and each result is held to its plain version
(1e-4 of the largest value) and to the first build's output in every bit
(`torch.equal`, reported per case and build) before it is timed; after
its report the tool exits non-zero if any output differs from the first
build's. The wrappers stay the package's: a build that changes the C
interface cannot be compared.

Usage:
  python -m rcmvsnet_tpu_torch.tools.ab_conv3d [SRC_DIR ...]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..cli.eval_dtu import resolve_device
from ..ops import _build
from ..ops import conv3d as K2
from ..ops import conv3d_train as K8
from .timing import device_label, make_timer

LIBS = ("conv3d", "conv3d_dw")
# (kernel, label, Ci, Co, input (D, H, W), mode): the DTU eval CostRegNets'
# largest convs (864x1152), the train step's (512x640) and the render
# U-Net's conv0 (128 planes at 128x160), forward, adjoint and dw
CASES = (
    ("k2", "S2 conv0 s1 16>8", 16, 8, (32, 432, 576), "s1"),
    ("k2", "S3 conv0 s1 8>8", 8, 8, (8, 864, 1152), "s1"),
    ("k2", "S3 prob s1 8>1", 8, 1, (8, 864, 1152), "s1"),
    ("k2", "S1 conv0 s1 32>8", 32, 8, (48, 216, 288), "s1"),
    ("k2", "render dx s1 8>41", 8, 41, (128, 128, 160), "s1"),
    ("k2", "S2 conv2 s1 16>16", 16, 16, (16, 216, 288), "s1"),
    ("k2", "S2 conv1 s2 8>16", 8, 16, (32, 432, 576), "s2"),
    ("k2", "S2 t2 16>8", 16, 8, (16, 216, 288), "t2"),
    ("k2", "S2 conv6 s1 64>64", 64, 64, (4, 54, 72), "s1"),
    ("k2", "S2 conv9 t2 32>16", 32, 16, (8, 108, 144), "t2"),
    ("dw", "render conv0 dw 41>8", 41, 8, (128, 128, 160), "s1"),
    ("dw", "cr1 conv0 dw 16>8", 16, 8, (32, 256, 320), "s1"),
    ("dw", "cr1 conv11 dw t2 16>8", 16, 8, (16, 128, 160), "t2"),
    ("dw", "cr1 prob dw 8>1", 8, 1, (32, 256, 320), "s1"),
    ("dw", "cr1 conv1 dw s2 8>16", 8, 16, (32, 256, 320), "s2"),
    ("dw", "cr1 conv4 dw 32>32", 32, 32, (8, 64, 80), "s1"),
    ("dw", "cr1 conv5 dw s2 32>64", 32, 64, (8, 64, 80), "s2"),
)


def case_calls(case, device, gen):
    """(kernel call, plain call) on inputs ~ N(0, 1), weights 0.1·N(0, 1)."""
    kind, _, ci, co, dhw, mode = case
    x = torch.randn(1, ci, *dhw, device=device, generator=gen)
    if kind == "dw":
        g = torch.randn(1, co, *K2.out_shape(mode, *dhw), device=device,
                        generator=gen)
        return (lambda: K8.conv3d_dw(x, g, mode),
                lambda: K8.conv3d_dw_plain(x, g, mode))
    wshape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    w = 0.1 * torch.randn(*wshape, device=device, generator=gen)
    b = torch.zeros(co, device=device)
    return (lambda: K2.conv3d(x, w, b, mode, relu=False),
            lambda: K2.conv3d_plain(x, w, b, mode, relu=False))


def run(device, srcs) -> dict:
    """{label: [ms of each build]} and the totals, printed per case."""
    builds = [_build.load_from(Path(s), LIBS) for s in srcs]
    gen = torch.Generator(device=device).manual_seed(0)
    calls = [(c[1], *case_calls(c, device, gen)) for c in CASES]
    timer = make_timer(device)
    order = list(range(len(builds))) + list(reversed(range(len(builds))))
    ms = {label: [float("inf")] * len(builds) for label, _, _ in calls}
    first, same = {}, {label: [True] * len(builds) for label, _, _ in calls}
    for i in order:
        _build._libs.update(builds[i])    # the wrappers now launch build i
        for label, fk, fp in calls:
            got, want = fk(), fp()
            err = float((got - want).abs().max() / want.abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"{srcs[i]} {label}: error {err:.2e}")
            ref = first.setdefault(label, got)
            same[label][i] = same[label][i] and torch.equal(got, ref)
            ms[label][i] = min(ms[label][i], timer(fk))
    for label, row in ms.items():
        print(f"{label:24s} " + "  ".join(
            f"{t:8.3f}{'' if ok else ' (differs)'}"
            for t, ok in zip(row, same[label])))
    totals = [sum(row[i] for row in ms.values()) for i in range(len(srcs))]
    print(f"{'total ms':24s} " + "  ".join(f"{t:8.3f}" for t in totals))
    return {"ms": ms, "total_ms": totals, "equal_to_first": same}


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
        raise SystemExit("ab_conv3d: a build's output differs from the "
                         "first build's")
    return res


if __name__ == "__main__":
    main()
