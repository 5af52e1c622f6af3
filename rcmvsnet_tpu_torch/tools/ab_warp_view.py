"""A/B timing of K10 (`ops/warp_view.warp_view`, the per-view plane-sweep
warp) for builds of its CUDA source, in turns, on one card, with the
builds' outputs held equal bit for bit.

Each argument is a directory holding `warp_view.cu` and the shared
headers (`warp_common.cuh` and whatever else the source includes);
default: the package's own `ops/csrc/`. Every build runs the same 12
calls, K10 at each source view of each stage of one DTU depth map as
`tools/profile_breakdown` runs them (864×1152, V=5: stage 1 216×288,
C=32, 48 planes; stage 2 432×576, C=16, 32 planes; stage 3 864×1152,
C=8, 8 planes; the golden backbone's features of the plane scene,
coordinates from `ops/warp_view.pixel_coords`). K10 runs through the
package's wrapper, which launches the build whose library it is handed.
The builds take turns A, B, ..., B, A, A, B, ... for `--rounds` rounds
(default 4); each call's time is the smallest of its build's turns (each
the median of 7 CUDA-event timings, `tools/timing`), printed with the
largest. Before it is timed, each result is held to `warp_view_plain`
(within 1e-5 of the largest value) and to the first build's result with
`torch.equal` (every bit). The report gives per stage and in sum each
build's least time beside the bound (max of bytes ÷ 3.35 TB/s and
FLOPs ÷ 67 TFLOP/s per call, as `chip_smoke.py` counts them),
`F.grid_sample`'s time for the same sampling, and the time of writing the
output alone (one `fill_` of a tensor of its shape: what the card's
stores take with no gathers); the tool fails after it if any output
differs. On the CPU (`run(torch.device("cpu"), ...)`, for
tests) nothing is built and every build is the plain version.

Usage:
  python -m rcmvsnet_tpu_torch.tools.ab_warp_view [--rounds N] [SRC_DIR ...]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch
import torch.nn.functional as F

from ..cli.eval_dtu import resolve_device
from ..ops import _build
from ..ops import warp_view as K10
from ..ops.warp_variance import relative_projections
from .ab_warp_fwd import spread_line, turns
from .timing import device_label, make_timer

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12              # f32, outside the tensor cores
TOL = 1e-5


def view_inputs(device, dtu=None):
    """[(label, (src, px, py))]: K10's calls of one DTU depth map, each
    source view of each stage of `profile_breakdown.stage_inputs`.
    dtu: (H, W, V), default profile_breakdown's."""
    from ..data.plane_scene import dtu_samples, plane_scene
    from ..models.cascade import CascadeMVSNet
    from ..weights import ASSET, load_state_dict
    from . import profile_breakdown as PB

    H, W, V = dtu or (PB.H, PB.W, PB.VIEWS)
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model = model.to(device).eval()
    sample = dtu_samples(plane_scene(H, W, V, PB.SEED), PB.NDEPTH)[0]
    calls = []
    with torch.no_grad():
        for st in PB.stage_inputs(model, sample, device):
            f, nd = st["feats"], st["nd"]
            Vn, h, w, C = f.shape
            rel = relative_projections(st["projs"]).reshape(-1, 4, 4)
            for v in range(1, Vn):
                px, py = (c[0].contiguous() for c in K10.pixel_coords(
                    rel[v:v + 1], st["dv"][None], h, w))
                calls.append((f"{st['key']} view{v} {h}x{w} C{C} D{nd}",
                              (f[v].contiguous(), px, py)))
    return calls


def bound_ms(src, px) -> float:
    """The least time of one call: inputs read once, the output written
    once, 8C + 10 FLOPs a sample (chip_smoke.py's count)."""
    h, w, C = src.shape
    n = px.numel()
    n_bytes = 4 * (h * w * C + 2 * n + n * C)
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S,
                     n * (8 * C + 10) / F32_FLOPS_PER_S)


def grid_sample_call(src, px, py):
    """One `F.grid_sample` call for the same sampling (bilinear, zeros,
    corners aligned), [1, C, D·h, w]: the library yardstick."""
    h, w, C = src.shape
    D = px.shape[0]
    x = src.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([px / ((w - 1) / 2.0) - 1.0,
                        py / ((h - 1) / 2.0) - 1.0], -1).reshape(
                            1, D * h, w, 2)
    return lambda: F.grid_sample(x, grid, align_corners=True)


def run(device, srcs, rounds=4, dtu=None) -> dict:
    """Per call label: every turn's ms of each build, the plain error of
    each build and whether its output equals the first build's in every
    bit; per stage and in sum each build's least ms, the bound and
    F.grid_sample's ms."""
    srcs = [str(s) for s in srcs]
    builds = [None] * len(srcs)
    if device.type == "cuda":
        builds = [_build.load_from(Path(s), ("warp_view",)) for s in srcs]
    calls = view_inputs(device, dtu)
    timer = make_timer(device)
    turn_ms = {label: [[] for _ in srcs] for label, _ in calls}
    errors = {label: [None] * len(srcs) for label, _ in calls}
    equal = {label: [True] * len(srcs) for label, _ in calls}
    bound = {label: bound_ms(a[0], a[1]) for label, a in calls}
    library, fill = {}, {}
    first = {}
    with torch.no_grad():
        plain = {label: K10.warp_view_plain(*a) for label, a in calls}
        for label, a in calls:
            library[label] = timer(grid_sample_call(*a))
            blank = torch.empty_like(plain[label])
            fill[label] = timer(lambda: blank.fill_(1.0))
            del blank
        for i in turns(len(srcs), rounds):
            if builds[i] is not None:   # the wrapper now launches build i
                _build._libs.update(builds[i])
            for label, args in calls:
                fn = lambda a=args: K10.warp_view(*a)
                got = fn()
                want = plain[label]
                err = float((got - want).abs().max() / want.abs().max())
                errors[label][i] = max(err, errors[label][i] or 0.0)
                ref = first.setdefault(label, got)
                equal[label][i] &= bool(torch.equal(got, ref))
                del got
                turn_ms[label][i].append(timer(fn))
    ms = {label: [min(t) for t in row] for label, row in turn_ms.items()}
    stages = {}
    for label in ms:
        stages.setdefault(label.split()[0], []).append(label)
    sums = {}
    for key, labels in list(stages.items()) + [("total", list(ms))]:
        sums[key] = {"ms": [sum(ms[lab][i] for lab in labels)
                            for i in range(len(srcs))],
                     "bound_ms": sum(bound[lab] for lab in labels),
                     "library_ms": sum(library[lab] for lab in labels),
                     "fill_ms": sum(fill[lab] for lab in labels)}
    for label, row in turn_ms.items():
        print(spread_line(label, row) + "  err: " + " ".join(
            f"{e:.1e}" for e in errors[label]) + "  equal: " + " ".join(
                "yes" if e else "NO" for e in equal[label]))
    for key, s in sums.items():
        print(f"{key + ' ms (least)':36s} "
              + "  ".join(f"{t:15.3f}" for t in s["ms"])
              + f"  bound {s['bound_ms']:.3f}  grid_sample "
              f"{s['library_ms']:.3f}  fill {s['fill_ms']:.3f}")
    return {"ms": ms, "turns_ms": turn_ms, "sums": sums, "errors": errors,
            "bit_equal": equal}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("srcs", nargs="*", default=[str(_build.CSRC)])
    p.add_argument("--rounds", type=int, default=4)
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    label = device_label(device)
    print(f"device: {label} | builds: {' '.join(args.srcs)}")
    res = run(device, args.srcs, args.rounds)
    print(json.dumps({"device": label, "builds": args.srcs, **res}))
    bad = [lab for lab, row in res["errors"].items()
           if not all(e <= TOL for e in row)]
    differ = [lab for lab, row in res["bit_equal"].items() if not all(row)]
    if bad or differ:
        raise SystemExit(f"ab_warp_view: outside {TOL} of the plain "
                         f"version at {bad}; differ from the first build "
                         f"at {differ}")
    return res


if __name__ == "__main__":
    main()
