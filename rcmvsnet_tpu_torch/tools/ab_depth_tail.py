"""A/B timing of K4 (`ops/depth_tail.depth_tail`, softmax + depth
regression + confidence) for two or more trees of the port, in turns, on
one card, with each call's time split three ways.

Each argument is the root of a checkout of this repository (default: this
one). As in `ab_conv2d`, a tree brings its own wrapper and kernel (a K4
written in Triton or in CUDA): its package is imported under an alias and
builds into its own tree. Every tree runs the same inputs, K4 at the three
stages of a DTU depth map (cost [48, 216, 288], [32, 432, 576],
[8, 864, 1152]; costs 3·N(0, 1) and per-pixel hypothesis windows from a
seeded generator). The trees take turns A, B, ..., B, A, A, B, ... for
`--rounds` rounds (default 2). Per call and tree it prints three times:
  * event   the median of 7 CUDA-event timings of one call (`make_timer`:
            the events bracket the whole wrapper, so host latency the
            device waits for is in it), least and largest over the turns;
  * device  the kernel's own duration, `torch.profiler` (CUPTI), mean of
            20 calls, least over the turns ("not measured" where the
            profiler records no device activity);
  * host    the host clock around one wrapper call with the device idle
            (checks, allocations, launch), median of 20, least over the
            turns;
and per depth map (the three calls) the sums and device + host. Before it
is timed each result is held to the plain version (depth within relative
1e-5 per pixel, confidence beyond 1e-4 on at most 1e-3 of pixels) and to
the first tree's output in every bit (`torch.equal` on depth and
confidence, reported per call and tree); after its report the tool exits
non-zero if any output differs from the first tree's.

Usage:
  python -m rcmvsnet_tpu_torch.tools.ab_depth_tail [--rounds N] [TREE ...]
"""
from __future__ import annotations

import argparse
import importlib
import json
from pathlib import Path

import torch

from ..cli.eval_dtu import resolve_device
from ..ops.depth_tail import depth_tail_plain
from .ab_conv2d import ROOT, load_tree
from .ab_warp_fwd import turns
from .timing import device_label, device_ms, host_ms, make_timer

SEED = 5
# (label, D, h, w) of K4's calls in one DTU depth map (864x1152)
SHAPES = (("stage1", 48, 216, 288), ("stage2", 32, 432, 576),
          ("stage3", 8, 864, 1152))
DEPTH_REL, CONF_TOL, CONF_SHARE = 1e-5, 1e-4, 1e-3


def inputs(device, shapes=SHAPES):
    """{label: (cost, lo, step)}: stage 1 the full sweep 425..935, later
    stages windows around a depth that varies per pixel."""
    g = torch.Generator(device=device).manual_seed(SEED)
    out = {}
    for s, (label, D, h, w) in enumerate(shapes):
        cost = 3 * torch.randn(D, h, w, device=device, generator=g)
        if s == 0:
            lo = torch.full((h, w), 425.0, device=device)
            step = torch.full((h, w), 510.0 / (D - 1), device=device)
        else:
            lo = 425 + 500 * torch.rand(h, w, device=device, generator=g)
            step = (2.5 / s) * (1 + torch.rand(h, w, device=device,
                                               generator=g))
        out[f"{label} D{D} {h}x{w}"] = (cost, lo.contiguous(),
                                        step.contiguous())
    return out


def check(got, want) -> dict:
    """Depth's largest relative error and the share of pixels whose
    confidence differs by more than CONF_TOL."""
    (d, c), (dp, cp) = got, want
    rel = float(((d - dp).abs() / dp.abs().clamp_min(1e-12)).max())
    share = float(((c - cp).abs() > CONF_TOL).float().mean())
    return {"depth_max_rel": rel, "conf_share_above_tol": share}


def run(device, roots, rounds=2, shapes=SHAPES) -> dict:
    """Per call label and tree: the event, device and host ms of every
    turn; per tree the depth-map sums of each one's least."""
    roots = [str(r) for r in roots]
    k4 = []
    for i, root in enumerate(roots):
        load_tree(Path(root), f"_ab_k4_tree{i}")
        k4.append(importlib.import_module(f"_ab_k4_tree{i}.ops.depth_tail"))
    calls = inputs(device, shapes)
    timer = make_timer(device)
    ms = {label: [{"event": [], "device": [], "host": []} for _ in k4]
          for label in calls}
    kernels = [set() for _ in k4]
    errors = {label: [None] * len(k4) for label in calls}
    first, same = {}, {label: [True] * len(k4) for label in calls}
    with torch.no_grad():
        plain = {label: depth_tail_plain(*a) for label, a in calls.items()}
        for i in turns(len(k4), rounds):
            for label, args in calls.items():
                fn = lambda a=args, m=k4[i]: m.depth_tail(*a)
                got = fn()
                ref = first.setdefault(label, got)
                same[label][i] = same[label][i] and all(
                    torch.equal(a, b) for a, b in zip(got, ref))
                err = check(got, plain[label])
                if not (err["depth_max_rel"] <= DEPTH_REL
                        and err["conf_share_above_tol"] <= CONF_SHARE):
                    raise AssertionError(f"{roots[i]} {label}: {err}")
                errors[label][i] = err
                row = ms[label][i]
                row["event"].append(timer(fn))
                dev_ms, names = device_ms(fn, device)
                row["device"].append(dev_ms)
                kernels[i].update(names)
                row["host"].append(host_ms(fn, device))
    least = lambda t: None if None in t else min(t)
    per_map = []
    for i in range(len(k4)):
        tot = {k: [least(ms[label][i][k]) for label in calls]
               for k in ("event", "device", "host")}
        tot = {k: None if None in v else sum(v) for k, v in tot.items()}
        tot["device_plus_host"] = (None if tot["device"] is None
                                   else tot["device"] + tot["host"])
        per_map.append(tot)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    for label in calls:
        print(label)
        for i, root in enumerate(roots):
            r = ms[label][i]
            print(f"  {root:24s} event {min(r['event']):.4f}-"
                  f"{max(r['event']):.4f}  device "
                  f"{fmt(least(r['device']))}  host {least(r['host']):.4f}"
                  f"{'' if same[label][i] else '  (differs from the first)'}")
    for i, root in enumerate(roots):
        t = per_map[i]
        print(f"per map {root:20s} event {t['event']:.4f}  device "
              f"{fmt(t['device'])}  host {t['host']:.4f}  device+host "
              f"{fmt(t['device_plus_host'])}  kernels "
              f"{sorted(kernels[i])}")
    return {"ms": ms, "per_map": per_map, "errors": errors,
            "kernels": [sorted(k) for k in kernels], "equal_to_first": same}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="*", default=[str(ROOT)])
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    label = device_label(device)
    print(f"device: {label} | trees: {' '.join(args.roots)}")
    res = run(device, args.roots, args.rounds)
    print(json.dumps({"device": label, "trees": args.roots, **res}))
    if not all(all(v) for v in res["equal_to_first"].values()):
        raise SystemExit("ab_depth_tail: a tree's output differs from the "
                         "first tree's")
    return res


if __name__ == "__main__":
    main()
