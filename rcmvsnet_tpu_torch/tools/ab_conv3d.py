"""A/B timing of K2 (`ops/conv3d.conv3d`) and K8's weight gradient
(`ops/conv3d_train.conv3d_dw`), float32 and bf16, for builds of their CUDA
sources, in turns, on one card.

Each argument is a directory of CUDA sources with the package's C
interface (default: the package's own `ops/csrc/`): `conv3d.cu`,
`conv3d_dw.cu` and `tc_conv3d.cuh`, and, where the build has them, the
bf16 kernels' own sources (`conv3d_bf16.cu`, `conv3d_dw_bf16.cu`,
`tc_bf16.cuh`); a build without them runs the float32 cases only. Every
build runs the same inputs (CASES: the main paths' heaviest shapes, and every
bf16 mode at the train step's Co = 8 and Co = 64 shapes and the render
U-Net's Ci = 41); the builds take turns A, B, ..., B, A, each case's
time is the smaller of its build's two turns (each the median of 7
CUDA-event timings, `tools/timing`), and each result is held to its
plain version and to the first build's output in every bit
(`torch.equal`, reported per case and build) before it is timed; after
its report the tool exits non-zero if a float32 output differs from the
first build's (bf16 builds of other designs may sum in another order).
float32 cases ("k2", "dw") are held to 1e-4 of the largest value; bf16
ones ("k2_bf16", "dw_bf16") to one bf16 ulp of each element + 1e-4 of
the largest value (dw, float32 out, 1e-4 of the largest).
The wrappers stay the package's: a build that changes the C interface
cannot be compared.

`--sets` also times whole call sets per build, in the same turns: "map"
the 33 K2-bf16 calls of a DTU depth map (864x1152, the three eval
CostRegNets as `forward_folded` runs them: bias, ReLU, skip adds, the
float32 prob head) and "step" the bf16 train step's 86 K2-bf16 calls
(forward and adjoint of the 43 U-Net convs at 512x640 and the render
U-Net's) and 43 dw calls; each set's time is the sum of its calls'
times (for "step": K2 and dw apart).

Usage:
  python -m rcmvsnet_tpu_torch.tools.ab_conv3d [--sets map,step]
      [SRC_DIR ...]
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

LIBS = ("conv3d", "conv3d_dw", "conv3d_bf16", "conv3d_dw_bf16")
# (kernel, label, Ci, Co, input (D, H, W), mode): the DTU eval CostRegNets'
# largest convs (864x1152), the train step's (512x640) and the render
# U-Net's conv0 (128 planes at 128x160), forward, adjoint and dw; bf16:
# every mode at the step's Co = 8 and Co = 64 shapes, the render U-Net's
# Ci = 41, the eval modes (bias, ReLU, skip: "eval ..."; the prob head's
# float32 output: "prob ...")
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
    ("k2_bf16", "bf16 cr1 conv0 s1 16>8", 16, 8, (32, 256, 320), "s1"),
    ("k2_bf16", "bf16 cr2 conv0 s1 8>8", 8, 8, (8, 512, 640), "s1"),
    ("k2_bf16", "bf16 cr1 conv1 s2 8>16", 8, 16, (32, 256, 320), "s2"),
    ("k2_bf16", "bf16 cr1 conv1 dx t2 16>8", 16, 8, (16, 128, 160), "t2"),
    ("k2_bf16", "bf16 cr1 conv6 s1 64>64", 64, 64, (4, 32, 40), "s1"),
    ("k2_bf16", "bf16 cr1 conv5 s2 32>64", 32, 64, (8, 64, 80), "s2"),
    ("k2_bf16", "bf16 cr1 conv7 t2 64>32", 64, 32, (4, 32, 40), "t2"),
    ("k2_bf16", "bf16 render conv0 s1 41>8", 41, 8, (128, 128, 160), "s1"),
    ("k2_bf16", "bf16 render dx s1 8>41", 8, 41, (128, 128, 160), "s1"),
    ("k2_bf16", "eval S3 conv0 s1 8>8", 8, 8, (8, 864, 1152), "s1"),
    ("k2_bf16", "eval S3 conv11 t2 16>8", 16, 8, (4, 432, 576), "t2"),
    ("k2_bf16", "prob S3 s1 8>1", 8, 1, (8, 864, 1152), "s1"),
    ("dw_bf16", "bf16 render conv0 dw 41>8", 41, 8, (128, 128, 160), "s1"),
    ("dw_bf16", "bf16 cr1 conv0 dw 16>8", 16, 8, (32, 256, 320), "s1"),
    ("dw_bf16", "bf16 cr2 conv0 dw 8>8", 8, 8, (8, 512, 640), "s1"),
    ("dw_bf16", "bf16 cr1 conv11 dw t2 16>8", 16, 8, (16, 128, 160), "t2"),
    ("dw_bf16", "bf16 cr1 conv1 dw s2 8>16", 8, 16, (32, 256, 320), "s2"),
    ("dw_bf16", "bf16 cr1 prob dw 8>1", 8, 1, (32, 256, 320), "s1"),
    ("dw_bf16", "bf16 cr1 conv6 dw 64>64", 64, 64, (4, 32, 40), "s1"),
    ("dw_bf16", "bf16 cr1 conv5 dw s2 32>64", 32, 64, (8, 64, 80), "s2"),
    ("dw_bf16", "bf16 cr1 conv7 dw t2 64>32", 64, 32, (4, 32, 40), "t2"),
)
# the library the package's wrapper loads for a kind and for a set part
LIB = {"k2": "conv3d", "dw": "conv3d_dw", "k2_bf16": "conv3d_bf16",
       "dw_bf16": "conv3d_dw_bf16"}
SET_LIB = {"k2": "conv3d_bf16", "dw": "conv3d_dw_bf16"}
# (Ci, planes, H, W, prob head) of the U-Nets: a DTU depth map's three
# eval CostRegNets, the train step's three and its render U-Net
MAP_UNETS = ((32, 48, 216, 288, True), (16, 32, 432, 576, True),
             (8, 8, 864, 1152, True))
STEP_UNETS = ((32, 48, 128, 160, True), (16, 32, 256, 320, True),
              (8, 8, 512, 640, True), (41, 128, 128, 160, False))
# output channels of the trunk's convs (nn/costreg.TRUNK) at base width 8
WIDTHS = {"conv0": 8, "conv1": 16, "conv2": 16, "conv3": 32, "conv4": 32,
          "conv5": 64, "conv6": 64, "conv7": 32, "conv9": 16, "conv11": 8}
SKIPS = {"conv7": "conv4", "conv9": "conv2", "conv11": "conv0"}
TRUNK = (("conv0", "s1"), ("conv1", "s2"), ("conv2", "s1"), ("conv3", "s2"),
         ("conv4", "s1"), ("conv5", "s2"), ("conv6", "s1"), ("conv7", "t2"),
         ("conv9", "t2"), ("conv11", "t2"))


def unet_layers(ci: int, dhw, prob: bool):
    """[(name, mode, Ci, Co, input (D, H, W), skip source)] of one U-Net."""
    out, cur = [], (ci, *dhw)
    for name, mode in TRUNK + ((("prob", "s1"),) if prob else ()):
        cin, d, h, w = cur
        co = 1 if name == "prob" else WIDTHS[name]
        out.append((name, mode, cin, co, (d, h, w), SKIPS.get(name)))
        cur = (co, *K2.out_shape(mode, d, h, w))
    return out


def set_calls(kind: str, device, gen):
    """[(label, "k2" or "dw", kernel call)] of call set `kind` ("map" or
    "step"), bf16 inputs ~ N(0, 1), weights 0.1·N(0, 1)."""
    bf = torch.bfloat16
    rand = lambda *s: torch.randn(*s, device=device, generator=gen).to(bf)
    calls = []
    for u, (ci, d, h, w, prob) in enumerate(
            MAP_UNETS if kind == "map" else STEP_UNETS):
        for name, mode, cin, co, dhw, skip_of in unet_layers(ci, (d, h, w),
                                                             prob):
            x = rand(1, cin, *dhw)
            wshape = (cin, co, 3, 3, 3) if mode == "t2" else (co, cin, 3, 3,
                                                              3)
            wgt = 0.1 * rand(*wshape)
            odhw = K2.out_shape(mode, *dhw)
            out = torch.float32 if name == "prob" else None
            tag = f"{kind} u{u} {name} {mode} {cin}>{co} {dhw}"
            if kind == "map":
                b = torch.randn(co, device=device, generator=gen)
                sk = rand(1, co, *odhw) if skip_of else None
                calls.append((tag, "k2", lambda x=x, wgt=wgt, b=b, mode=mode,
                              sk=sk, out=out: K2.conv3d(
                                  x, wgt, b, mode, relu=out is None,
                                  skip=sk, out_dtype=out)))
                continue
            g = rand(1, co, *odhw)
            zo = torch.zeros(co, device=device)
            zi = torch.zeros(cin, device=device)
            adj = K8.ADJOINT[mode]
            adj_w = K8._adjoint_weight(wgt, mode)
            calls.append((tag + " fwd", "k2", lambda x=x, wgt=wgt, zo=zo,
                          mode=mode, out=out: K2.conv3d(
                              x, wgt, zo, mode, relu=False, out_dtype=out)))
            calls.append((tag + " dx", "k2", lambda g=g, adj_w=adj_w, zi=zi,
                          adj=adj, dhw=dhw: K2.conv3d(
                              g, adj_w, zi, adj, relu=False,
                              out_dhw=dhw if adj == "t2" else None)))
            calls.append((tag + " dw", "dw", lambda x=x, g=g, mode=mode:
                          K8.conv3d_dw(x, g, mode)))
    return calls


def case_calls(case, device, gen):
    """(kernel call, plain call) on inputs ~ N(0, 1), weights 0.1·N(0, 1)
    (bf16 kinds: both rounded to bf16; "eval" cases a bias ~ N(0, 1),
    ReLU and, in mode t2, a skip; "prob" cases the float32 output)."""
    kind, label, ci, co, dhw, mode = case
    dt = torch.bfloat16 if kind.endswith("bf16") else torch.float32
    x = torch.randn(1, ci, *dhw, device=device, generator=gen).to(dt)
    if kind.startswith("dw"):
        g = torch.randn(1, co, *K2.out_shape(mode, *dhw), device=device,
                        generator=gen).to(dt)
        return (lambda: K8.conv3d_dw(x, g, mode),
                lambda: K8.conv3d_dw_plain(x, g, mode))
    wshape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    w = (0.1 * torch.randn(*wshape, device=device, generator=gen)).to(dt)
    kw = dict(relu=False)
    b = torch.zeros(co, device=device)
    if label.startswith("eval"):
        b = torch.randn(co, device=device, generator=gen)
        kw["relu"] = True
        if mode == "t2":
            kw["skip"] = torch.randn(1, co, *K2.out_shape(mode, *dhw),
                                     device=device, generator=gen).to(dt)
    elif label.startswith("prob"):
        kw["out_dtype"] = torch.float32
    return (lambda: K2.conv3d(x, w, b, mode, **kw),
            lambda: K2.conv3d_plain(x, w, b, mode, **kw))


def _error(got, want) -> bool:
    """Whether got is within its plain version's tolerance: bf16 outputs
    one bf16 ulp of each element + 1e-4 of the largest value, float32
    ones 1e-4 of the largest."""
    g, w = got.float(), want.float()
    m = float(w.abs().max())
    if got.dtype == torch.bfloat16:
        return bool(((g - w).abs() <= w.abs() * 2.0 ** -7 + 1e-4 * m).all())
    return float((g - w).abs().max()) <= 1e-4 * m


def load_build(src: str) -> dict:
    """{library name the wrappers load: library} of one build."""
    d = Path(src)
    return _build.load_from(d, [n for n in LIBS if (d / f"{n}.cu").exists()])


def run(device, srcs, sets=()) -> dict:
    """{label: [ms of each build]} and the totals, printed per case."""
    builds = [load_build(s) for s in srcs]
    gen = torch.Generator(device=device).manual_seed(0)
    calls = [(c[1], LIB[c[0]], *case_calls(c, device, gen)) for c in CASES]
    set_lists = {k: set_calls(k, device, gen) for k in sets}
    timer = make_timer(device)
    order = list(range(len(builds))) + list(reversed(range(len(builds))))
    ms = {c[0]: [None] * len(builds) for c in calls}
    set_ms = {f"{k} {part}": [None] * len(builds) for k in sets
              for part in ("k2", "dw") if any(c[1] == part
                                              for c in set_lists[k])}
    first, same = {}, {c[0]: [True] * len(builds) for c in calls}
    for i in order:
        _build._libs.update(builds[i])      # the wrappers launch build i
        for label, lib, fk, fp in calls:
            if lib not in builds[i]:
                continue                  # this build has no such instance
            got, want = fk(), fp()
            if not _error(got, want):
                raise AssertionError(f"{srcs[i]} {label}: beyond the "
                                     f"plain version's tolerance")
            ref = first.setdefault(label, got)
            same[label][i] = same[label][i] and torch.equal(got, ref)
            t = timer(fk)
            ms[label][i] = t if ms[label][i] is None else min(ms[label][i],
                                                              t)
        for k, lst in set_lists.items():
            for part in ("k2", "dw"):
                key = f"{k} {part}"
                if key not in set_ms or SET_LIB[part] not in builds[i]:
                    continue
                t = sum(timer(fn) for _, p, fn in lst if p == part)
                prev = set_ms[key][i]
                set_ms[key][i] = t if prev is None else min(prev, t)
    fmt = lambda t: "     n/a" if t is None else f"{t:8.3f}"
    for label, row in ms.items():
        print(f"{label:32s} " + "  ".join(
            f"{fmt(t)}{'' if ok else ' (differs)'}"
            for t, ok in zip(row, same[label])))
    f32 = [label for c, label in zip(CASES, ms) if c[0] in ("k2", "dw")]
    totals = [sum(ms[label][i] for label in f32) for i in range(len(srcs))]
    print(f"{'total ms (float32)':32s} " + "  ".join(f"{t:8.3f}"
                                                     for t in totals))
    for key, row in set_ms.items():
        print(f"{'set ' + key:32s} " + "  ".join(fmt(t) for t in row))
    return {"ms": ms, "total_ms": totals, "sets_ms": set_ms,
            "equal_to_first": same}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("srcs", nargs="*", default=[str(_build.CSRC)])
    p.add_argument("--sets", default="",
                   help="comma-separated call sets to time: map, step")
    args = p.parse_args(argv)
    sets = tuple(s for s in args.sets.split(",") if s)
    device = resolve_device("cuda")
    label = device_label(device)
    print(f"device: {label} | builds: {' '.join(args.srcs)}")
    res = run(device, args.srcs, sets)
    print(json.dumps({"device": label, "builds": args.srcs, **res}))
    f32 = [c[1] for c in CASES if c[0] in ("k2", "dw")]
    if not all(all(res["equal_to_first"][label]) for label in f32):
        raise SystemExit("ab_conv3d: a build's float32 output differs from "
                         "the first build's")
    return res


if __name__ == "__main__":
    main()
