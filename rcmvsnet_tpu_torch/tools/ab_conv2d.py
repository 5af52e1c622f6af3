"""A/B timing of K5 (`ops/conv2d`, the FeatureNet FPN's 2D conv) for two
or more trees of the port, in turns, on one card, with cuDNN beside them.

Each argument is the root of a checkout of this repository (default: this
one). Unlike `ab_conv3d`, whose builds share one C interface, a tree here
brings its own wrappers: its package `rcmvsnet_tpu_torch` is imported
under an alias, and its kernels build into that tree's own build
directory. Every tree runs the same inputs, FeatureNet's 13 calls of one
DTU depth map (5 views at 864×1152, the golden backbone on the plane
scene; inputs from the plain path), each in NCHW as every tree takes it;
then, where a tree has them, the eval path's own forms: the heads writing
[N, h, w, C] ("warp"), stage 3's lateral head (inner2+up and out3 in one
call, `lateral_conv2d`), and the whole `FeatureNet.forward_folded` as the
eval cascade calls it. Then the bf16 eval path's 12 calls ("bf16 ..."
rows: `forward_folded(dtype=bfloat16, out_layout="warp")` call by call,
the trunk's weights bf16(bf16(w)·scale), the heads in the warp layout and
stage 3's lateral head; inputs from the bf16 plain path). Each call runs
as the tree's wrapper runs it. The trees take turns A, B, ..., B, A, A,
B, ... for `--rounds` rounds (default 2); each time is the smallest of its
tree's turns (each the median of 7 CUDA-event timings, `tools/timing`),
printed with the largest. Before it is timed each result is held to its
plain version (float32: 1e-4 of the largest value; bf16: one bf16 ulp of
each element + 1e-4 of the largest value) and compared with the first
tree's result (`torch.equal`): a float32 result must equal it in every
bit (the tool exits non-zero after its report where one differs); a bf16
one is reported ("equal: yes/no") and held to the bf16 gate only, since a
redesign may sum a chunk's products in another order. One cuDNN call per
conv (TF32 off; bf16 for the bf16 rows) is timed once. The report ends
with the totals of the 13 float32 NCHW calls and of the 12 bf16 calls.
Each tree's build prints the registers ptxas gave each of its direct
kernels (`-Xptxas -v`).

Usage:
  python -m rcmvsnet_tpu_torch.tools.ab_conv2d [--rounds N] [TREE_ROOT ...]
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from ..cli.eval_dtu import resolve_device
from ..ops.conv2d import conv2d_plain, lateral_conv2d_plain
from .ab_warp_fwd import turns
from .repeat_warp_bwd import within_plain
from .timing import device_label, make_timer

ROOT = Path(__file__).resolve().parents[2]
SEED = 5


def load_tree(root: Path, alias: str) -> SimpleNamespace:
    """The port package of the checkout at `root`, imported as `alias`:
    its conv2d module, FeatureNet class and kernel builder."""
    pkg = Path(root).resolve() / "rcmvsnet_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    get = lambda name: importlib.import_module(f"{alias}.{name}")
    return SimpleNamespace(root=str(root), conv2d=get("ops.conv2d"),
                           featurenet=get("nn.featurenet"),
                           build=get("ops._build"))


def direct_registers(log: str) -> dict:
    """{"K<k> CO_T<c> <layout>": registers} of the float32 direct kernels
    in one build's ptxas report (a first-port instance, with no layout
    parameter, writes NCHW)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        k = (name and "bfloat16" not in name and re.search(
            r"conv2d_kernelILi(\d+)ELi(\d+)E(?:Lb(\d)E)?", name))
        if m and k:
            layout = "nhwc" if k.group(3) == "1" else "nchw"
            out[f"K{k.group(1)} CO_T{k.group(2)} {layout}"] = int(m.group(1))
    return dict(sorted(out.items()))


def featurenet_calls(net, x):
    """FeatureNet's 13 K5 calls on input x [N, 3, H, W], in order:
    [(label, args, kwargs)] of `conv2d` (NCHW), each input from the plain
    path; and the lateral head's arguments."""
    from ..nn.layers import bn_scale_shift
    calls, acts = [], []
    for si, seq in enumerate((net.conv0, net.conv1, net.conv2)):
        for li, blk in enumerate(seq):
            sc, sh = bn_scale_shift(blk.bn)
            kw = dict(stride=blk.conv.stride[0], padding=blk.conv.padding[0],
                      relu=True)
            calls.append((f"conv{si}.{li}", (x, blk.conv.weight, sc, sh),
                          kw))
            x = conv2d_plain(x, blk.conv.weight, sc, sh, **kw)
        acts.append(x)
    conv0, conv1, intra = acts
    calls.append(("out1", (intra, net.out1.weight), {}))
    kw = dict(shift=net.inner1.bias, up=intra)
    calls.append(("inner1+up", (conv1, net.inner1.weight), kw))
    intra = conv2d_plain(conv1, net.inner1.weight, **kw)
    calls.append(("out2", (intra, net.out2.weight), dict(padding=1)))
    kw = dict(shift=net.inner2.bias, up=intra)
    calls.append(("inner2+up", (conv0, net.inner2.weight), kw))
    calls.append(("out3", (conv2d_plain(conv0, net.inner2.weight, **kw),
                           net.out3.weight), dict(padding=1)))
    lateral = (intra, conv0, net.inner2.weight, net.inner2.bias,
               net.out3.weight)
    return calls, lateral


def featurenet_calls_bf16(net, x):
    """The bf16 eval path's 12 K5 calls on input x [N, 3, H, W] (rounded
    to bf16), as `FeatureNet.forward_folded(dtype=bfloat16,
    out_layout="warp")` makes them: [(label, args, kwargs)] of `conv2d`,
    each input from the bf16 plain path, and the lateral head's arguments
    (label "bf16 out3 lateral warp")."""
    from ..nn.layers import bn_scale_shift
    bf = lambda w: w.to(torch.bfloat16)
    x = x.to(torch.bfloat16)
    calls, acts = [], []
    for si, seq in enumerate((net.conv0, net.conv1, net.conv2)):
        for li, blk in enumerate(seq):
            sc, sh = bn_scale_shift(blk.bn)
            wgt = bf(bf(blk.conv.weight) * sc[:, None, None, None])
            kw = dict(shift=sh, stride=blk.conv.stride[0],
                      padding=blk.conv.padding[0], relu=True)
            calls.append((f"bf16 conv{si}.{li}", (x, wgt), kw))
            x = conv2d_plain(x, wgt, **kw)
        acts.append(x)
    conv0, conv1, intra = acts
    calls.append(("bf16 out1 warp", (intra, bf(net.out1.weight)),
                  dict(out_layout="warp")))
    kw = dict(shift=net.inner1.bias, up=intra)
    calls.append(("bf16 inner1+up", (conv1, bf(net.inner1.weight)), kw))
    intra = conv2d_plain(conv1, bf(net.inner1.weight), **kw)
    calls.append(("bf16 out2 warp", (intra, bf(net.out2.weight)),
                  dict(padding=1, out_layout="warp")))
    lateral = (intra, conv0, bf(net.inner2.weight), net.inner2.bias,
               bf(net.out3.weight))
    return calls, lateral


def tree_calls_bf16(tree, calls, lateral):
    """{label: (kernel call, plain call)} of one tree's bf16 instance: the
    12 calls of `featurenet_calls_bf16`."""
    K5 = tree.conv2d
    out = {label: (lambda a=args, k=kw: K5.conv2d(*a, **k),
                   lambda a=args, k=kw: conv2d_plain(*a, **k))
           for label, args, kw in calls}
    out["bf16 out3 lateral warp"] = (
        lambda: K5.lateral_conv2d(*lateral, out_layout="warp"),
        lambda: lateral_conv2d_plain(*lateral, out_layout="warp"))
    return out


def tree_calls(tree, calls, lateral, net):
    """{label: (kernel call, plain call)} of one tree: the 13 calls in
    NCHW, then the forms only some trees have."""
    K5 = tree.conv2d
    params = inspect.signature(K5.conv2d).parameters
    out = {}
    for label, args, kw in calls:
        out[label] = (lambda a=args, k=kw: K5.conv2d(*a, **k),
                      lambda a=args, k=kw: conv2d_plain(*a, **k))
        if "out_layout" in params and label in ("out1", "out2", "out3"):
            out[f"{label} warp"] = (
                lambda a=args, k=kw: K5.conv2d(*a, out_layout="warp", **k),
                lambda a=args, k=kw: conv2d_plain(*a, out_layout="warp",
                                                  **k))
    if hasattr(K5, "lateral_conv2d"):
        out["out3 lateral warp"] = (
            lambda: K5.lateral_conv2d(*lateral, out_layout="warp"),
            lambda: lateral_conv2d_plain(*lateral, out_layout="warp"))
    fnet = tree.featurenet.FeatureNet(8)
    fnet.load_state_dict(net.state_dict())
    fnet = fnet.to(calls[0][1][0].device).eval()
    x = calls[0][1][0]
    fwd = (dict(out_layout="warp") if "out_layout" in inspect.signature(
        fnet.forward_folded).parameters else {})
    out["forward_folded"] = (lambda: fnet.forward_folded(x, **fwd),
                             lambda: fnet.forward_folded(x, plain=True,
                                                         **fwd))
    return out


def _err(got, want) -> float:
    if isinstance(got, dict):
        return max(_err(got[k], want[k]) for k in want)
    return float((got - want).abs().max() / want.abs().max())


def _equal(got, ref) -> bool:
    if isinstance(got, dict):
        return all(_equal(got[k], ref[k]) for k in ref)
    return torch.equal(got, ref)


def _within(got, want) -> bool:
    """A result against its plain version: bf16 the per-element bf16 gate
    (`repeat_warp_bwd.within_plain`), float32 1e-4 of the largest value."""
    if isinstance(got, dict):
        return all(_within(got[k], want[k]) for k in want)
    if got.dtype == torch.bfloat16:
        return within_plain(got, want)
    return _err(got, want) <= 1e-4


def run(device, roots, rounds=2) -> dict:
    """{label: [least ms of each tree (None where a tree lacks the
    form)]}, every turn's ms, cuDNN's ms per conv and the totals of the 13
    float32 NCHW calls and of the 12 bf16 calls."""
    from ..core.geometry import set_full_precision
    from ..data.plane_scene import dtu_samples, plane_scene
    from ..models.cascade import CascadeMVSNet
    from ..weights import ASSET, load_state_dict
    from .repeat_warp_bwd import NDEPTH

    set_full_precision()
    trees = [load_tree(Path(r), f"_ab_tree{i}") for i, r in enumerate(roots)]
    registers = []
    for t in trees:
        registers.append(direct_registers(t.build.build_all(("conv2d",))[
            "conv2d"]))
        print(f"{t.root} direct kernels' registers: {registers[-1]}")
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    net = model.feature.to(device).eval()
    sample = dtu_samples(plane_scene(864, 1152, 5, SEED), NDEPTH)[0]
    x = torch.from_numpy(sample["imgs"]).to(device).permute(
        0, 3, 1, 2).contiguous()
    timer = make_timer(device)
    turn_ms, library = {}, {}
    with torch.no_grad():
        calls, lateral = featurenet_calls(net, x)
        calls16, lateral16 = featurenet_calls_bf16(net, x)
        for label, args, kw in calls + calls16:
            library[label] = timer(lambda a=args, k=kw: F.conv2d(
                a[0], a[1], stride=k.get("stride", 1),
                padding=k.get("padding", 0)))
        per_tree = [{**tree_calls(t, calls, lateral, net),
                     **tree_calls_bf16(t, calls16, lateral16)}
                    for t in trees]
        checked, first = set(), {}
        same = {}
        for i in turns(len(trees), rounds):
            for label, (fk, fp) in per_tree[i].items():
                if (i, label) not in checked:
                    got, want = fk(), fp()
                    if not _within(got, want):
                        raise AssertionError(
                            f"{roots[i]} {label}: beyond its plain "
                            f"version's gate (error {_err(got, want):.2e})")
                    ref = first.setdefault(label, got)
                    same.setdefault(label, [None] * len(trees))[i] = _equal(
                        got, ref)
                    checked.add((i, label))
                row = turn_ms.setdefault(label, [[] for _ in trees])
                row[i].append(timer(fk))
    ms = {label: [min(t) if t else None for t in row]
          for label, row in turn_ms.items()}
    fmt = lambda t: f"{min(t):7.3f}-{max(t):<7.3f}" if t else " " * 15
    lib = lambda v: f"{v:8.3f}" if v is not None else "       -"
    for label, row in turn_ms.items():
        print(f"{label:28s} " + "  ".join(fmt(t) for t in row)
              + f"  cudnn {lib(library.get(label))}  equal: "
              + " ".join({True: "yes", False: "NO", None: "-"}[v]
                         for v in same[label]))
    base = [lab for lab, _, _ in calls]
    base16 = [lab for lab, _, _ in calls16] + ["bf16 out3 lateral warp"]
    totals = [sum(ms[lab][i] for lab in base) for i in range(len(trees))]
    totals16 = [sum(ms[lab][i] for lab in base16)
                for i in range(len(trees))]
    print(f"{'total ms (13 NCHW, least)':28s} "
          + "  ".join(f"{t:15.3f}" for t in totals)
          + f"  cudnn {sum(library[lab] for lab in base):8.3f}")
    print(f"{'total ms (12 bf16, least)':28s} "
          + "  ".join(f"{t:15.3f}" for t in totals16)
          + f"  cudnn {sum(library[lab] for lab, _, _ in calls16):8.3f}")
    return {"ms": ms, "turns_ms": turn_ms, "library_ms": library,
            "registers": registers, "equal_to_first": same,
            "total_ms": totals, "total_bf16_ms": totals16}


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
    if any(v is False for label, row in res["equal_to_first"].items()
           if not label.startswith("bf16 ") for v in row):
        raise SystemExit("ab_conv2d: a tree's output differs from the first "
                         "tree's")
    return res


if __name__ == "__main__":
    main()
