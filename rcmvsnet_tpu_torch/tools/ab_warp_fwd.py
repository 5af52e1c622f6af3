"""A/B timing of the forward plane sweeps K1 (`ops/warp_variance`, the
fused warp + variance) and K7 (`ops/warp_volume`, the stage-1 train
volume) for builds of their CUDA sources, in turns, on one card, with the
builds' outputs held equal bit for bit.

Each argument is a directory holding `warp_variance.cu`,
`warp_volume.cu`, the shared headers (`warp_common.cuh`, `warp_bwd.cuh`
and, where the build has them, `warp_fwd.cuh` and `warp_bf16.cuh`) and,
where the build has them, `warp_variance_bf16.cu` (K1-bf16 and K6-bf16)
and `warp_volume_bf16.cu` (K7bwd-bf16 and, from its own design on,
K7-bf16); older builds export those from `warp_variance.cu` and
`warp_volume.cu` (`load_builds`); default: the package's own
`ops/csrc/`. Every build runs the same inputs: K1 at the
DTU eval shapes (864×1152, V=5, stages 48/32/8 planes;
`tools/profile_breakdown.stage_inputs`) and at the train shapes
(512×640, V=4; `tools/repeat_warp_bwd.train_stages`), and K7's forward
at the train stage-1 shape (the same features, the images resized to
it). K1 runs through the package's wrapper; K7 and K7-bf16 through
their C entries, called as the build's source declares them
(`entry_params`): (var, vol) in the render volume's layout, or, for a
build from before that layout, (var, var_nr, wimg) with var_nr and wimg
pointed at vol's two row slices, so both write the same tensor; K7-bf16's
images as they are, or, where the declaration takes `imgs4`, as the
[V, h, w, 4] copy the wrapper makes (`warp_volume.images4`, made once,
outside the timing). A call through a C entry also computes the relative
projections, so its event time holds their kernels and host work; the K7
rows add each turn's device ms of the K7 kernel alone (`torch.profiler`,
"dev" columns), which resolves what the event times cannot. The builds take turns A, B, ..., B, A, A, B, ...
for `--rounds` rounds (default 2); each call's time is the smallest of
its build's turns (each the median of 7 CUDA-event timings,
`tools/timing`), printed with the largest. Before it is timed, each
result is held to its plain version (1e-4 of the largest value) and to
the first build's result with `torch.equal` (every bit); the tool fails
after its report if any build's output differs. The bf16 instances run
too ("bf16 ..." rows: K1-bf16 at the DTU and the train stages through the
wrapper, K7-bf16 at stage 1 through its C entry, on the inputs rounded to
bf16; held to their bf16 plain versions to one bf16 ulp of each element +
1e-4 of the largest value, and to the first build's output in every bit),
on the builds whose libraries export them ("n/a" elsewhere). The report
ends with K1's float32 and bf16 totals over the DTU stages (a map) and
over the train stages, and, for the last build whose K7-bf16 takes
`imgs4`, one wrapper call of K7-bf16 split into its event ms, its
kernels' device ms (`torch.profiler`: the image copy and the kernel) and
the host ms of the call (`tools/timing`).

Usage:
  python -m rcmvsnet_tpu_torch.tools.ab_warp_fwd [--rounds N] [SRC_DIR ...]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
from pathlib import Path
from types import SimpleNamespace

import torch

from ..cli.eval_dtu import resolve_device
from ..ops import _build
from ..ops import warp_variance as K1
from ..ops import warp_volume as K7
from .repeat_warp_bwd import within_plain
from .timing import device_label, device_ms, host_ms, make_timer

LIBS = ("warp_variance", "warp_volume", "warp_variance_bf16",
        "warp_volume_bf16")
SEED = 5
# the bf16 warp entries a build from before `warp_variance_bf16.cu`
# exports from `warp_variance.cu`, by the names the wrappers ask the new
# library for
OLD_BF16 = {"warp_variance_bf16": "warp_variance_bf16",
            "warp_variance_bwd_bf16": "warp_variance_bwd_bf16",
            "warp_variance_bf16_bwd_scratch_bytes":
                "warp_variance_bwd_scratch_bytes"}
# likewise K7-bf16 and K7bwd-bf16, which a build from before
# `warp_volume_bf16.cu` (K7-bf16: before its own design) exports from
# `warp_volume.cu`
OLD_VOLUME_BF16 = {"warp_volume_bf16": "warp_volume_bf16",
                   "warp_volume_bwd_bf16": "warp_volume_bwd_bf16",
                   "warp_volume_bf16_bwd_scratch_bytes":
                       "warp_volume_bwd_scratch_bytes"}


def load_builds(srcs) -> list[dict]:
    """Each build's libraries by name (`_build.load_from` of the sources
    of LIBS its directory holds). The bf16 entries a build's
    `warp_variance_bf16.cu` (`warp_volume_bf16.cu`) lacks, or all of them
    where it has no such source, are served from its `warp_variance.cu`
    (`warp_volume.cu`) under the new library's name, so K1-bf16, K6-bf16,
    K7-bf16 and K7bwd-bf16 are found whichever source holds them."""
    builds = []
    for s in srcs:
        names = [n for n in LIBS if (Path(s) / f"{n}.cu").exists()]
        libs = _build.load_from(Path(s), names)
        for new_lib, old_lib, entries in (
                ("warp_variance_bf16", "warp_variance", OLD_BF16),
                ("warp_volume_bf16", "warp_volume", OLD_VOLUME_BF16)):
            old = libs[old_lib]
            lib = libs.setdefault(new_lib, SimpleNamespace())
            for new, name in entries.items():
                if not hasattr(lib, new) and hasattr(old, name):
                    setattr(lib, new, getattr(old, name))
        builds.append(libs)
    return builds


def k1_inputs(device, gen, dtu=(864, 1152, 5), train=(512, 640, 4)):
    """[(label, (feats, projs, lo, step, ndepth))] of K1 at the DTU eval
    stages and the train stages, from the golden backbone's FeatureNet on
    the plane scene, and K7's (label, (feats, imgs, projs, lo, step,
    ndepth)) at the train stage 1."""
    from ..data.plane_scene import dtu_samples, plane_scene
    from ..data.synthetic import batch_from_views
    from ..models.cascade import CascadeMVSNet
    from ..ops.sampling import resize_bilinear
    from ..train.step import batch_to
    from ..weights import ASSET, load_state_dict
    from .profile_breakdown import stage_inputs
    from .repeat_warp_bwd import NDEPTH, train_stages

    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model = model.to(device).eval()
    calls = []
    with torch.no_grad():
        sample = dtu_samples(plane_scene(*dtu, SEED), NDEPTH)[0]
        for st in stage_inputs(model, sample, device):
            V, h, w, C = st["feats"].shape
            calls.append((f"eval {st['key']} V{V} {h}x{w} C{C} D{st['nd']}",
                          (st["feats"], st["projs"], st["lo"], st["step"],
                           st["nd"])))
        scene = plane_scene(*train, SEED)
        batch = batch_to(batch_from_views([scene], NDEPTH, SEED), device)
        rand = lambda *s: torch.randn(*s, generator=gen, device=device)
        for key, f, projs, lo, step, nd in train_stages(model, batch, scene,
                                                        rand):
            V, h, w, C = f.shape
            calls.append((f"train {key} V{V} {h}x{w} C{C} D{nd}",
                          (f, projs, lo, step, nd)))
            if key == "stage1":
                im = resize_bilinear(batch["imgs"][0], h, w).contiguous()
                k7 = (f"K7 train {key} V{V} {h}x{w} C{C} D{nd}",
                      (f, im, projs, lo, step, nd))
    return calls, k7


def entry_params(src_dir: Path, entry: str) -> list[str]:
    """The parameters of `entry`'s extern "C" declaration (the build's C
    interface) in src_dir/warp_volume_bf16.cu or, failing that,
    src_dir/warp_volume.cu."""
    for name in ("warp_volume_bf16.cu", "warp_volume.cu"):
        path = Path(src_dir) / name
        m = path.exists() and re.search(
            r'extern "C" int ' + entry + r"\(([^)]*)\)", path.read_text())
        if m:
            return [" ".join(a.split()) for a in m.group(1).split(",")]
    raise ValueError(f"{src_dir}: no warp_volume source declares {entry}")


def entry_pointers(src_dir: Path, entry: str) -> int:
    """The data pointers among `entry`'s parameters (the stream
    aside)."""
    return sum("*" in a and not a.startswith("void*")
               for a in entry_params(src_dir, entry))


def k7_call(lib, n_ptr: int, feats, imgs, projs, lo, step, nd):
    """K7's forward through one build's C entry (K7-bf16's for bf16
    feats; imgs as that entry takes them): (var, vol), vol in the render
    volume's layout whichever interface the build has (7 pointers: var,
    vol; 8: var, var_nr, wimg)."""
    V, h, w, C = feats.shape
    rel = K1.relative_projections(projs)
    new = lambda c: torch.empty((c, nd, h, w), dtype=feats.dtype,
                                device=feats.device)
    var, vol = new(C), new(3 * (V - 1) + C)
    outs = [var.data_ptr(), vol.data_ptr()]
    if n_ptr == 8:
        outs = [var.data_ptr(), vol[3 * (V - 1):].data_ptr(),
                vol.data_ptr()]
    bf16 = feats.dtype == torch.bfloat16
    fn = lib.warp_volume_bf16 if bf16 else lib.warp_volume_f32
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(feats.data_ptr(), imgs.data_ptr(), rel.data_ptr(),
             lo.data_ptr(), step.data_ptr(), *outs, V, h, w, C, nd,
             _build.stream_ptr(feats.device))
    _build.check(err, "warp_volume (ab_warp_fwd)")
    return var, vol


def takes_imgs4(src_dir: Path) -> bool:
    """Whether the build's K7-bf16 entry takes the [V, h, w, 4] image
    copy (its own design) rather than the images as they are."""
    return "imgs4" in " ".join(entry_params(src_dir, "warp_volume_bf16"))


def turns(n: int, rounds: int) -> list[int]:
    """The order of n builds' turns: 0..n-1, n-1..0, 0..n-1, ..."""
    fwd = list(range(n))
    return [i for r in range(rounds) for i in (fwd if r % 2 == 0
                                               else fwd[::-1])]


def spread_line(label, row) -> str:
    """label, then each build's least and largest ms over its turns."""
    return f"{label:41s} " + "  ".join(
        f"{min(t):7.3f}-{max(t):<7.3f}" if t else f"{'n/a':15s}"
        for t in row)


def run(device, srcs, rounds=2) -> dict:
    """{label: [least ms of each build]}, every turn's ms, the totals and,
    per label, whether each build's output equals the first build's in
    every bit."""
    builds = load_builds(srcs)
    k7_ptrs = [entry_pointers(Path(s), "warp_volume_f32") for s in srcs]
    gen = torch.Generator(device=device).manual_seed(SEED)
    k1_calls, (k7_label, k7_args) = k1_inputs(device, gen)
    calls = [(label, None, lambda i, a=args: (K1.warp_variance(*a),),
              lambda a=args: (K1.warp_variance_plain(*a),))
             for label, args in k1_calls]
    calls.append((k7_label, None,
                  lambda i: k7_call(builds[i]["warp_volume"], k7_ptrs[i],
                                    *k7_args),
                  lambda: K7.warp_volume_plain(*k7_args)))
    has_bf16 = [hasattr(b["warp_volume_bf16"], "warp_volume_bf16")
                for b in builds]
    k7b_ptrs = [entry_pointers(Path(s), "warp_volume_bf16") if ok else 0
                for s, ok in zip(srcs, has_bf16)]
    imgs4 = [ok and takes_imgs4(Path(s)) for s, ok in zip(srcs, has_bf16)]
    # the bf16 instances, through the wrappers
    for label, args in k1_calls:
        a = (args[0].bfloat16(), *args[1:])
        calls.append((f"bf16 K1 {label}", ("warp_variance_bf16",
                                           "warp_variance_bf16"),
                      lambda i, a=a: (K1.warp_variance(*a),),
                      lambda a=a: (K1.warp_variance_plain(*a),)))
    a7 = (k7_args[0].bfloat16(), k7_args[1].bfloat16(), *k7_args[2:])
    a7_4 = (a7[0], K7.images4(a7[1]), *a7[2:])
    calls.append((f"bf16 {k7_label}", ("warp_volume_bf16",
                                       "warp_volume_bf16"),
                  lambda i: k7_call(builds[i]["warp_volume_bf16"],
                                    k7b_ptrs[i], *(a7_4 if imgs4[i] else a7)),
                  lambda: K7.warp_volume_plain(*a7)))
    timer = make_timer(device)
    turn_ms = {c[0]: [[] for _ in builds] for c in calls}
    k7_dev = {c[0]: [[] for _ in builds] for c in calls if "K7" in c[0]}
    equal = {c[0]: [True] * len(builds) for c in calls}
    plain, first = {}, {}
    with torch.no_grad():
        for i in turns(len(builds), rounds):
            _build._libs.update(builds[i])   # the wrapper now launches build i
            for label, entry, fk, fp in calls:
                if entry and not hasattr(builds[i][entry[0]], entry[1]):
                    continue                 # this build has no such instance
                got = fk(i)
                if label not in plain:
                    plain[label] = fp()
                if not all(within_plain(a, p)
                           for a, p in zip(got, plain[label])):
                    raise AssertionError(f"{srcs[i]} {label}: beyond the "
                                         f"plain version's tolerance")
                ref = first.setdefault(label, got)
                equal[label][i] &= all(bool(torch.equal(a, b))
                                       for a, b in zip(got, ref))
                del got
                turn_ms[label][i].append(timer(lambda: fk(i)))
                if label in k7_dev:
                    k7_dev[label][i].append(device_ms(
                        lambda: fk(i), device, match="warp_volume")[0])
    ms = {label: [min(t) if t else None for t in row]
          for label, row in turn_ms.items()}
    for label, row in turn_ms.items():
        print(spread_line(label, row) + "  equal: " + " ".join(
            "yes" if e else "NO" for e in equal[label]))
    k7_dev_ms = {label: [min(t) if t and None not in t else None
                         for t in row] for label, row in k7_dev.items()}
    for label, row in k7_dev_ms.items():
        print(f"{'dev ' + label:41s} " + "  ".join(
            f"{'not measured':15s}" if t is None else f"{t:15.4f}"
            for t in row))
    totals = {kind: total_ms(ms, [label for label in ms
                                  if label.startswith(prefix)], len(srcs))
              for kind, prefix in (
                  ("float32 DTU map", "eval "), ("float32 train", "train "),
                  ("bf16 DTU map", "bf16 K1 eval "),
                  ("bf16 train", "bf16 K1 train "))}
    for kind, row in totals.items():
        print(f"{'K1 total ms (least), ' + kind:41s} " + "  ".join(
            f"{'n/a':15s}" if t is None else f"{t:15.3f}" for t in row))
    split = None
    if any(imgs4):
        i = max(k for k, ok in enumerate(imgs4) if ok)
        split = wrapper_split(device, builds[i], a7, make_timer(device))
        print(f"bf16 K7 wrapper, build {i}: event {split['event_ms']:.3f}"
              f" ms, device {split['device_ms']} ms "
              f"({', '.join(split['kernels'])}), host "
              f"{split['host_ms']:.3f} ms")
    return {"ms": ms, "turns_ms": turn_ms, "total_ms": totals,
            "bit_equal": equal, "k7_device_ms": k7_dev_ms,
            "k7_bf16_wrapper": split}


def wrapper_split(device, libs, a7, timer) -> dict:
    """One call of the K7 wrapper on bf16 inputs with build `libs`: its
    event ms, its kernels' device ms and names (`torch.profiler`; None
    where it records none) and the host ms of the call."""
    _build._libs.update(libs)
    fn = lambda: K7.warp_volume(*a7)
    with torch.no_grad():
        dev_ms, names = device_ms(fn, device)
        return {"event_ms": timer(fn), "device_ms": dev_ms,
                "kernels": names, "host_ms": host_ms(fn, device)}


def total_ms(ms: dict, labels, n: int) -> list:
    """Per build, the sum of its least ms over `labels` (None where the
    build lacks one of them)."""
    rows = [ms[label] for label in labels]
    return [None if any(r[i] is None for r in rows)
            else sum(r[i] for r in rows) for i in range(n)]


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
    differ = [lab for lab, row in res["bit_equal"].items() if not all(row)]
    if differ:
        raise SystemExit(f"ab_warp_fwd: builds differ from the first at "
                         f"{differ}")
    return res


if __name__ == "__main__":
    main()
