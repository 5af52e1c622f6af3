"""A/B timing of the forward plane sweeps K1 (`ops/warp_variance`, the
fused warp + variance) and K7 (`ops/warp_volume`, the stage-1 train
volume) for builds of their CUDA sources, in turns, on one card, with the
builds' outputs held equal bit for bit.

Each argument is a directory holding `warp_variance.cu`,
`warp_volume.cu`, the shared headers (`warp_common.cuh`, `warp_bwd.cuh`
and, where the build has them, `warp_fwd.cuh` and `warp_bf16.cuh`) and,
where the build has them, `warp_variance_bf16.cu` (K1-bf16 and K6-bf16)
and `warp_volume_bf16.cu` (K7bwd-bf16); older builds export those from
`warp_variance.cu` and `warp_volume.cu` (`load_builds`); default: the
package's own `ops/csrc/`. Every build runs the same inputs: K1 at the
DTU eval shapes (864×1152, V=5, stages 48/32/8 planes;
`tools/profile_breakdown.stage_inputs`) and at the train shapes
(512×640, V=4; `tools/repeat_warp_bwd.train_stages`), and K7's forward
at the train stage-1 shape (the same features, the images resized to
it). K1 runs through the package's wrapper; K7 through its C entry,
called as the build's source declares it: (var, vol) in the render
volume's layout, or, for a build from before that layout, (var, var_nr,
wimg) with var_nr and wimg pointed at vol's two row slices, so both
write the same tensor. The builds take turns A, B, ..., B, A, A, B, ...
for `--rounds` rounds (default 2); each call's time is the smallest of
its build's turns (each the median of 7 CUDA-event timings,
`tools/timing`), printed with the largest. Before it is timed, each
result is held to its plain version (1e-4 of the largest value) and to
the first build's result with `torch.equal` (every bit); the tool fails
after its report if any build's output differs. The bf16 instances run
too ("bf16 ..." rows: K1-bf16 at the DTU and the train stages, K7-bf16 at
stage 1, through the wrappers, on the inputs rounded to bf16; held to
their bf16 plain versions to one bf16 ulp of each element + 1e-4 of the
largest value), on the builds whose libraries export them ("n/a"
elsewhere). The report ends with K1's float32 and bf16 totals over the DTU
stages (a map) and over the train stages.

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
from .timing import device_label, make_timer

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
# likewise K7bwd-bf16, which a build from before `warp_volume_bf16.cu`
# exports from `warp_volume.cu`
OLD_VOLUME_BF16 = {"warp_volume_bwd_bf16": "warp_volume_bwd_bf16",
                   "warp_volume_bf16_bwd_scratch_bytes":
                       "warp_volume_bwd_scratch_bytes"}


def load_builds(srcs) -> list[dict]:
    """Each build's libraries by name (`_build.load_from` of the sources
    of LIBS its directory holds). A build without `warp_variance_bf16.cu`
    (or `warp_volume_bf16.cu`) serves the bf16 entries of its
    `warp_variance.cu` (`warp_volume.cu`) under the new library's name,
    so the wrappers launch the current build's K1-bf16, K6-bf16 and
    K7bwd-bf16 whichever source holds them."""
    builds = []
    for s in srcs:
        names = [n for n in LIBS if (Path(s) / f"{n}.cu").exists()]
        libs = _build.load_from(Path(s), names)
        for new_lib, old_lib, entries in (
                ("warp_variance_bf16", "warp_variance", OLD_BF16),
                ("warp_volume_bf16", "warp_volume", OLD_VOLUME_BF16)):
            if new_lib not in libs:
                old = libs[old_lib]
                libs[new_lib] = SimpleNamespace(**{
                    new: getattr(old, name) for new, name in entries.items()
                    if hasattr(old, name)})
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


def entry_pointers(src_dir: Path, entry: str) -> int:
    """The float pointers among the parameters of `entry`'s extern "C"
    declaration in src_dir/warp_volume.cu (the build's C interface)."""
    text = (Path(src_dir) / "warp_volume.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    return m.group(1).count("float*")


def k7_call(lib, n_ptr: int, feats, imgs, projs, lo, step, nd):
    """K7's forward through one build's C entry: (var, vol), vol in the
    render volume's layout whichever interface the build has (7 pointers:
    var, vol; 8: var, var_nr, wimg)."""
    V, h, w, C = feats.shape
    rel = K1.relative_projections(projs)
    var = torch.empty((C, nd, h, w), device=feats.device)
    vol = torch.empty((3 * (V - 1) + C, nd, h, w), device=feats.device)
    outs = [var.data_ptr(), vol.data_ptr()]
    if n_ptr == 8:
        outs = [var.data_ptr(), vol[3 * (V - 1):].data_ptr(),
                vol.data_ptr()]
    fn = lib.warp_volume_f32
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(feats.data_ptr(), imgs.data_ptr(), rel.data_ptr(),
             lo.data_ptr(), step.data_ptr(), *outs, V, h, w, C, nd,
             _build.stream_ptr(feats.device))
    _build.check(err, "warp_volume (ab_warp_fwd)")
    return var, vol


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
    # the bf16 instances, through the wrappers
    for label, args in k1_calls:
        a = (args[0].bfloat16(), *args[1:])
        calls.append((f"bf16 K1 {label}", ("warp_variance_bf16",
                                           "warp_variance_bf16"),
                      lambda i, a=a: (K1.warp_variance(*a),),
                      lambda a=a: (K1.warp_variance_plain(*a),)))
    a7 = (k7_args[0].bfloat16(), k7_args[1].bfloat16(), *k7_args[2:])
    calls.append((f"bf16 {k7_label}", ("warp_volume", "warp_volume_bf16"),
                  lambda i: K7.warp_volume(*a7),
                  lambda: K7.warp_volume_plain(*a7)))
    timer = make_timer(device)
    turn_ms = {c[0]: [[] for _ in builds] for c in calls}
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
    ms = {label: [min(t) if t else None for t in row]
          for label, row in turn_ms.items()}
    for label, row in turn_ms.items():
        print(spread_line(label, row) + "  equal: " + " ".join(
            "yes" if e else "NO" for e in equal[label]))
    totals = {kind: total_ms(ms, [label for label in ms
                                  if label.startswith(prefix)], len(srcs))
              for kind, prefix in (
                  ("float32 DTU map", "eval "), ("float32 train", "train "),
                  ("bf16 DTU map", "bf16 K1 eval "),
                  ("bf16 train", "bf16 K1 train "))}
    for kind, row in totals.items():
        print(f"{'K1 total ms (least), ' + kind:41s} " + "  ".join(
            f"{'n/a':15s}" if t is None else f"{t:15.3f}" for t in row))
    return {"ms": ms, "turns_ms": turn_ms, "total_ms": totals,
            "bit_equal": equal}


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
