"""Per-pass timing of the fused train step (PyTorch port), and a traced
profile of whole steps.

Counterpart of `scripts/profile_train.py` (the seven timings) and
`scripts/analyze_trace.py` (a trace added up per operation), at the train
cell: 512×640, B=1, V=4, 192 planes, 48/32/8, 1024 rays × 128 samples,
128 neural-volume planes, the golden backbone and a seeded render
branch, one batch of the plane scene and the draws fixed once, as
`chip_smoke.py` phase 6 builds them. Each time is the median of 7 calls
after 2 warm-ups (`tools/timing.make_timer`: CUDA events on the card):
  * clean_fwd, aug_fwd, render_fwd: a pass's forward and its loss as the
    step runs them (`train/step.clean_pass`, `aug_pass`, `render_pass`,
    autograd recording, remat as configured);
  * clean_grad, aug_grad, render_grad: the same, then the backward of
    that pass's loss alone (the aug pass against a fixed pseudo-depth,
    the render pass on a fixed volume, so each backward stops at its own
    pass); a pass's backward, its recompute included, is its grad less
    its fwd;
  * step: the full fused step (`make_train_step`: the three passes, one
    backward, one Adam step), beside its peak `max_memory_allocated`.
The calls update the BatchNorm buffers, and the step the parameters, as
training does; nothing here checks a number.

`--trace DIR` then traces `--trace_steps` steps with `torch.profiler`
(the train CLI's `_start_profile` / `_stop_profile`: DIR/profile/
trace.json), each in a `train_step` span, and prints `aggregate`'s
split: device ms per step by kernel name (the top `--top`) with its share
of the step, each port kernel (K1, K2, K6, K7, K8 dw, their bf16
instances) against the rest by class (BatchNorm, cuDNN and cuBLAS,
elementwise, reductions, Adam, copies ...), the device's idle share
within the traced window and, since the profiler slows the host, against
the untraced step's time too. On the CPU the trace holds no device time
("not measured").

Usage:
  python -m rcmvsnet_tpu_torch.tools.profile_train [--no_remat]
      [--train_dtype bfloat16] [--device cuda] [--trace DIR]
      [--trace_steps 3] [--top 25]
Without --no_remat the step rematerializes both levels (RunConfig's
default). `--device cpu` runs the plain versions and times them with the
host clock.
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import torch

from ..cli.eval_dtu import resolve_device
from ..cli.train import _start_profile, _stop_profile
from ..config import BackboneConfig, Config, RenderConfig, RunConfig
from ..data.plane_scene import plane_scene
from ..data.synthetic import batch_from_views
from ..train.state import create_train_state
from ..train.step import (aug_pass, batch_to, clean_pass, draw_step,
                          make_train_step, render_pass)
from ..weights import ASSET, load_state_dict
from .timing import device_label, make_timer

H, W, VIEWS, NDEPTH, SEED = 512, 640, 4, 192, 5
RENDER = RenderConfig()          # 1024 rays × 128 samples, 128 planes
KEYS = ("clean_fwd", "aug_fwd", "render_fwd", "clean_grad", "aug_grad",
        "render_grad", "step")

# the port's kernels by their CUDA function names (a bf16 instance names
# bfloat16 in its template arguments, or bf16 in its own name); K6 and K7's backward share the
# fixed-point scatter's helpers (`csrc/warp_bwd.cuh`)
PORT_KERNELS = (
    ("K1 warp_variance", r"\bwarp_variance(_bf16)?_kernel\b"),
    ("K6 warp_variance_bwd", r"\bwarp_variance_bwd(_bf16)?_kernel\b"),
    ("K7 warp_volume", r"\bwarp_volume(_bf16)?_kernel\b"),
    ("K7 warp_volume_bwd", r"\bwarp_volume_bwd(_bf16)?_kernel\b"),
    ("K6/K7 bwd helpers", r"\b(absmax_kernel|choose_quantum|from_quanta)\b"),
    ("K2 conv3d", r"\b(conv3d_(bf16_)?tc|prep_weights(_bf16)?)\b"),
    ("K8 dw conv3d_dw", r"\b(conv3d_dw_(bf16_)?tc|sum_chunks(_bf16)?)\b"),
    ("K4 depth_tail", r"\bdepth_tail_(kernel|stream)\b"),
    ("K5 conv2d", r"\b(conv2d_kernel|conv2d_tc|lateral_conv2d_tc|"
                  r"conv2d_bf16_(direct|tc|prep)|lateral_conv2d_bf16_tc)\b"),
    ("K10 warp_view", r"\bwarp_view_(lanes|scalar)_kernel\b"),
)
# everything else, by the first pattern its name matches
OTHER_KERNELS = (
    ("BatchNorm (cuDNN, ATen)", r"^cudnn::bn_|batch_norm|welford"),
    ("cuDNN convs, cuBLAS GEMMs", r"cudnn|xmma|cutlass|cublas|gemm|gemv|"
                                  r"fft|implicit_convolve|dgrad|wgrad|"
                                  r"fprop|^sm\d+_"),
    ("Adam / foreach (multi_tensor_apply)", r"multi_tensor_apply|adam"),
    ("softmax", r"softmax"),
    ("grid_sample", r"grid_sampler"),
    ("index / gather / scatter", r"index|gather|scatter"),
    ("reductions", r"reduce"),
    ("elementwise", r"elementwise"),
    ("copies / fills", r"copy|fill|cat_|catarray"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def build(cfg: Config, device):
    """(state, batch, draws) of the train cell under cfg."""
    batch = batch_to(batch_from_views([plane_scene(H, W, VIEWS, SEED)],
                                      NDEPTH, SEED), device)
    state = create_train_state(cfg, VIEWS, 1000, device, seed=SEED,
                               state_dicts=(load_state_dict(ASSET), None))
    draws = draw_step(torch.Generator(device=device).manual_seed(SEED), cfg,
                      1, H, W)
    return state, batch, draws


def run(cfg: Config, device, trace=None, trace_steps: int = 3,
        top: int = 25) -> dict:
    """Time the seven calls (and trace steps into `trace`); print a line
    each; return {"ms": {key: ms}, "step_peak_bytes", "trace"}."""
    timer = make_timer(device)
    state, batch, draws = build(cfg, device)
    dlossw = tuple(cfg.loss.dlossw)
    kw = dict(remat=cfg.run.remat)
    with torch.no_grad():
        outputs, volume, _, _ = clean_pass(state.cascade, batch, dlossw)
    pseudo = outputs["depth"]
    losses = {
        "clean": lambda: clean_pass(state.cascade, batch, dlossw, **kw)[2],
        "aug": lambda: aug_pass(state.cascade, batch, draws.mask_origin,
                                pseudo, dlossw, **kw)[1],
        "render": lambda: sum(render_pass(state.render, batch, volume,
                                          pseudo, draws.rays, **kw)[1:3])}

    def grad(loss):
        def call():
            state.optimizer.zero_grad(set_to_none=True)
            loss().backward()
        return call

    ms = {}
    for name, loss in losses.items():
        ms[f"{name}_fwd"] = timer(loss)
    for name, loss in losses.items():
        ms[f"{name}_grad"] = timer(grad(loss))
    step = make_train_step(cfg)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ms["step"] = timer(lambda: step(state, batch, draws))
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    for key in KEYS:
        print(f"{key:36s} {ms[key]:9.2f} ms")
    print(f"{'steps/s':36s} {1e3 / ms['step']:9.3f}")
    agg = None
    if trace:
        if cuda:
            torch.cuda.synchronize(device)
        prof = _start_profile(device)
        for _ in range(trace_steps):
            with torch.profiler.record_function("train_step"):
                step(state, batch, draws)
        _stop_profile(prof, trace, device)
        events = json.loads((Path(trace) / "profile" / "trace.json")
                            .read_text())["traceEvents"]
        agg = aggregate(events, trace_steps, top)
        if agg["busy_ms_per_step"] is not None:
            # the profiler slows the host, so the traced window holds
            # idle time that an untraced step does not
            agg["untraced_step_ms"] = ms["step"]
            agg["idle_share_of_untraced_step"] = (
                1.0 - agg["busy_ms_per_step"] / ms["step"])
        print_aggregate(agg)
    return {"ms": ms, "step_peak_bytes": peak, "trace": agg}


def short_name(name: str) -> str:
    """A kernel's name without `void `, anonymous namespaces and its
    argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:100]


def classify(name: str, cat: str = "kernel") -> str:
    """The class of a device event: its port kernel (with " bf16" for a
    bf16 instance), or a class of everything else."""
    if cat.lower() != "kernel":
        return "copies / fills"
    for label, pattern in PORT_KERNELS:
        if re.search(pattern, name):
            bf16 = re.search(r"bfloat16|bf16", name)
            return label + (" bf16" if bf16 else "")
    low = short_name(name).lower()
    for label, pattern in OTHER_KERNELS:
        if re.search(pattern, low):
            return label
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def aggregate(events, steps: int, top: int = 25) -> dict:
    """The device's work in a chrome trace's events (as `torch.profiler`
    exports them) over `steps` traced steps: device ms per step by kernel
    name (top `top`) and by class, port kernels against the rest, and the
    idle share of the step window. The window runs from the first
    `train_step` span's start (or the first device event) to the last
    device event's or span's end; idle is the window less the union of
    the device events. Without device events every device figure is None
    ("not measured")."""
    dev = [e for e in events if e.get("ph") == "X"
           and str(e.get("cat", "")).lower() in DEVICE_CATS]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") == "train_step"
             and str(e.get("cat", "")).lower() == "user_annotation"]
    out = {"steps": steps, "device_events": len(dev),
           "train_step_spans": len(spans)}
    if not dev:
        return {**out, "window_ms_per_step": None, "busy_ms_per_step": None,
                "idle_share": None, "by_name": [], "by_class": {},
                "port_ms_per_step": None, "other_ms_per_step": None,
                "unclassified": []}
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
          for e in dev]
    start = min([a for a, _ in iv] + [float(e["ts"]) for e in spans])
    end = max([b for _, b in iv] + [float(e["ts"]) + float(e["dur"])
                                    for e in spans])
    per = lambda us: us / 1e3 / steps
    window = per(end - start)
    busy = per(_union_us(iv))
    names, classes, other = {}, {}, {}
    for e, (a, b) in zip(dev, iv):
        name = short_name(str(e.get("name", "")))
        names[name] = names.get(name, 0.0) + (b - a)
        cls = classify(str(e.get("name", "")), str(e.get("cat", "")))
        classes[cls] = classes.get(cls, 0.0) + (b - a)
        if cls == "other":
            other[name] = other.get(name, 0.0) + (b - a)
    ranked = sorted(names.items(), key=lambda t: -t[1])[:top]
    by_class = {k: per(v) for k, v in sorted(classes.items(),
                                             key=lambda t: -t[1])}
    port = sum(v for k, v in by_class.items() if re.match(r"K\d", k))
    return {**out, "window_ms_per_step": window, "busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / window if window > 0 else None,
            "by_name": [{"name": n, "ms_per_step": per(us),
                         "share_of_step": per(us) / window}
                        for n, us in ranked],
            "by_class": by_class, "port_ms_per_step": port,
            "other_ms_per_step": sum(by_class.values()) - port,
            "unclassified": [{"name": n, "ms_per_step": per(us)} for n, us
                             in sorted(other.items(),
                                       key=lambda t: -t[1])[:8]]}


def print_aggregate(agg: dict) -> None:
    n = agg["steps"]
    if agg["idle_share"] is None:
        print(f"trace: {n} steps, {agg['device_events']} device events: "
              f"device time not measured")
        return
    print(f"trace: {n} steps; per step: window "
          f"{agg['window_ms_per_step']:.3f} ms, device busy "
          f"{agg['busy_ms_per_step']:.3f} ms, idle share "
          f"{agg['idle_share']:.4f}")
    print("top kernels (device ms per step, share of the step):")
    for row in agg["by_name"]:
        print(f"  {row['ms_per_step']:9.3f}  {row['share_of_step']:.4f}  "
              f"{row['name']}")
    print("by class (device ms per step):")
    for cls, ms in agg["by_class"].items():
        print(f"  {ms:9.3f}  {cls}")
    print(f"port kernels {agg['port_ms_per_step']:.3f} ms, everything "
          f"else {agg['other_ms_per_step']:.3f} ms per step")
    print("unclassified (device ms per step): " + "; ".join(
        f"{row['ms_per_step']:.3f} {row['name']}"
        for row in agg["unclassified"]))
    if agg.get("untraced_step_ms"):
        print(f"device busy {agg['busy_ms_per_step']:.3f} ms of the "
              f"untraced step's {agg['untraced_step_ms']:.3f} ms: idle "
              f"share {agg['idle_share_of_untraced_step']:.4f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--no_remat", action="store_true",
                   help="the step without rematerialization (default: "
                        "RunConfig's, both levels)")
    p.add_argument("--train_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="trace --trace_steps steps into DIR/profile and "
                        "print their device split")
    p.add_argument("--trace_steps", type=int, default=3)
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    label = device_label(device)
    cfg = Config(backbone=BackboneConfig(train_dtype=args.train_dtype),
                 render=RENDER, run=RunConfig(remat=not args.no_remat))
    remat = ("none" if not cfg.run.remat else
             "both levels" if cfg.run.remat_modules else "pass level")
    print(f"device: {label} | {W}x{H} B=1 V={VIEWS} {NDEPTH} planes "
          f"{'/'.join(map(str, cfg.backbone.ndepths))}, {RENDER.n_rays} "
          f"rays x {RENDER.n_samples} samples, {RENDER.num_planes} planes | "
          f"{args.train_dtype} | remat {remat}")
    res = run(cfg, device, args.trace, args.trace_steps, args.top)
    print(json.dumps({"device": label, "train_dtype": args.train_dtype,
                      "remat": remat, **res}))
    return res


if __name__ == "__main__":
    main()
