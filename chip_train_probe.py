#!/usr/bin/env python3
"""Noise floor and power of chip_smoke.py's train-step gates, on one card.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_train_probe.py

It builds the kernels, then runs step 1 of the train step (chip_smoke.py's
phase 6: 512x640, V=4, the golden backbone, a seeded render branch, the
plane scene, fixed draws) from a fresh train state many times, in three
fresh processes, and prints one JSON line per comparison:
  * repeat  kernel vs kernel and plain vs plain in one process, with and
            without `torch.backends.cudnn.deterministic`;
  * across  the same runs between processes, with the first operation of
            the forward whose output differs (a bit checksum of every
            module, warp and 3D-conv output, in call order);
  * terms   kernel vs plain (deterministic) with only the backbone's loss
            terms and with only the render terms, to see where the
            gradient gap comes from;
  * plant   kernel vs plain (deterministic) with K6's or K7's backward or
            K8's dw scaled by 1.01 and by 1.1 — faults the gradient gate
            should catch;
  * nondeterministic  the operations torch reports as nondeterministic on
            the plain path (`use_deterministic_algorithms(warn_only=True)`).
Each comparison gives the step-1 losses' relative deltas and, for the
gradients, the largest per-tensor ‖Δ‖₂ / ‖g‖₂ (the quantity chip_smoke.py
gates), the largest |Δ| over its model's and over its network's largest
gradient, and the worst tensors. Everything also goes to
chiprun_out/train_probe.json.

    python3 chip_train_probe.py --bf16

does the same for the bf16 train step (train_dtype bfloat16, chip_smoke.py
phase 14 (b)), in one process: kernel vs plain (deterministic cuDNN) at
BF16_SEEDS (each seed draws the scene, the render branch's init and the
step's draws), then at the first seed with K6's or K7's backward or K8's
dw scaled by 1.01 and by 1.1. Each line gives, per network, ‖Δ‖₂ / ‖g‖₂
over its gradients (the quantity phase 14 (b) gates) and the step-1
losses' relative deltas; everything also goes to
chiprun_out/train_probe_bf16.json.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
MAIN_RUNS = (
    ("plain", {}), ("plain", {}),
    ("plain_det", {"det": True}), ("plain_det", {"det": True}),
    ("kernel", {}), ("kernel", {}),
    ("kernel_det", {"det": True}),
    ("plain_warn", {"warn": True}),
    ("kernel_backbone_terms", {"zero": "render"}),
    ("plain_backbone_terms", {"zero": "render", "det": True}),
    ("kernel_render_terms", {"zero": "backbone"}),
    ("plain_render_terms", {"zero": "backbone", "det": True}),
    *((f"kernel_plant_{k}_{s}", {"plant": (k, s)})
      for k in ("k6", "k7", "k8dw") for s in (1.01, 1.1)),
)
SIDE_RUNS = (("plain", {}), ("plain_det", {"det": True}), ("kernel", {}))
BF16_SEEDS = (5, 0, 1, 2, 3, 4)          # chip_smoke.SEED first


def checksum(t) -> int:
    """Sum of the float32 bit patterns: differs if any bit differs (almost
    surely)."""
    import torch
    return int(t.detach().float().contiguous().view(torch.int32)
               .to(torch.int64).sum())


class Recorder:
    """Bit checksums of the forward's outputs, in call order."""

    def __init__(self):
        self.trace = []
        self.on = False

    def add(self, name, out):
        if not self.on:
            return
        outs = out if isinstance(out, tuple) else (out,)
        self.trace.append((name, [checksum(o) for o in outs
                                  if hasattr(o, "view")]))

    def wrap(self, module, attr):
        orig = getattr(module, attr)

        def fn(*a, **k):
            out = orig(*a, **k)
            self.add(attr, out)
            return out
        setattr(module, attr, fn)

    def hook_modules(self, model, prefix):
        for name, m in model.named_modules():
            if not list(m.children()):
                m.register_forward_hook(
                    lambda mod, a, out, n=f"{prefix}{name}": self.add(n, out))


def patched(module, attr, make):
    """Context: module.attr replaced by make(original). A kernel wrapper
    counts its launches on the module's attribute, so the replacement
    carries the counts."""
    @contextlib.contextmanager
    def ctx():
        orig = getattr(module, attr)
        new = make(orig)
        new.launches = getattr(orig, "launches", 0)
        if hasattr(orig, "bf16"):          # the bf16 instance's count
            new.bf16 = orig.bf16
        setattr(module, attr, new)
        try:
            yield
        finally:
            setattr(module, attr, orig)
    return ctx()


def child(tag: str, runs) -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from rcmvsnet_tpu_torch.config import Config
    from rcmvsnet_tpu_torch.core.geometry import set_full_precision
    from rcmvsnet_tpu_torch.data.synthetic import batch_from_views
    from rcmvsnet_tpu_torch.models import cascade as cascade_mod
    from rcmvsnet_tpu_torch.nn import costreg
    from rcmvsnet_tpu_torch.ops import conv3d_train as k8
    from rcmvsnet_tpu_torch.ops import warp_variance as k6
    from rcmvsnet_tpu_torch.ops import warp_volume as k7
    from rcmvsnet_tpu_torch.train import step as step_mod
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict

    set_full_precision()
    dev = torch.device("cuda")
    cfg = Config()
    scene = chip_smoke.plane_scene(chip_smoke.TH, chip_smoke.TW,
                                   chip_smoke.TV, chip_smoke.SEED)
    batch = step_mod.batch_to(
        batch_from_views([scene], chip_smoke.NDEPTH, chip_smoke.SEED), dev)
    B, V, H, W = batch["imgs"].shape[:4]
    draws = step_mod.draw_step(
        torch.Generator(device=dev).manual_seed(chip_smoke.SEED), cfg, B, H, W)
    backbone = load_state_dict(ASSET)
    rec = Recorder()
    for attr in ("conv3d_train_plain", "conv3d_train"):
        rec.wrap(costreg, attr)
    for attr in ("warp_variance_plain", "warp_volume_plain",
                 "warp_variance_train", "warp_volume_train"):
        rec.wrap(cascade_mod, attr)

    def zero_loss(orig):
        def fn(*a, **k):
            loss, scalars = orig(*a, **k)
            return 0.0 * loss, scalars
        return fn

    def scaled(s):
        return lambda o: lambda *a: s * o(*a)

    plants = {
        "k6": (k6, "warp_variance_bwd", scaled),
        "k7": (k7, "warp_volume_bwd",
               lambda s: lambda o: lambda *a: tuple(s * t for t in o(*a))),
        "k8dw": (k8, "conv3d_dw", scaled),
    }
    results = []
    for label, opt in runs:
        plain = label.startswith("plain")
        with contextlib.ExitStack() as stack:
            if opt.get("zero") == "render":
                for attr in ("img2mse", "sl1_loss"):
                    stack.enter_context(patched(
                        step_mod, attr,
                        lambda o: lambda *a: 0.0 * o(*a)))
            elif opt.get("zero") == "backbone":
                for attr in ("unsup_loss_multi_stage",
                             "aug_loss_multi_stage"):
                    stack.enter_context(patched(step_mod, attr, zero_loss))
            if "plant" in opt:
                name, s = opt["plant"]
                mod, attr, make = plants[name]
                stack.enter_context(patched(mod, attr, make(s)))
            caught = stack.enter_context(
                warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            torch.backends.cudnn.deterministic = bool(opt.get("det"))
            torch.use_deterministic_algorithms(bool(opt.get("warn")),
                                               warn_only=True)
            state = create_train_state(cfg, V, 1000, dev,
                                       seed=chip_smoke.SEED,
                                       state_dicts=(backbone, None))
            rec.trace = []
            rec.on = label in ("plain", "plain_det", "kernel", "kernel_det")
            if rec.on:
                rec.hook_modules(state.cascade, "cascade.")
                rec.hook_modules(state.render, "render.")
            train_step = step_mod.make_train_step(cfg, plain=plain)
            metrics = {k: float(v) for k, v in
                       train_step(state, batch, draws).items()}
            rec.on = False
            grads = {f"render.{n}": p.grad.detach().cpu()
                     for n, p in state.render.named_parameters()}
            grads.update({n: p.grad.detach().cpu()
                          for n, p in state.cascade.named_parameters()})
            torch.backends.cudnn.deterministic = False
            torch.use_deterministic_algorithms(False)
            nondet = sorted({str(w.message).split(" does not have")[0]
                             for w in caught
                             if "deterministic" in str(w.message)})
        results.append({"label": label, "opt": {k: str(v) for k, v in
                                                 opt.items()},
                        "metrics": metrics, "grads": grads,
                        "trace": list(rec.trace), "nondet": nondet})
        del state
        torch.cuda.empty_cache()
    torch.save(results, OUT / f"train_probe_{tag}.pt")


def losses_delta(a, b):
    keys = ("loss", "repr_loss", "aug_loss", "img_loss", "ray_depth_loss")
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in keys}


NETWORKS = ("feature.", "cost_regularization.0.", "cost_regularization.1.",
            "cost_regularization.2.", "render.MVSNet.", "render.network_fn.")


def _of_group(a, b, groups):
    """{name: max|Δ| over the largest |g| of b's group holding name}."""
    group = {n: next(p for p in groups if n.startswith(p)) for n in b}
    scale = {p: max(float(b[n].abs().max()) for n in b if group[n] == p)
             for p in groups}
    return {n: float((a[n] - g).abs().max()) / max(scale[group[n]], 1e-30)
            for n, g in b.items()}


def _top(d, k=5):
    return sorted(d.items(), key=lambda t: -t[1])[:k]


def grads_delta(a, b):
    """The largest per-tensor ‖Δ‖₂ / ‖g‖₂ (g is b's; the quantity
    chip_smoke.py gates), the largest |Δ| over its model's and over its
    network's largest |g|, and the worst tensors by each."""
    of_model = _of_group(a, b, ("render.", ""))
    of_net = _of_group(a, b, NETWORKS)
    of_tensor = {n: float((a[n] - g).abs().max())
                 / max(float(g.abs().max()), 1e-30) for n, g in b.items()}
    l2 = {n: float((a[n] - g).norm()) / max(float(g.norm()), 1e-30)
          for n, g in b.items()}
    worst = max(of_model, key=of_model.get)
    return {"l2_rel_max": max(l2.values()),
            "of_model_scale": of_model[worst], "worst": worst,
            "of_network_scale": _top(of_net, 3),
            "worst_tensors_of_own_scale": _top(of_tensor),
            "worst_tensors_l2_rel": _top(l2)}


def first_difference(ta, tb):
    for i, ((na, ca), (nb, cb)) in enumerate(zip(ta, tb)):
        if na != nb:
            return {"index": i, "op": f"{na} / {nb}", "why": "call order"}
        if ca != cb:
            return {"index": i, "op": na, "of": len(ta)}
    return None if len(ta) == len(tb) else {"why": "trace lengths",
                                             "a": len(ta), "b": len(tb)}


def compare(kind, what, a, b, out):
    row = {"kind": kind, "what": what,
           "loss_rel": losses_delta(a["metrics"], b["metrics"]),
           "grads": grads_delta(a["grads"], b["grads"]),
           "step1_loss": [a["metrics"]["loss"], b["metrics"]["loss"]]}
    if kind in ("repeat", "across") and a["trace"] and b["trace"]:
        row["first_forward_difference"] = first_difference(a["trace"],
                                                           b["trace"])
    print(json.dumps(row), flush=True)
    out.append(row)


def net_l2(a, b) -> dict:
    """{network: ‖a − b‖₂ / ‖b‖₂ over its gradients}."""
    out = {}
    for net in NETWORKS:
        names = [n for n in b if n.startswith(net)]
        d = sum(float((a[n] - b[n]).norm()) ** 2 for n in names)
        r = sum(float(b[n].norm()) ** 2 for n in names)
        out[net] = (d / max(r, 1e-60)) ** 0.5
    return out


def bf16_main(smi: str) -> int:
    """The bf16 step's kernel-vs-plain gradient distances per network,
    over BF16_SEEDS and under planted faults (see the module doc)."""
    import dataclasses
    import torch
    import chip_smoke
    from rcmvsnet_tpu_torch.config import Config
    from rcmvsnet_tpu_torch.core.geometry import set_full_precision
    from rcmvsnet_tpu_torch.data.synthetic import batch_from_views
    from rcmvsnet_tpu_torch.ops import conv3d_train as k8
    from rcmvsnet_tpu_torch.ops import warp_variance as k6
    from rcmvsnet_tpu_torch.ops import warp_volume as k7
    from rcmvsnet_tpu_torch.train import step as step_mod
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict

    set_full_precision()
    dev = torch.device("cuda")
    base = Config()
    cfg = base.replace(backbone=dataclasses.replace(
        base.backbone, train_dtype="bfloat16"))
    backbone = load_state_dict(ASSET)
    scaled = lambda s: lambda o: lambda *a: s * o(*a)
    plants = {
        "k6": (k6, "warp_variance_bwd", scaled),
        "k7": (k7, "warp_volume_bwd",
               lambda s: lambda o: lambda *a: tuple(s * t for t in o(*a))),
        "k8dw": (k8, "conv3d_dw", scaled),
    }

    def run(seed, plain, plant=None):
        scene = chip_smoke.plane_scene(chip_smoke.TH, chip_smoke.TW,
                                       chip_smoke.TV, seed)
        batch = step_mod.batch_to(
            batch_from_views([scene], chip_smoke.NDEPTH, seed), dev)
        B, V, H, W = batch["imgs"].shape[:4]
        draws = step_mod.draw_step(
            torch.Generator(device=dev).manual_seed(seed), cfg, B, H, W)
        with contextlib.ExitStack() as stack:
            if plant:
                mod, attr, make = plants[plant[0]]
                stack.enter_context(patched(mod, attr, make(plant[1])))
            torch.backends.cudnn.deterministic = plain
            state = create_train_state(cfg, V, 1000, dev, seed=seed,
                                       state_dicts=(backbone, None))
            metrics = {k: float(v) for k, v in step_mod.make_train_step(
                cfg, plain=plain)(state, batch, draws).items()}
            torch.backends.cudnn.deterministic = False
        grads = {f"render.{n}": p.grad.detach().cpu()
                 for n, p in state.render.named_parameters()}
        grads.update({n: p.grad.detach().cpu()
                      for n, p in state.cascade.named_parameters()})
        del state
        torch.cuda.empty_cache()
        return {"metrics": metrics, "grads": grads}

    out = []

    def compare(what, a, b):
        row = {"what": what, "net_l2": net_l2(a["grads"], b["grads"]),
               "loss_rel": losses_delta(a["metrics"], b["metrics"])}
        print(json.dumps(row), flush=True)
        out.append(row)

    plain0 = None
    for seed in BF16_SEEDS:
        plain = run(seed, True)
        compare(f"seed {seed}: kernel vs plain", run(seed, False), plain)
        plain0 = plain0 or plain
    for k in plants:
        for s in (1.01, 1.1):
            compare(f"seed {BF16_SEEDS[0]}, {k} x{s}: kernel vs plain",
                    run(BF16_SEEDS[0], False, (k, s)), plain0)
    OUT.mkdir(exist_ok=True)
    (OUT / "train_probe_bf16.json").write_text(json.dumps(
        {"device": smi, "comparisons": out}, indent=1))
    print(smi)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_train_probe: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from rcmvsnet_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__}", flush=True)
    _build.build_all()
    if "--bf16" in sys.argv:
        return bf16_main(smi)
    OUT.mkdir(exist_ok=True)
    for tag in ("a", "b", "c"):
        subprocess.run([sys.executable, __file__, "--child", tag], check=True,
                       cwd=ROOT)
    res = {t: {r["label"] + (f"#{i}" if r["label"] in ("plain", "plain_det",
                                                       "kernel") else ""): r
               for i, r in enumerate(torch.load(OUT / f"train_probe_{t}.pt",
                                               weights_only=False))}
           for t in ("a", "b", "c")}
    for t in ("a", "b", "c"):
        (OUT / f"train_probe_{t}.pt").unlink()
    a, b, c = res["a"], res["b"], res["c"]
    out = []
    compare("repeat", "plain vs plain", a["plain#0"], a["plain#1"], out)
    compare("repeat", "plain_det vs plain_det", a["plain_det#2"],
            a["plain_det#3"], out)
    compare("repeat", "kernel vs kernel", a["kernel#4"], a["kernel#5"], out)
    compare("repeat", "kernel_det vs kernel", a["kernel_det"], a["kernel#4"],
            out)
    compare("repeat", "plain_det vs plain", a["plain_det#2"], a["plain#0"],
            out)
    for other, name in ((b, "b"), (c, "c")):
        compare("across", f"plain a vs {name}", a["plain#0"],
                other["plain#0"], out)
        compare("across", f"plain_det a vs {name}", a["plain_det#2"],
                other["plain_det#1"], out)
        compare("across", f"kernel a vs {name}", a["kernel#4"],
                other["kernel#2"], out)
        compare("sound", f"kernel vs plain in {name}", other["kernel#2"],
                other["plain#0"], out)
        compare("sound", f"kernel vs plain_det in {name}", other["kernel#2"],
                other["plain_det#1"], out)
    compare("sound", "kernel vs plain", a["kernel#4"], a["plain#0"], out)
    compare("sound", "kernel vs plain_det", a["kernel#4"], a["plain_det#2"],
            out)
    compare("terms", "backbone terms only: kernel vs plain",
            a["kernel_backbone_terms"], a["plain_backbone_terms"], out)
    compare("terms", "render terms only: kernel vs plain",
            a["kernel_render_terms"], a["plain_render_terms"], out)
    for k in ("k6", "k7", "k8dw"):
        for s in (1.01, 1.1):
            compare("plant", f"{k} x{s}: kernel vs plain",
                    a[f"kernel_plant_{k}_{s}"], a["plain_det#2"], out)
    nondet = a["plain_warn"]["nondet"]
    print(json.dumps({"nondeterministic_on_plain_path": nondet}))
    (OUT / "train_probe.json").write_text(json.dumps(
        {"device": smi, "comparisons": out,
         "nondeterministic_on_plain_path": nondet}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2], MAIN_RUNS if sys.argv[2] == "a" else SIDE_RUNS)
        sys.exit(0)
    sys.exit(main())
