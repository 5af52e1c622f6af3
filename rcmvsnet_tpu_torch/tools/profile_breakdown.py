"""Per-component timing of the eval cascade (PyTorch port).

Counterpart of `scripts/profile_breakdown.py`, at its shape (864×1152,
V=5, 192 planes, 48/32/8) with the port's golden weights
(`assets/backbone_synth.npz`) on the in-memory plane scene. Times, each
the median of 7 calls after 2 warm-ups (CUDA events on the card):
  * the whole forward (`CascadeMVSNet.forward`, every kernel);
  * FeatureNet (`forward_folded`, K5);
  * per stage: the fused warp + variance (K1), the same variance built from
    one warped volume per source view (`plane_sweep_variance_views`, the
    K10 route), the CostRegNet (`forward_folded`, K2) and the softmax /
    regression / confidence tail (K4).
Hypotheses as the JAX tool sets them: the full sweep at stage 1, a ±10
window around the middle depth at stages 2 and 3.

Usage:
  python -m rcmvsnet_tpu_torch.tools.profile_breakdown [--device cuda] \
      [--eval_dtype bfloat16]
`--device cpu` runs the plain versions and times them with the host clock.
`--eval_dtype bfloat16` times the bf16 eval path (K5, K1 and K2 in their
bf16 instances; the K10 route samples the bf16 features in float32).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..cli.eval_dtu import add_eval_dtype, resolve_device
from ..config import BackboneConfig
from ..core.geometry import compose_projection
from ..data.plane_scene import dtu_samples, plane_scene
from ..models.cascade import STAGE_SCALES, CascadeMVSNet, eval_dtype
from ..ops.depth_tail import depth_tail
from ..ops.warp_variance import warp_variance
from ..ops.warp_view import plane_sweep_variance_views
from ..weights import ASSET, load_state_dict
from .timing import device_label, make_timer

H, W, VIEWS, NDEPTH, SEED = 864, 1152, 5, 192, 0


def stage_planes(s: int, nd: int, depth_values: np.ndarray, h: int, w: int,
                 device):
    """Stage s's hypotheses dv(d) = lo + d·step as (lo, step), each
    [h, w]: the full sweep at stage 1, a window of ±10 around the middle
    depth after it."""
    d0, d1 = float(depth_values[0]), float(depth_values[-1])
    if s == 0:
        lo, step = d0, (d1 - d0) / (nd - 1)
    else:
        lo, step = 0.5 * (d0 + d1) - 10.0, 20.0 / (nd - 1)
    full = lambda v: torch.full((h, w), v, dtype=torch.float32,
                                device=device)
    return full(lo), full(step)


def stage_inputs(model: CascadeMVSNet, sample: dict, device) -> list[dict]:
    """Each stage's warp inputs: features [V, h, w, C], projections
    [V, 4, 4], (lo, step), the plane count and the hypotheses
    dv = lo + d·step [D, h, w]."""
    imgs = torch.from_numpy(sample["imgs"]).to(device)
    V, Hs, Ws, _ = imgs.shape
    feats = model.feature.forward_folded(
        imgs.permute(0, 3, 1, 2).contiguous(), out_layout="warp",
        dtype=eval_dtype(model.config))
    stages = []
    for s, nd in enumerate(model.config.ndepths):
        key = f"stage{s + 1}"
        h, w = Hs // STAGE_SCALES[s], Ws // STAGE_SCALES[s]
        lo, step = stage_planes(s, nd, sample["depth_values"], h, w, device)
        idx = torch.arange(nd, dtype=torch.float32, device=device)
        projs = compose_projection(torch.from_numpy(
            sample["proj_matrices"][key]).to(device))
        stages.append({"key": key, "nd": nd, "lo": lo, "step": step,
                       "dv": lo[None] + idx[:, None, None] * step[None],
                       "projs": projs,
                       "feats": feats[key]})
    return stages


def route_variance(st: dict) -> torch.Tensor:
    """The K10 route's variance [D, h, w, C] for one stage's inputs."""
    f, projs = st["feats"], st["projs"]
    V = f.shape[0]
    return plane_sweep_variance_views(
        f[:1], [f[v:v + 1] for v in range(1, V)],
        [projs[v:v + 1] for v in range(1, V)], projs[:1], st["dv"][None])[0]


def run(model: CascadeMVSNet, sample: dict, device) -> dict:
    """Time every component; print one line each; return {name: ms}."""
    timer = make_timer(device)
    res = {}
    as_t = lambda a: torch.from_numpy(a)[None].to(device)
    imgs = as_t(sample["imgs"])
    projs = {k: as_t(v) for k, v in sample["proj_matrices"].items()}
    dvals = as_t(sample["depth_values"])
    V, Hs, Ws = sample["imgs"].shape[:3]
    with torch.no_grad():
        res["total"] = timer(lambda: model(imgs, projs, dvals))
        print(f"total forward: {res['total']:.2f} ms "
            f"({1000 / res['total']:.2f} maps/s)")
        x = imgs[0].permute(0, 3, 1, 2).contiguous()
        res["featurenet"] = timer(lambda: model.feature.forward_folded(
            x, out_layout="warp", dtype=eval_dtype(model.config)))
        print(f"featurenet K5 ({V} views): {res['featurenet']:.2f} ms")
        for s, st in enumerate(stage_inputs(model, sample, device)):
            key, nd, f = st["key"], st["nd"], st["feats"]
            _, h, w, C = f.shape
            lo, step = st["lo"], st["step"]
            k1 = lambda: warp_variance(f, st["projs"], lo, step, nd)
            res[f"{key}_warp_k1"] = timer(k1)
            res[f"{key}_warp_k10"] = timer(lambda: route_variance(st))
            var = k1()
            cr = model.cost_regularization[s]
            res[f"{key}_costreg"] = timer(
                lambda: cr.forward_folded(var[None]))
            cost = cr.forward_folded(var[None])[0, 0].contiguous()
            res[f"{key}_tail"] = timer(lambda: depth_tail(cost, lo, step))
            print(f"{key} fused warp+var K1 [D={nd} {h}x{w} C={C}]: "
                f"{res[f'{key}_warp_k1']:.2f} ms")
            print(f"{key} per-view warp+var K10 route [{V - 1} views]: "
                f"{res[f'{key}_warp_k10']:.2f} ms")
            print(f"{key} costreg K2: {res[f'{key}_costreg']:.2f} ms")
            print(f"{key} softmax/reg/conf tail K4: "
                f"{res[f'{key}_tail']:.2f} ms")
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    add_eval_dtype(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    label = device_label(device)
    bf16 = "" if args.eval_dtype == "float32" else f" {args.eval_dtype}"
    print(f"device: {label} | {W}x{H} V={VIEWS} {NDEPTH} planes{bf16}")
    sample = dtu_samples(plane_scene(H, W, VIEWS, SEED), NDEPTH)[0]
    model = CascadeMVSNet(BackboneConfig(eval_dtype=args.eval_dtype))
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model = model.to(device).eval()
    res = run(model, sample, device)
    print(json.dumps({"device": label, "eval_dtype": args.eval_dtype,
                      "ms": res}))
    return res


if __name__ == "__main__":
    main()
