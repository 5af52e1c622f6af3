"""K6 (K1's backward) and K7's backward, each called twice on the same
inputs at the train step's shapes: how many output elements differ between
the two calls, and by how much.

The train step's warps (`models/cascade.py`): the plane scene at 512×640
with 4 views (`data/plane_scene.py`), the golden backbone's FeatureNet
(`assets/backbone_synth.npz`), stage 1's full sweep and stages 2–3's
windows around a noisy depth, as `chip_smoke.py` phase 5 builds them, and
seeded random cotangents. K6 runs at all three stages, K7's backward at
stage 1, each in float32 and then in its bf16 instance (the same inputs
rounded to bf16; labels "bf16 ..."). One JSON line per call, then one
with all of them.

Usage:
  python -m rcmvsnet_tpu_torch.tools.repeat_warp_bwd [--device cuda]
`--device cpu` runs the plain versions.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..cli.eval_dtu import resolve_device
from ..core.geometry import compose_projection
from .timing import device_label

H, W, VIEWS, NDEPTH, SEED = 512, 640, 4, 192, 5


def train_stages(cascade, batch, scene, rand):
    """Per cascade stage, the inputs of the train step's warp: (key, feats
    [V, h, w, C], projs [V, 4, 4], lo [h, w], step [h, w], ndepth). Stage 1
    sweeps the batch's full depth range; later stages a window of ndepth ·
    ratio · interval around the scene's depth plus `rand(h, w)` · ratio ·
    interval, as a later stage sees it."""
    imgs = batch["imgs"][0]                                   # [V,H,W,3]
    Hs, Ws = imgs.shape[1:3]
    dev = imgs.device
    feats = cascade.feature(imgs.permute(0, 3, 1, 2).contiguous())
    gt = torch.from_numpy(scene["depths"][0]).to(dev)
    dv = batch["depth_values"][0]
    interval = float(dv[-1] - dv[0]) / len(dv)
    cfg = cascade.config
    for s, (nd, sc, ratio) in enumerate(zip(cfg.ndepths, (4, 2, 1),
                                            cfg.depth_intervals_ratio)):
        key = f"stage{s + 1}"
        h, w = Hs // sc, Ws // sc
        if s == 0:
            lo = torch.full((h, w), float(dv[0]), device=dev)
            step = torch.full((h, w), float(dv[-1] - dv[0]) / (nd - 1),
                              device=dev)
        else:
            cur = F.interpolate(gt[None, None], size=(h, w), mode="bilinear",
                                align_corners=False)[0, 0]
            cur = cur + rand(h, w) * ratio * interval
            lo = (cur - nd / 2.0 * ratio * interval).contiguous()
            step = ((cur + nd / 2.0 * ratio * interval - lo) / (nd - 1)) \
                .contiguous()
        f = feats[key].permute(0, 2, 3, 1).contiguous()          # [V,h,w,C]
        projs = compose_projection(batch["proj_matrices"][key][0])
        yield key, f, projs, lo, step, nd


def differ(first, second) -> dict:
    """Elements that differ between two calls' outputs, the largest |Δ|,
    and the largest |value| of the first call."""
    return {"elements": sum(a.numel() for a in first),
            "differing": sum(int((a != b).sum())
                             for a, b in zip(first, second)),
            "max_abs_delta": max(float((a - b).abs().max())
                                 for a, b in zip(first, second)),
            "max_abs": max(float(a.abs().max()) for a in first)}


def within_plain(got, want) -> bool:
    """A kernel's output against its plain version's: bf16 within one bf16
    ulp of each element + 1e-4 of the largest value, float32 within 1e-4
    of the largest value."""
    g, w = got.float(), want.float()
    m = float(w.abs().max())
    if got.dtype == torch.bfloat16:
        return bool(((g - w).abs() <= w.abs() * 2.0 ** -7 + 1e-4 * m).all())
    return float((g - w).abs().max()) <= 1e-4 * m


# the C entry (library, symbol) each bf16 backward instance needs
BF16_ENTRY = {"warp_variance_bwd": ("warp_variance_bf16",
                                     "warp_variance_bwd_bf16"),
              "warp_volume_bwd": ("warp_volume_bf16",
                                  "warp_volume_bwd_bf16")}


def train_inputs(device, gen, shape=(H, W, VIEWS), bf16=True):
    """[(label, kernel call, plain call)] of K6 at the three train stages
    and K7's backward at stage 1, on the train step's inputs (the plane
    scene, the golden FeatureNet, `train_stages`) and cotangents drawn from
    `gen`; each call returns a tuple of tensors. With bf16, the same calls
    again on the inputs rounded to bf16 (labels "bf16 <kernel> ...")."""
    from ..data.plane_scene import plane_scene
    from ..data.synthetic import batch_from_views
    from ..models.cascade import CascadeMVSNet
    from ..ops import warp_variance as K6
    from ..ops import warp_volume as K7
    from ..ops.sampling import resize_bilinear
    from ..train.step import batch_to
    from ..weights import ASSET, load_state_dict

    scene = plane_scene(*shape, SEED)
    batch = batch_to(batch_from_views([scene], NDEPTH, SEED), device)
    cascade = CascadeMVSNet()
    cascade.load_state_dict(load_state_dict(ASSET), strict=True)
    cascade = cascade.to(device).eval()
    rand = lambda *s: torch.randn(*s, generator=gen, device=device)
    calls, args = [], []
    with torch.no_grad():
        for key, f, projs, lo, step, nd in train_stages(cascade, batch,
                                                        scene, rand):
            V, h, w, C = f.shape
            tag = f"{key} V{V} {h}x{w} C{C} D{nd}"
            args.append(("warp_variance_bwd", tag,
                         (f, projs, lo, step, rand(C, nd, h, w))))
            if key == "stage1":
                im = resize_bilinear(batch["imgs"][0], h, w).contiguous()
                args.append(("warp_volume_bwd", tag,
                             (f, im, projs, lo, step, rand(C, nd, h, w),
                              rand(3 * (V - 1) + C, nd, h, w))))
    fns = {"warp_variance_bwd": (lambda *a: (K6.warp_variance_bwd(*a),),
                                 lambda *a: (K6.warp_variance_bwd_plain(*a),)),
           "warp_volume_bwd": (K7.warp_volume_bwd, K7.warp_volume_bwd_plain)}
    # the bf16 instances' operands: features, images, cotangents
    to_bf16 = {"warp_variance_bwd": (0, 4), "warp_volume_bwd": (0, 1, 5, 6)}
    for prefix in ("", "bf16 ") if bf16 else ("",):
        for name, tag, a in args:
            if prefix:
                a = tuple(t.bfloat16() if i in to_bf16[name] else t
                          for i, t in enumerate(a))
            fk, fp = fns[name]
            calls.append((f"{prefix}{name} {tag}",
                          lambda a=a, fk=fk: fk(*a),
                          lambda a=a, fp=fp: fp(*a)))
    return calls


def run(device, shape=(H, W, VIEWS)):
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    for label, fk, _ in train_inputs(device, gen, shape):
        first, second = fk(), fk()
        row = {"call": label, **differ(first, second)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    label = device_label(device)
    print(f"device: {label} | {W}x{H} V={VIEWS} D={NDEPTH}", flush=True)
    rows = run(device)
    print(json.dumps({"device": label, "repeat": rows}))
    return rows


if __name__ == "__main__":
    main()
