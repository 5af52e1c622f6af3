#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rcmvsnet_tpu_torch) on one card.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero without
the final "ok" line):
  1. device   require CUDA, print the card's name and power limit, TF32 off;
  2. build    compile the three CUDA sources (sm_90a, one nvcc each, in
              parallel) and print the build seconds;
  3. kernels  hold each hand-written kernel against its plain PyTorch
              version on the card, at the DTU eval shapes (864x1152, V=5,
              stages 216x288x32/48, 432x576x16/32, 864x1152x8/8): K1 at all
              3 stages, K2 in every mode of all 3 U-Nets (stride 1,
              stride 2, transposed, prob), K4 at 3 stages, K5 at every
              FeatureNet layer; print max errors and median ms of both;
  4. main     `infer_views` on all 5 reference views of an in-memory
              textured-plane scene at 864x1152, V=5, 192 planes, with the
              committed golden weights, once through the kernels and once
              through the plain versions; every kernel's launch count must
              be > 0 and depth must agree within the TPU path's budget
              (max relative delta 2e-3, no pixel above 0.01);
  5. report   one {"kernels": [...]} JSON line, the nvidia-smi line, and
              the final {"ok": true, "device": {...}} line.
Per-call details go to chiprun_out/chip_smoke.json.

The script imports nothing of JAX and nothing of the JAX package: the scene
is built with numpy and scipy.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W, V, NDEPTH, SEED = 864, 1152, 5, 192, 5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# plain-vs-kernel tolerances: |kernel - plain| <= atol + rtol * max|plain|.
# Sums run in another order than cuDNN's / torch's (and the warp's
# coordinates in another association), so float32 rounding differs.
TOL = {"warp_variance": (1e-4, 1e-4), "conv3d": (1e-4, 1e-4),
       "conv2d": (1e-4, 1e-4), "depth_tail": (0.0, 1e-5)}
CONF_TOL, CONF_SHARE = 1e-4, 1e-3   # per-pixel |Δconf| and allowed share
DEPTH_REL_MAX, DEPTH_GATE = 2e-3, 0.01   # the fused TPU path's budget


def plane_scene(H, W, V, seed, depth0=600.0, baseline=8.0, tilt=0.08):
    """V views of the tilted textured plane z = depth0 + tilt·x_world seen
    by cameras translated along x (the geometry of the JAX package's
    data/synthetic.make_synthetic_views, with a scipy cubic texture).
    Returns images [V, H, W, 3] in [0, 1], K, extrinsics [V, 4, 4],
    depths [V, H, W], near, far."""
    import numpy as np
    from scipy import ndimage
    rs = np.random.RandomState(seed)
    f = 1.2 * max(H, W)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float64)
    n = np.array([-tilt, 0.0, 1.0])
    n /= np.linalg.norm(n)
    d = depth0 * n[2]
    th, tw = 4 * H, 4 * W
    small = rs.rand(th // 8 + 2, tw // 8 + 2, 3)
    tex = np.stack([ndimage.zoom(small[..., c], (th / small.shape[0],
                                                 tw / small.shape[1]),
                                 order=3) for c in range(3)], -1)
    tex = tex[:th, :tw].clip(0, 1).astype(np.float32)

    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    images, extr, depths = [], [], []
    for v in range(V):
        E = np.eye(4)
        E[0, 3] = -v * baseline
        c = np.array([v * baseline, 0.0, 0.0])
        t = (d - c @ n) / (rays @ n)
        pts = c + t[..., None] * rays
        u = (pts[..., 0] / depth0 * f * 0.25 + 2 * W).clip(0, tw - 1)
        w_ = (pts[..., 1] / depth0 * f * 0.25 + 2 * H).clip(0, th - 1)
        x0 = np.floor(u).astype(int)
        y0 = np.floor(w_).astype(int)
        x1 = np.minimum(x0 + 1, tw - 1)
        y1 = np.minimum(y0 + 1, th - 1)
        ax = (u - x0)[..., None]
        ay = (w_ - y0)[..., None]
        img = (tex[y0, x0] * (1 - ax) * (1 - ay) + tex[y0, x1] * ax * (1 - ay)
               + tex[y1, x0] * (1 - ax) * ay + tex[y1, x1] * ax * ay)
        images.append(img.astype(np.float32))
        extr.append(E.astype(np.float32))
        depths.append(pts[..., 2].astype(np.float32))   # world z = cam z
    return {"images": np.stack(images), "K": K.astype(np.float32),
            "extrinsics": np.stack(extr), "depths": np.stack(depths),
            "near": depth0 * 0.8, "far": depth0 * 1.25}


def dtu_samples(scene, ndepth, interval_scale=1.06):
    """One eval sample per reference view, as the DTU test loader builds
    them (ref view first, stage-1 intrinsics at 1/4, stage 2/3 at 1/2, 1;
    depth_values from the cam file's min and interval)."""
    import numpy as np
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    nv = len(scene["images"])
    interval = (scene["far"] - scene["near"]) / ndepth * interval_scale
    dvals = np.arange(scene["near"], interval * (ndepth - 0.5) + scene["near"],
                      interval, dtype=np.float32)
    samples = []
    for ref in range(nv):
        views = [ref] + [v for v in range(nv) if v != ref]
        proj = np.zeros((nv, 2, 4, 4), np.float32)
        for i, v in enumerate(views):
            proj[i, 0] = scene["extrinsics"][v]
            proj[i, 1, :3, :3] = scene["K"]
            proj[i, 1, :2] /= 4.0
        pm = {"stage1": proj, "stage2": proj.copy(), "stage3": proj.copy()}
        pm["stage2"][:, 1, :2] *= 2
        pm["stage3"][:, 1, :2] *= 4
        samples.append({
            "imgs": ((scene["images"][views] - mean) / std).astype(np.float32),
            "proj_matrices": pm, "depth_values": dvals})
    return samples


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, warmup=2, reps=7):
    """Median ms of fn() on the card (CUDA events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Ledger:
    """Per-kernel comparison records: max error, summed per-view ms."""

    def __init__(self, timer=time_ms):
        self.rows = []
        self.failures = []
        self.timer = timer

    def compare(self, kernel, label, fn_k, fn_p):
        import torch
        out_k, out_p = fn_k(), fn_p()
        sync(out_p[0].device if isinstance(out_p, tuple) else out_p.device)
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        a, p = outs_k[0].float(), outs_p[0].float()
        if a.shape != p.shape or not bool(torch.isfinite(a).all()):
            self.failures.append(f"{kernel} {label}: shape {tuple(a.shape)} "
                                 f"vs {tuple(p.shape)} or non-finite")
            err = float("inf")
        else:
            err = float((a - p).abs().max())
        scale = float(p.abs().max())
        atol, rtol = TOL[kernel]
        # depth is positive everywhere, so its error is relative per pixel;
        # conv and variance outputs cross zero (ReLU), so theirs is relative
        # to the largest plain value
        rel = (float(((a - p).abs() / p.abs().clamp_min(1e-12)).max())
               if kernel == "depth_tail" else err / max(scale, 1e-12))
        row = {"kernel": kernel, "label": label, "shape": list(p.shape),
               "max_abs_err": err, "max_rel_err": rel,
               "tol": atol + rtol * scale}
        if kernel == "depth_tail":
            flips = float(((outs_k[1] - outs_p[1]).abs() > CONF_TOL)
                          .float().mean())
            row["conf_share_above_tol"] = flips
            if flips > CONF_SHARE:
                self.failures.append(f"{kernel} {label}: confidence differs "
                                     f"on {flips:.2e} of pixels")
        if not err <= atol + rtol * scale:
            self.failures.append(f"{kernel} {label}: max|Δ| {err:.3e} > "
                                 f"{atol + rtol * scale:.3e}")
        row["ms"] = self.timer(fn_k)
        row["plain_ms"] = self.timer(fn_p)
        self.rows.append(row)
        print(json.dumps(row), flush=True)
        return out_p

    def summary(self, kernel):
        rows = [r for r in self.rows if r["kernel"] == kernel]
        return {"max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "calls": len(rows)}


def phase_kernels(model, samples, scene, ledger, dev):
    """Phase 3: each kernel against its plain version at the main path's
    shapes, on realistic inputs (the plain path's own intermediates)."""
    import torch
    import torch.nn.functional as F
    from rcmvsnet_tpu_torch.core.geometry import compose_projection
    from rcmvsnet_tpu_torch.nn.layers import bn_scale_shift, fold_block
    from rcmvsnet_tpu_torch.ops import conv2d as K5
    from rcmvsnet_tpu_torch.ops import conv3d as K2
    from rcmvsnet_tpu_torch.ops import depth_tail as K4
    from rcmvsnet_tpu_torch.ops import warp_variance as K1

    s0 = samples[0]
    x = torch.from_numpy(s0["imgs"]).to(dev).permute(0, 3, 1, 2).contiguous()

    # K5: every FeatureNet layer, 5 views at 864x1152
    fn = model.feature
    acts = []
    for si, seq in enumerate((fn.conv0, fn.conv1, fn.conv2)):
        for li, blk in enumerate(seq):
            sc, sh = bn_scale_shift(blk.bn)
            args = (blk.conv.weight, sc, sh)
            kw = dict(stride=blk.conv.stride[0], padding=blk.conv.padding[0],
                      relu=True)
            x = ledger.compare(
                "conv2d", f"conv{si}.{li} {tuple(x.shape)}",
                lambda x=x: K5.conv2d(x, *args, **kw),
                lambda x=x: K5.conv2d_plain(x, *args, **kw))
        acts.append(x)
    conv0, conv1, intra = acts
    feats = {}
    feats["stage1"] = ledger.compare(
        "conv2d", "out1", lambda: K5.conv2d(intra, fn.out1.weight),
        lambda: K5.conv2d_plain(intra, fn.out1.weight))
    intra = ledger.compare(
        "conv2d", "inner1+up",
        lambda: K5.conv2d(conv1, fn.inner1.weight, shift=fn.inner1.bias,
                          up=intra),
        lambda: K5.conv2d_plain(conv1, fn.inner1.weight,
                                shift=fn.inner1.bias, up=intra))
    feats["stage2"] = ledger.compare(
        "conv2d", "out2", lambda: K5.conv2d(intra, fn.out2.weight, padding=1),
        lambda: K5.conv2d_plain(intra, fn.out2.weight, padding=1))
    intra = ledger.compare(
        "conv2d", "inner2+up",
        lambda: K5.conv2d(conv0, fn.inner2.weight, shift=fn.inner2.bias,
                          up=intra),
        lambda: K5.conv2d_plain(conv0, fn.inner2.weight,
                                shift=fn.inner2.bias, up=intra))
    feats["stage3"] = ledger.compare(
        "conv2d", "out3", lambda: K5.conv2d(intra, fn.out3.weight, padding=1),
        lambda: K5.conv2d_plain(intra, fn.out3.weight, padding=1))
    del acts, conv0, conv1, intra, x

    gt = torch.from_numpy(scene["depths"][0]).to(dev)
    dv = s0["depth_values"]
    interval = float(dv[-1] - dv[0]) / len(dv)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Hs, Ws = s0["imgs"].shape[1:3]
    cfg = model.config
    for s, (nd, sc, ratio) in enumerate(zip(cfg.ndepths, (4, 2, 1),
                                            cfg.depth_intervals_ratio)):
        key = f"stage{s + 1}"
        h, w = Hs // sc, Ws // sc
        if s == 0:
            lo = torch.full((h, w), float(dv[0]), device=dev)
            step = torch.full((h, w), float(dv[-1] - dv[0]) / (nd - 1),
                              device=dev)
        else:
            # a window around a noisy depth, as a later stage sees it
            cur = F.interpolate(gt[None, None], size=(h, w), mode="bilinear",
                                align_corners=False)[0, 0]
            cur = cur + torch.randn(cur.shape, generator=gen, device=dev) \
                * ratio * interval
            lo = (cur - nd / 2.0 * ratio * interval).contiguous()
            step = ((cur + nd / 2.0 * ratio * interval - lo) / (nd - 1)) \
                .contiguous()
        f = feats[key].permute(0, 2, 3, 1).contiguous()          # [V,h,w,C]
        projs = compose_projection(
            torch.from_numpy(s0["proj_matrices"][key]).to(dev))
        var = ledger.compare(
            "warp_variance",
            f"{key} V{f.shape[0]} {h}x{w} C{f.shape[-1]} D{nd}",
            lambda: K1.warp_variance(f, projs, lo, step, nd),
            lambda: K1.warp_variance_plain(f, projs, lo, step, nd))

        cr = model.cost_regularization[s]
        t = var[None]
        saved = {}
        for name, mode, skip in (
                ("conv0", "s1", None), ("conv1", "s2", None),
                ("conv2", "s1", None), ("conv3", "s2", None),
                ("conv4", "s1", None), ("conv5", "s2", None),
                ("conv6", "s1", None), ("conv7", "t2", "conv4"),
                ("conv9", "t2", "conv2"), ("conv11", "t2", "conv0")):
            wgt, b = fold_block(getattr(cr, name))
            sk = saved.get(skip)
            t = ledger.compare(
                "conv3d", f"{key} {name} {mode} {tuple(t.shape)}",
                lambda t=t, wgt=wgt, b=b, mode=mode, sk=sk: K2.conv3d(
                    t, wgt, b, mode, skip=sk),
                lambda t=t, wgt=wgt, b=b, mode=mode, sk=sk: K2.conv3d_plain(
                    t, wgt, b, mode, skip=sk))
            saved[name] = t
        zero = torch.zeros(1, device=dev)
        cost = ledger.compare(
            "conv3d", f"{key} prob s1 {tuple(t.shape)}",
            lambda: K2.conv3d(t, cr.prob.weight, zero, "s1", relu=False),
            lambda: K2.conv3d_plain(t, cr.prob.weight, zero, "s1",
                                    relu=False))
        del saved, t, var
        c = cost[0, 0].contiguous()
        ledger.compare("depth_tail", f"{key} D{nd} {h}x{w}",
                       lambda: K4.depth_tail(c, lo, step),
                       lambda: K4.depth_tail_plain(c, lo, step))
    sync(dev)
    if ledger.failures:
        raise AssertionError("kernel vs plain:\n  "
                             + "\n  ".join(ledger.failures))


def phase_main(model, samples, scene, dev):
    """Phase 4: the main path, kernels then plain versions, 5 views."""
    import numpy as np
    import torch
    from rcmvsnet_tpu_torch.models.cascade import infer_views
    from rcmvsnet_tpu_torch.ops import conv2d, conv3d, depth_tail
    from rcmvsnet_tpu_torch.ops import warp_variance
    wrappers = {"warp_variance": warp_variance.warp_variance,
                "conv3d": conv3d.conv3d, "depth_tail": depth_tail.depth_tail,
                "conv2d": conv2d.conv2d}
    for fn in wrappers.values():
        fn.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    got = infer_views(model, samples, dev)
    sync(dev)
    t_kernel = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    t0 = time.perf_counter()
    ref = infer_views(model, samples, dev, plain=True)
    sync(dev)
    t_plain = time.perf_counter() - t0

    rel_max, n_gate, plane_err = 0.0, 0, []
    hw = samples[0]["imgs"].shape[1:3]
    for i, ((dk, ck), (dp, cp)) in enumerate(zip(got, ref)):
        if dk.shape != hw or not np.isfinite(dk).all() \
                or not np.isfinite(ck).all():
            raise AssertionError(f"view {i}: depth {dk.shape} not finite "
                                 f"{hw}")
        rel = np.abs(dk - dp) / np.abs(dp)
        rel_max = max(rel_max, float(rel.max()))
        n_gate += int((rel > DEPTH_GATE).sum())
        plane_err.append(float(np.median(np.abs(dk - scene["depths"][i]))))
    result = {
        "views": len(samples), "launches": launches,
        "depth_maps_per_s_kernel": len(samples) / t_kernel,
        "depth_maps_per_s_plain": len(samples) / t_plain,
        "depth_max_rel_delta_vs_plain": rel_max,
        "depth_pixels_above_gate": n_gate,
        "median_abs_depth_err_vs_plane": plane_err,
    }
    print(json.dumps({"main_path": result}), flush=True)
    if rel_max > DEPTH_REL_MAX or n_gate:
        raise AssertionError(f"kernel vs plain depth: max rel {rel_max:.3e} "
                             f"(limit {DEPTH_REL_MAX}), {n_gate} pixels "
                             f"above {DEPTH_GATE}")
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from rcmvsnet_tpu_torch.core.geometry import set_full_precision
    from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
    from rcmvsnet_tpu_torch.ops import _build
    from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    set_full_precision()

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(logs)} CUDA sources in {build_s:.1f} s", flush=True)

    # 3. kernels against their plain versions
    scene = plane_scene(H, W, V, SEED)
    samples = dtu_samples(scene, NDEPTH)
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model = model.cuda().eval()
    ledger = Ledger()
    dev = torch.device("cuda")
    with torch.no_grad():
        phase_kernels(model, samples, scene, ledger, dev)
    torch.cuda.empty_cache()

    # 4. main path
    main_path = phase_main(model, samples, scene, dev)

    # 5. report
    source = "rcmvsnet_tpu_torch/ops/"
    meta = [
        ("warp_variance", "cuda", source + "csrc/warp_variance.cu",
         "rcmvsnet_tpu/ops/pallas_warp2.py:393"),
        ("conv3d", "cuda", source + "csrc/conv3d.cu",
         "rcmvsnet_tpu/ops/pallas_costreg.py:383 + "
         "rcmvsnet_tpu/ops/pallas_resample.py:59,117"),
        ("depth_tail", "triton", source + "depth_tail.py",
         "rcmvsnet_tpu/ops/pallas_tail.py:133"),
        ("conv2d", "cuda", source + "csrc/conv2d.cu",
         "rcmvsnet_tpu/ops/pallas_conv2d.py:306"),
    ]
    kernels = []
    for name, route, src, replaces in meta:
        s = ledger.summary(name)
        kernels.append({"name": name, "route": route, "source": src,
                        "replaces": replaces,
                        "launches": main_path["launches"][name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "build_s": build_s, "nvcc": logs,
        "calls": ledger.rows, "main_path": main_path, "kernels": kernels},
        indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
