#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rcmvsnet_tpu_torch) on one card.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero without
the final "ok" line):
  1. device   require CUDA, print the card's name and power limit, TF32 off;
  2. build    compile the seven CUDA sources (sm_90a, one nvcc each, in
              parallel) and print the build seconds; count the TF32
              tensor-core MMAs (HMMA ... TF32) that `cuobjdump -sass` finds
              in each tensor-core kernel of K2/K9, K8 dw and K5, which
              must be > 0;
  3. kernels  hold each eval kernel against its plain PyTorch version on
              the card, at the DTU eval shapes (864x1152, V=5, stages
              216x288x32/48, 432x576x16/32, 864x1152x8/8): K1 at all 3
              stages, K2 in every mode of all 3 U-Nets (stride 1, stride 2,
              transposed, prob), K4 at 3 stages, K5 at every call of the
              eval FeatureNet (the 8 trunk convs, out1 and out2 writing
              the warp layout, inner1+up, and stage 3's lateral head
              against its plain composition, inner2+up then out3), each
              row with its route; K4's rows split its time: the kernel's
              own device ms (torch.profiler) and the host ms of one
              wrapper call beside the event ms; then K4 past 64 planes
              (its streaming instance: D 96 and 192 at stage 1's 216x288
              and a 864x1152 slab), rows of phase "wide"; print max
              errors and median ms of both,
              the library call's ms where one PyTorch call computes the
              same function (K5 also sums its calls with the lateral
              head's two unfused cuDNN calls: library_unfused_ms), and
              the card's least time for the work (bound);
  4. eval     `infer_views` on all 5 reference views of an in-memory
              textured-plane scene at 864x1152, V=5, 192 planes, with the
              committed golden weights, once through the kernels and once
              through the plain versions; every eval kernel's launch count
              must be > 0 and depth must agree within the TPU path's budget
              (max relative delta 2e-3, no pixel above 0.01);
  5. train kernels  the same for the train kernels at the train shapes
              (512x640, V=4; stages 128x160x32/48, 256x320x16/32,
              512x640x8/8; neural volume 41 -> 8 channels at
              128x128x160): K1 and K6 (its backward) at all 3 stages, K7
              forward (var and the render volume) and backward at stage
              1, and K8 for every conv of the 3 CostRegNets and the
              render U-Net: forward and dx through K2,
              dw through its own kernel, each from a fixed random cotangent,
              and K8 dw at 128 output channels (two Co groups; s1 and s2
              at --cr_base_chs 16's stage-1 conv5/conv6 shapes, rows of
              phase "wide");
              K6 and K7's backward are called a second time and must repeat
              bit for bit (their rows give the elements that differ, the
              merge factor and the integer adds of the fixed-point scatter);
  6. train    the fused train step (clean + aug + render passes, one
              backward, one Adam step) at 512x640, V=4, 192 planes, 1024
              rays x 128 samples, 128 planes, from one init (the golden
              backbone, a seeded render branch) and one batch of the plane
              scene, with the random draws fixed once: 2 warm-up and 5
              timed steps through the kernels, then the same through the
              plain versions; every train kernel's launch count must be
              > 0, step-1 losses must agree to relative 1e-4 and every
              parameter gradient tensor to 3e-2 in relative L2 norm (see
              LOSS_RTOL, GRAD_L2_TOL); prints steps/s and peak memory of
              both paths;
  7. tanks    `infer_views` on all 7 reference views of the plane scene
              at Tanks & Temples' 1056x1920, V=7, 192 planes, with the
              T&T loader's depth range (min to max in 191 intervals),
              through the kernels and the plain versions: every eval
              kernel launched, none on the plain path, the same depth
              gate as phase 4; prints maps/s, launches per map and peak
              memory of both paths;
  8. tools    the profiling entry points at their own shapes
              (tools/profile_breakdown: 864x1152, V=5, 192 planes, every
              eval component; tools/profile_conv3d: K9 at its eight
              CostRegNet cases), printing their lines; K9 and K10 must
              launch. Then K10 per view and stage against its plain
              version, the K10 route's variance against K1's, and K9 at
              the eight cases and at odd sizes (5x9x7, each mode) against
              F.conv3d / F.conv_transpose3d;
  9. train CLI  `cli.train.fit`, the train CLI's loop, on in-memory
              plane-scene datasets (`data/plane_scene.plane_items`; the
              card's host cannot decode the DTU loaders' PNGs): 3 train
              items at 512x640, V=4, 192 planes, 48/32/8, render v0 at
              full size, 2 val items at V=5 with depth and mask, the golden
              backbone and a seeded render branch; 2 epochs, validating
              and saving each, then --resume for a third. Every train
              (K1, K2, K6, K7, K8) and eval (K1, K2, K4, K5) kernel must
              launch; every logged loss is finite; each epoch's
              `*_cas.ckpt` / `*_nerf.ckpt` hold the reference's keys; the
              saved pair restores into a fresh state tensor for tensor
              (`torch.equal`, models and optimizer) at epoch 2 and the
              saved step; the val step's depth and `infer_views` depth from
              the last `*_cas.ckpt` (one DTU-shape view) pass phase 4's
              gate against the plain path; render v1 and v2 each take one
              step with finite losses, K7 and K8 launched. Prints steps/s
              (host loading included), val batches/s, save and restore
              seconds and peak memory;
 10. wide     the configurations the repaired kernels serve, end to
              end: `infer_views` at --ndepths 96,32,8 over phase 4's views
              (kernels vs plain, phase 4's gate, every eval kernel
              launched) and one train step at --cr_base_chs 16,16,16
              from a seeded init (finite losses, every train kernel
              launched);
 11. parallel data parallelism (`parallel/`): (a) a one-rank NCCL group,
              one step through the data-parallel step on phase 6's
              inputs: phase 6's kernel step-1 metrics in every bit, and
              its gradients unchanged by an all-reduce over the group;
              (b) two ranks on this one card over Gloo (NCCL puts no two
              ranks on one card), B=1 each, against the single-process
              kernel step at B=2 on the same global batch and draws, its
              BatchNorms the cross-rank layer's at one rank, and with
              PyTorch's own (its render terms printed, not gated: see
              `phase_parallel`; cudnn.deterministic in both): step-1
              losses within
              LOSS_RTOL, every gradient within GRAD_L2_TOL, both ranks'
              parameters and buffers after Adam equal in every bit, K1,
              K2, K6, K7 and K8 launched in each rank; steps/s of the two
              ranks sharing the card (not a scaling figure); (c) two ranks
              run `infer_views_sharded` over phase 4's views: the gathered
              depth and confidence equal phase 4's in every bit, or else
              pass its gate (the result names which held);
 12. report   one {"kernels": [...]} JSON line (ten kernels), the
              nvidia-smi line, and the final {"ok": true, "device": {...}}
              line.
Bounds use the published H100 SXM peaks: 3.35 TB/s of HBM and 67 TFLOP/s
of float32 outside the tensor cores (TF32 is off in PyTorch on this path);
the convs (K2, K5, K8 dw, K9), which run 3xTF32 on the tensor cores (K5
on its "tc" route), also get `bound_tc_ms`: bytes over HBM against 3 TF32
products per multiply-add over 495 TFLOP/s. Per-call
details go to chip_smoke.json in the output directory `main` names; every
printed result carries the card's name and power limit.

The script imports nothing of JAX and nothing of the JAX package: the scene
(`rcmvsnet_tpu_torch/data/plane_scene.py`) is built with numpy and scipy.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from rcmvsnet_tpu_torch.data.plane_scene import (  # noqa: E402
    dtu_samples, plane_scene, tanks_samples)
from rcmvsnet_tpu_torch.tools.timing import (  # noqa: E402
    device_ms, host_ms, make_timer)

H, W, V, NDEPTH, SEED = 864, 1152, 5, 192, 5
TH, TW, TV = 512, 640, 4                    # the train step's input
TT_H, TT_W, TT_V = 1056, 1920, 7            # Tanks & Temples' eval input
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12                     # f32, outside the tensor cores
TF32_FLOPS_PER_S = 495e12                   # TF32 tensor cores, dense
# the kernels that run 3xTF32 MMAs: three TF32 products per multiply-add
TC_KERNELS = ("conv3d", "conv3d_dw", "conv3d_lanewise", "conv2d")
# plain-vs-kernel tolerances: |kernel - plain| <= atol + rtol * max|plain|.
# Sums run in another order than cuDNN's / torch's (and the warp's
# coordinates in another association), so float32 rounding differs.
# The backward kernels sum in 64-bit fixed point, rounded once per flushed
# run of planes (K6, K7), or in per-block partials (K8 dw), in another order
# than autograd's scatter or the plain einsum; each repeats bit for bit.
TOL = {"warp_variance": (1e-4, 1e-4), "conv3d": (1e-4, 1e-4),
       "conv2d": (1e-4, 1e-4), "depth_tail": (0.0, 1e-5),
       "warp_variance_bwd": (1e-4, 1e-4), "warp_volume": (1e-4, 1e-4),
       "warp_volume_bwd": (1e-4, 1e-4), "conv3d_dw": (1e-4, 1e-4),
       "conv3d_lanewise": (0.0, 1e-4), "warp_view": (0.0, 1e-5),
       "warp_view_route": (0.0, 1e-5)}
# K9 is held to 1e-4 of its largest value (cuDNN sums in another order);
# K10 to 1e-5: its plain version samples the same coordinates in float64,
# and the K10 route's variance ("warp_view_route") computes K1's function
# with K1's coordinates and K1's order of operations.
# Train step 1, kernel path vs plain path (chip_train_probe.py measures
# both gates' noise and power). The plain path's step 1 runs under
# cudnn.deterministic: without it cuDNN's float32 conv_transpose3d (a
# dgrad algorithm) differs from run to run, and the render losses, which
# encode sample depths drawn around the pseudo-depth at frequencies up to
# 2^9, amplify that to 1.8e-4 of the step-1 loss. Under the flag both
# paths repeat bit for bit (every kernel backward, K6 and K7 included, is
# deterministic).
# Losses, relative, each term: measured ≤ 7.9e-5 (the render terms).
LOSS_RTOL = 1e-4
# Gradients, per parameter tensor, ‖kernel − plain‖₂ / ‖plain‖₂: measured
# ≤ 1.8e-2 (feature.conv0.0's weight: the same amplification); K6's or
# K7's backward or K8's dw scaled by 1.1 reads ≥ 0.10. A 1 % fault hides
# in that noise end to end; phase 5 holds each backward to 1e-4.
GRAD_L2_TOL = 3e-2
CONF_TOL, CONF_SHARE = 1e-4, 1e-3   # per-pixel |Δconf| and allowed share
DEPTH_REL_MAX, DEPTH_GATE = 2e-3, 0.01   # the fused TPU path's budget
# kernels whose rows also carry the kernel's own device ms (torch.profiler)
# and the host ms of one wrapper call: most of K4's event time is the
# host's launch latency, not its few µs of device work
SPLIT_KERNELS = ("depth_tail",)


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def split_times(fn, dev) -> dict:
    """The kernel's own device ms (torch.profiler; None where it records
    no device activity), the kernels it saw, and the host ms of one
    call."""
    ms, names = device_ms(fn, dev)
    return {"device_ms": ms, "device_kernels": names,
            "host_ms": host_ms(fn, dev)}


def bound_ms(n_bytes: float, flops: float, rate: float = F32_FLOPS_PER_S):
    """(least ms the card could take, "bytes" or "operations")."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / rate * 1e3
    return max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def bound_tc_ms(n_bytes: float, flops: float):
    """bound_ms of a 3xTF32 kernel: 3 TF32 products per multiply-add."""
    return bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S)


def sass_mma_counts() -> dict:
    """{library: {"kernels": {kernel: TF32 HMMA count}, "example": one
    such instruction}} of the conv libraries (K2/K9, K8 dw, K5), from
    `cuobjdump -sass` of the built files (the CUDA toolkit's)."""
    import re
    from rcmvsnet_tpu_torch.ops import _build
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    out = {}
    for lib in ("conv3d", "conv3d_dw", "conv2d"):
        sass = subprocess.run([tool, "-sass", str(_build._target(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, name, example = {}, None, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                counts[name] = 0
            elif name and re.search(r"HMMA\.\S*TF32", line):
                counts[name] += 1
                example = example or " ".join(line.split())
        out[lib] = {"kernels": counts, "example": example}
    return out


class Ledger:
    """Per-kernel comparison records: max error, ms of the kernel, of its
    plain version and of the library call, and the bound."""

    def __init__(self, timer, split=None):
        self.rows = []
        self.failures = []
        self.timer = timer
        self.split = split      # fn -> {device_ms, ...} for SPLIT_KERNELS
        self.phase = "eval"

    def compare(self, kernel, label, fn_k, fn_p, n_bytes=0, flops=0,
                fn_lib=None, repeat=False, extra=None):
        """Kernel vs plain on the same inputs; `repeat`: the kernel a
        second time, which must agree in every bit; `extra`: more keys for
        the row."""
        import torch
        from rcmvsnet_tpu_torch.tools.repeat_warp_bwd import differ
        out_k, out_p = fn_k(), fn_p()
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        sync(outs_p[0].device)
        # depth_tail: depth first, its confidence is checked by share below
        pairs = list(zip(outs_k, outs_p))
        if kernel == "depth_tail":
            pairs = pairs[:1]
        err, scale, rel = 0.0, 0.0, 0.0
        for a, p in pairs:
            a, p = a.float(), p.float()
            if a.shape != p.shape or not bool(torch.isfinite(a).all()):
                self.failures.append(
                    f"{kernel} {label}: shape {tuple(a.shape)} vs "
                    f"{tuple(p.shape)} or non-finite")
                err = float("inf")
                continue
            e = float((a - p).abs().max())
            m = float(p.abs().max())
            err, scale = max(err, e), max(scale, m)
            # depth is positive everywhere, so its error is relative per
            # pixel; conv, variance and gradient outputs cross zero, so
            # theirs is relative to the largest plain value
            rel = max(rel, float(((a - p).abs() / p.abs().clamp_min(1e-12))
                                 .max()) if kernel == "depth_tail"
                      else e / max(m, 1e-12))
        atol, rtol = TOL[kernel]
        b_ms, b_by = bound_ms(n_bytes, flops)
        row = {"kernel": kernel, "phase": self.phase, "label": label,
               "shape": list(outs_p[0].shape), "max_abs_err": err,
               "max_rel_err": rel, "tol": atol + rtol * scale,
               "bytes": n_bytes, "flops": flops, "bound_ms": b_ms,
               "bound_by": b_by}
        if kernel in TC_KERNELS:
            row["bound_tc_ms"], row["bound_tc_by"] = bound_tc_ms(n_bytes,
                                                                 flops)
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
        if repeat:
            again = fn_k()
            row["repeat"] = differ(outs_k, again if isinstance(again, tuple)
                                   else (again,))
            if row["repeat"]["differing"]:
                self.failures.append(f"{kernel} {label}: a second call "
                                     f"differs {row['repeat']}")
        row.update(extra or {})
        row["ms"] = self.timer(fn_k)
        if self.split and kernel in SPLIT_KERNELS:
            row.update(self.split(fn_k))
        row["plain_ms"] = self.timer(fn_p)
        row["library_ms"] = self.timer(fn_lib) if fn_lib else None
        self.rows.append(row)
        print(json.dumps(row), flush=True)
        return out_p

    def summary(self, kernel, phase=None):
        rows = [r for r in self.rows if r["kernel"] == kernel
                and (phase is None or r["phase"] == phase)]
        libs = [r["library_ms"] for r in rows]
        t_b = sum(bound_ms(r["bytes"], 0)[0] for r in rows)
        t_f = sum(bound_ms(0, r["flops"])[0] for r in rows)
        out = {"max_abs_err": max(r["max_abs_err"] for r in rows),
               "ms": sum(r["ms"] for r in rows),
               "plain_ms": sum(r["plain_ms"] for r in rows),
               "library_ms": (None if any(v is None for v in libs)
                              else sum(libs)),
               "bound_ms": sum(r["bound_ms"] for r in rows),
               "bound_by": "bytes" if t_b >= t_f else "operations",
               "calls": len(rows)}
        if any("library_unfused_ms" in r for r in rows):
            # the rows' library calls with a fused row's unfused ones
            unf = [r.get("library_unfused_ms", r["library_ms"]) for r in rows]
            out["library_unfused_ms"] = (None if any(v is None for v in unf)
                                         else sum(unf))
        if any("device_ms" in r for r in rows):
            dev = [r["device_ms"] for r in rows]
            out["device_ms"] = None if None in dev else sum(dev)
            out["host_ms"] = sum(r["host_ms"] for r in rows)
        if any("repeat" in r for r in rows):
            out["repeats_bit_for_bit"] = all(
                r["repeat"]["differing"] == 0 for r in rows if "repeat" in r)
        if kernel in TC_KERNELS:
            t_f = sum(bound_tc_ms(0, r["flops"])[0] for r in rows)
            out["bound_tc_ms"] = sum(r["bound_tc_ms"] for r in rows)
            out["bound_tc_by"] = "bytes" if t_b >= t_f else "operations"
        return out

    def check(self, what):
        if self.failures:
            raise AssertionError(f"{what}, kernel vs plain:\n  "
                                 + "\n  ".join(self.failures))


# Work of each kernel call, from its shapes: (bytes, flops). Each input is
# read once and each output written once (float32); flops count a fused
# multiply-add as 2 and only the taps that land (the transposed conv's
# gather reaches 1 tap in 8 of the stuffed input).
def conv3d_work(x, w, out, mode, extra=()):
    N, Ci = x.shape[:2]
    Co = out.shape[1]
    pos = x[0, 0].numel() if mode == "t2" else out[0, 0].numel()
    return (nbytes(x, w, out, *extra), 2 * N * Co * Ci * 27 * pos)


def warp_flops(V, h, w, C, D, bwd=False, images=0):
    """K1 / K6 / K7 per (plane, pixel) and source view: the projection
    (~30), 4 taps x C FMAs and the Σx, Σx² update (3C); a backward samples
    twice and scatters 4 taps x C FMAs more; `images` channels ride the
    same taps."""
    per_view = 30 + 8 * (C + images) + 3 * C
    if bwd:
        per_view += 8 * C + 8 * (C + images) + 3 * C
    return D * h * w * ((V - 1) * per_view + 5 * C)


def tap_runs(projs, lo, step, nd, channels):
    """The flushes of K6 / K7's fixed-point scatter, counted from the
    kernels' own coordinates (`ops/warp_view.pixel_coords` spells out
    `warp::project` operation by operation): per source view and
    reference pixel, each run of consecutive planes with one top-left tap
    is flushed once, one integer add per in-image tap and channel."""
    import torch
    from rcmvsnet_tpu_torch.ops.warp_variance import relative_projections
    from rcmvsnet_tpu_torch.ops.warp_view import pixel_coords
    h, w = lo.shape
    rel = relative_projections(projs).reshape(-1, 4, 4)[1:]
    d = torch.arange(nd, dtype=torch.float32, device=lo.device)
    dv = lo[None] + d[:, None, None] * step[None]            # [D, h, w]
    px, py = pixel_coords(rel, dv[None], h, w)               # [V-1, D, h, w]
    x0, y0 = px.floor(), py.floor()
    new = torch.ones_like(px, dtype=torch.bool)
    new[:, 1:] = (x0[:, 1:] != x0[:, :-1]) | (y0[:, 1:] != y0[:, :-1])
    taps = sum(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0)
                & (y0 + dy < h)).int() for dx in (0, 1) for dy in (0, 1))
    runs = int(new.sum())
    return {"samples": px.numel(), "flushes": runs,
            "merge_factor": px.numel() / runs,
            "int_adds": int(taps[new].sum()) * channels}


def conv2d_work(x, w, out, *extra):
    N, Ci = x.shape[:2]
    Co, _, k, _ = w.shape
    pos = out[0].numel() // Co          # output positions, either layout
    return nbytes(x, w, out, *extra), 2 * N * Co * Ci * k * k * pos


def lateral_work(up, lat, wi, bi, w):
    """K5's lateral head: reads up, lat and the weights once, writes the
    [N, H, W, Co] output; the 1x1 lateral conv and out3's 3x3 conv."""
    N, Cl, H, W = lat.shape
    Co, Cu = w.shape[:2]
    out_bytes = 4 * N * H * W * Co
    return (nbytes(up, lat, wi, bi, w) + out_bytes,
            2 * N * H * W * (Cu * Cl + Co * Cu * 9))


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

    # K5: every call of the eval FeatureNet, 5 views at 864x1152
    fn = model.feature

    def k5(label, x, wgt, extra, fn_lib, **kw):
        y = K5.conv2d_plain(x, wgt, **kw)
        way = K5.route(wgt.shape[-1], kw.get("stride", 1),
                       kw.get("padding", 0), x.shape[1])
        return ledger.compare(
            "conv2d", f"{label} {tuple(x.shape)}",
            lambda: K5.conv2d(x, wgt, **kw),
            lambda: K5.conv2d_plain(x, wgt, **kw),
            *conv2d_work(x, wgt, y, *extra), fn_lib=fn_lib,
            extra={"route": way})

    acts = []
    for si, seq in enumerate((fn.conv0, fn.conv1, fn.conv2)):
        for li, blk in enumerate(seq):
            sc, sh = bn_scale_shift(blk.bn)
            kw = dict(scale=sc, shift=sh, stride=blk.conv.stride[0],
                      padding=blk.conv.padding[0], relu=True)
            x = k5(f"conv{si}.{li}", x, blk.conv.weight, (sc, sh),
                   lambda x=x, kw=kw, w=blk.conv.weight: F.conv2d(
                       x, w, stride=kw["stride"], padding=kw["padding"]),
                   **kw)
        acts.append(x)
    conv0, conv1, intra = acts
    feats = {"stage1": k5("out1 warp", intra, fn.out1.weight, (),
                          lambda: F.conv2d(intra, fn.out1.weight),
                          out_layout="warp")}
    intra = k5("inner1+up", conv1, fn.inner1.weight, (fn.inner1.bias, intra),
               lambda: F.conv2d(conv1, fn.inner1.weight, fn.inner1.bias),
               shift=fn.inner1.bias, up=intra)
    feats["stage2"] = k5("out2 warp", intra, fn.out2.weight, (),
                         lambda: F.conv2d(intra, fn.out2.weight, padding=1),
                         padding=1, out_layout="warp")
    # stage 3's lateral head against its plain composition; no one PyTorch
    # call fuses the two convs: the row's "library_unfused_ms" times the
    # two cuDNN calls of the unfused head (inner2 1x1 with bias, then out3
    # on the sum as the plain path writes it)
    lat = (intra, conv0, fn.inner2.weight, fn.inner2.bias, fn.out3.weight)
    s3 = K5.conv2d_plain(conv0, fn.inner2.weight, shift=fn.inner2.bias,
                         up=intra)
    feats["stage3"] = ledger.compare(
        "conv2d", f"out3 lateral warp {tuple(conv0.shape)} up "
        f"{tuple(intra.shape)}",
        lambda: K5.lateral_conv2d(*lat, out_layout="warp"),
        lambda: K5.lateral_conv2d_plain(*lat, out_layout="warp"),
        *lateral_work(*lat),
        extra={"route": "lateral", "library_unfused_ms": ledger.timer(
            lambda: (F.conv2d(conv0, fn.inner2.weight, fn.inner2.bias),
                     F.conv2d(s3, fn.out3.weight, padding=1)))})
    del acts, conv0, conv1, intra, x, s3, lat

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
        f = feats[key]                                           # [V,h,w,C]
        projs = compose_projection(
            torch.from_numpy(s0["proj_matrices"][key]).to(dev))
        Vn, C = f.shape[0], f.shape[-1]
        var = ledger.compare(
            "warp_variance", f"{key} V{Vn} {h}x{w} C{C} D{nd}",
            lambda: K1.warp_variance(f, projs, lo, step, nd),
            lambda: K1.warp_variance_plain(f, projs, lo, step, nd),
            nbytes(f, projs, lo, step) + 4 * C * nd * h * w,
            warp_flops(Vn, h, w, C, nd))

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
            y = K2.conv3d_plain(t, wgt, b, mode, skip=sk)
            t = ledger.compare(
                "conv3d", f"{key} {name} {mode} {tuple(t.shape)}",
                lambda t=t, wgt=wgt, b=b, mode=mode, sk=sk: K2.conv3d(
                    t, wgt, b, mode, skip=sk),
                lambda t=t, wgt=wgt, b=b, mode=mode, sk=sk: K2.conv3d_plain(
                    t, wgt, b, mode, skip=sk),
                *conv3d_work(t, wgt, y, mode, (b, sk)),
                fn_lib=lambda t=t, wgt=wgt, b=b, mode=mode: library_conv3d(
                    t, wgt, b, mode))
            saved[name] = t
        zero = torch.zeros(1, device=dev)
        y = K2.conv3d_plain(t, cr.prob.weight, zero, "s1", relu=False)
        cost = ledger.compare(
            "conv3d", f"{key} prob s1 {tuple(t.shape)}",
            lambda: K2.conv3d(t, cr.prob.weight, zero, "s1", relu=False),
            lambda: K2.conv3d_plain(t, cr.prob.weight, zero, "s1",
                                    relu=False),
            *conv3d_work(t, cr.prob.weight, y, "s1"),
            fn_lib=lambda: library_conv3d(t, cr.prob.weight, zero, "s1"))
        del saved, t, var
        c = cost[0, 0].contiguous()
        ledger.compare("depth_tail", f"{key} D{nd} {h}x{w}",
                       lambda: K4.depth_tail(c, lo, step),
                       lambda: K4.depth_tail_plain(c, lo, step),
                       nbytes(c, lo, step) + 8 * h * w, 12 * nd * h * w)
    sync(dev)
    ledger.check("eval kernels")


def library_conv3d(x, w, b, mode):
    """One cuDNN call for the same 3D conv (TF32 off)."""
    import torch.nn.functional as F
    if mode == "t2":
        return F.conv_transpose3d(x, w, b, stride=2, padding=1,
                                  output_padding=1)
    return F.conv3d(x, w, b, stride=1 if mode == "s1" else 2, padding=1)


EVAL_KERNELS = ("warp_variance", "conv3d", "depth_tail", "conv2d")
TRAIN_KERNELS = ("warp_variance", "conv3d", "warp_variance_bwd",
                 "warp_volume", "warp_volume_bwd", "conv3d_dw")
TOOLS_KERNELS = EVAL_KERNELS + ("warp_view", "conv3d_lanewise")
# K9 at odd sizes, each mode (Ci=16, Co=8): (label, D, H, W, Ci, Co, mode)
ODD_CONV_CASES = tuple((f"odd 5x9x7 {m}", 5, 9, 7, 16, 8, m)
                       for m in ("s1", "s2", "t2"))


def kernel_wrappers():
    """{name: wrapper} of every kernel; each counts its launches."""
    from rcmvsnet_tpu_torch.ops import (conv2d, conv3d, conv3d_train,
                                        depth_tail, warp_variance,
                                        warp_view, warp_volume)
    return {"warp_variance": warp_variance.warp_variance,
            "conv3d": conv3d.conv3d, "depth_tail": depth_tail.depth_tail,
            "conv2d": conv2d.conv2d,
            "warp_variance_bwd": warp_variance.warp_variance_bwd,
            "warp_volume": warp_volume.warp_volume,
            "warp_volume_bwd": warp_volume.warp_volume_bwd,
            "conv3d_dw": conv3d_train.conv3d_dw,
            "conv3d_lanewise": conv3d.conv3d_lanewise,
            "warp_view": warp_view.warp_view}


def zero_launches():
    """Set every kernel's launch count to 0; returns kernel_wrappers()."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def phase_main(model, samples, scene, dev, name="main_path", smi=None,
               keep=None):
    """Phases 4 and 7: an eval path, `infer_views` over every sample
    through the kernels, then through the plain versions. Every eval
    kernel must launch on the first and none on the second; depth must
    agree within the TPU path's budget. keep: a list that receives the
    kernel path's (depth, confidence) per view."""
    import numpy as np
    import torch
    from rcmvsnet_tpu_torch.models.cascade import infer_views
    cuda = dev.type == "cuda"
    runs = {}
    for plain in (False, True):
        wrappers = zero_launches()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        t0 = time.perf_counter()
        out = infer_views(model, samples, dev, plain=plain)
        sync(dev)
        runs[plain] = {
            "out": out, "s": time.perf_counter() - t0,
            "launches": {k: fn.launches for k, fn in wrappers.items()},
            "peak": torch.cuda.max_memory_allocated(dev) if cuda else None}
        missing = [k for k in EVAL_KERNELS if runs[plain]["launches"][k] == 0]
        if not plain and missing:
            raise AssertionError(f"{name} never launched {missing}")
    if any(runs[True]["launches"].values()):
        raise AssertionError(f"{name}: the plain path launched kernels "
                             f"{runs[True]['launches']}")
    if keep is not None:
        keep.extend(runs[False]["out"])

    rel_max, n_gate, plane_err = 0.0, 0, []
    hw = samples[0]["imgs"].shape[1:3]
    for i, ((dk, ck), (dp, cp)) in enumerate(zip(runs[False]["out"],
                                                  runs[True]["out"])):
        if dk.shape != hw or not np.isfinite(dk).all() \
                or not np.isfinite(ck).all():
            raise AssertionError(f"{name} view {i}: depth {dk.shape} not "
                                 f"finite {hw}")
        rel = np.abs(dk - dp) / np.abs(dp)
        rel_max = max(rel_max, float(rel.max()))
        n_gate += int((rel > DEPTH_GATE).sum())
        plane_err.append(float(np.median(np.abs(dk - scene["depths"][i]))))
    n = len(samples)
    launches = runs[False]["launches"]
    result = {
        "device": smi, "input": f"{hw[1]}x{hw[0]} V={len(samples[0]['imgs'])}"
        f" D={len(samples[0]['depth_values'])}",
        "views": n, "launches": launches,
        "launches_per_map": {k: v / n for k, v in launches.items() if v},
        "depth_maps_per_s_kernel": n / runs[False]["s"],
        "depth_maps_per_s_plain": n / runs[True]["s"],
        "max_memory_allocated_kernel": runs[False]["peak"],
        "max_memory_allocated_plain": runs[True]["peak"],
        "depth_max_rel_delta_vs_plain": rel_max,
        "depth_pixels_above_gate": n_gate,
        "median_abs_depth_err_vs_plane": plane_err,
    }
    print(json.dumps({name: result}), flush=True)
    if rel_max > DEPTH_REL_MAX or n_gate:
        raise AssertionError(f"{name}, kernel vs plain depth: max rel "
                             f"{rel_max:.3e} (limit {DEPTH_REL_MAX}), "
                             f"{n_gate} pixels above {DEPTH_GATE}")
    return result


def phase_tanks(model, dev, smi, shape=(TT_H, TT_W, TT_V)):
    """Phase 7: the eval path at Tanks & Temples' input, with the T&T
    loader's depth range."""
    scene = plane_scene(*shape, SEED)
    return phase_main(model, tanks_samples(scene, NDEPTH), scene, dev,
                      "tanks_path", smi)


def phase_tools(model, sample, dev, conv_cases):
    """Phase 8: the profiling entry points at their shapes; every kernel
    they reach must launch."""
    from rcmvsnet_tpu_torch.tools import profile_breakdown as PB
    from rcmvsnet_tpu_torch.tools import profile_conv3d as PC
    wrappers = zero_launches()
    sync(dev)
    breakdown = PB.run(model, sample, dev)
    conv_rows = PC.run(dev, conv_cases)
    sync(dev)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    result = {"launches": launches, "breakdown_ms": breakdown,
              "conv3d_cases": conv_rows}
    print(json.dumps({"tools_path": result}), flush=True)
    missing = [k for k in TOOLS_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"tools path never launched {missing}")
    return result


def phase_tools_kernels(model, sample, ledger, dev, conv_cases):
    """Phase 8, second half: K10 per view and stage and K9 per case
    against their plain versions, and the K10 route against K1."""
    import torch
    import torch.nn.functional as F
    from rcmvsnet_tpu_torch.ops import conv3d as K9
    from rcmvsnet_tpu_torch.ops import warp_variance as K1
    from rcmvsnet_tpu_torch.ops import warp_view as K10
    from rcmvsnet_tpu_torch.tools import profile_breakdown as PB
    from rcmvsnet_tpu_torch.tools import profile_conv3d as PC

    ledger.phase = "tools"
    for st in PB.stage_inputs(model, sample, dev):
        f, projs, nd, lo, step, dv = (st[k] for k in (
            "feats", "projs", "nd", "lo", "step", "dv"))
        Vn, h, w, C = f.shape
        rel = K1.relative_projections(projs).reshape(-1, 4, 4)
        for v in range(1, Vn):
            px, py = (c[0].contiguous() for c in K10.pixel_coords(
                rel[v:v + 1], dv[None], h, w))
            src = f[v]
            src_nchw = src.permute(2, 0, 1)[None].contiguous()
            grid = torch.stack([px / ((w - 1) / 2.0) - 1.0,
                                py / ((h - 1) / 2.0) - 1.0],
                               -1).reshape(1, nd * h, w, 2)
            ledger.compare(
                "warp_view", f"{st['key']} view{v} {h}x{w} C{C} D{nd}",
                lambda: K10.warp_view(src, px, py),
                lambda: K10.warp_view_plain(src, px, py),
                nbytes(src, px, py) + 4 * nd * h * w * C,
                nd * h * w * (8 * C + 10),
                fn_lib=lambda: F.grid_sample(src_nchw, grid,
                                             align_corners=True))
        ledger.compare(
            "warp_view_route", f"{st['key']} V{Vn} {h}x{w} C{C} D{nd} "
            f"K10 route vs K1",
            lambda: PB.route_variance(st),
            lambda: K1.warp_variance(f, projs, lo, step, nd).permute(
                1, 2, 3, 0),
            nbytes(f, projs, lo, step) + 4 * C * nd * h * w,
            warp_flops(Vn, h, w, C, nd))
    for case in tuple(conv_cases) + ODD_CONV_CASES:
        x, wgt = PC.case_inputs(case, dev)
        mode = case[-1]
        y = K9.conv3d_lanewise_plain(x, wgt, mode)
        ledger.compare(
            "conv3d_lanewise", f"{case[0]} {tuple(x.shape)}",
            lambda: K9.conv3d_lanewise(x, wgt, mode),
            lambda: K9.conv3d_lanewise_plain(x, wgt, mode),
            *conv3d_work(x, wgt, y, mode),
            fn_lib=lambda: library_conv3d(x, wgt, None, mode))
        del x, wgt, y
    sync(dev)
    ledger.check("tools kernels")



def phase_train_kernels(cascade, render, batch, scene, ledger, dev):
    """Phase 5: the train kernels against their plain versions at the
    train shapes, forward and backward from fixed random cotangents."""
    import torch
    from rcmvsnet_tpu_torch.nn.costreg import TRUNK, conv_bn
    from rcmvsnet_tpu_torch.ops import conv3d as K2
    from rcmvsnet_tpu_torch.ops import conv3d_train as K8
    from rcmvsnet_tpu_torch.ops import warp_variance as K1
    from rcmvsnet_tpu_torch.ops import warp_volume as K7
    from rcmvsnet_tpu_torch.ops.sampling import resize_bilinear
    from rcmvsnet_tpu_torch.tools.repeat_warp_bwd import train_stages

    ledger.phase = "train"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    imgs = batch["imgs"][0]                                   # [V,H,W,3]
    Hs, Ws = imgs.shape[1:3]
    unets = []
    for s, (key, f, projs, lo, step, nd) in enumerate(
            train_stages(cascade, batch, scene, rand)):
        Vn, h, w, C = f.shape
        tag = f"{key} V{Vn} {h}x{w} C{C} D{nd}"
        ledger.compare(
            "warp_variance", tag,
            lambda: K1.warp_variance(f, projs, lo, step, nd),
            lambda: K1.warp_variance_plain(f, projs, lo, step, nd),
            nbytes(f, projs, lo, step) + 4 * C * nd * h * w,
            warp_flops(Vn, h, w, C, nd))
        g = rand(C, nd, h, w)
        ledger.compare(
            "warp_variance_bwd", tag,
            lambda: K1.warp_variance_bwd(f, projs, lo, step, g),
            lambda: K1.warp_variance_bwd_plain(f, projs, lo, step, g),
            2 * nbytes(f) + nbytes(projs, lo, step, g),
            warp_flops(Vn, h, w, C, nd, bwd=True), repeat=True,
            extra=tap_runs(projs, lo, step, nd, C))
        if s == 0:
            im = resize_bilinear(imgs, h, w).contiguous()
            ledger.compare(
                "warp_volume", tag,
                lambda: K7.warp_volume(f, im, projs, lo, step, nd),
                lambda: K7.warp_volume_plain(f, im, projs, lo, step, nd),
                nbytes(f, im, projs, lo, step)
                + 4 * (2 * C + 3 * (Vn - 1)) * nd * h * w,
                warp_flops(Vn, h, w, C, nd, images=3))
            # var's cotangent, then the render volume's (images, no-ref)
            cots = (g, rand(3 * (Vn - 1) + C, nd, h, w))
            ledger.compare(
                "warp_volume_bwd", tag,
                lambda: K7.warp_volume_bwd(f, im, projs, lo, step, *cots),
                lambda: K7.warp_volume_bwd_plain(f, im, projs, lo, step,
                                                 *cots),
                2 * nbytes(f, im) + nbytes(projs, lo, step, *cots),
                warp_flops(Vn, h, w, C, nd, bwd=True, images=3),
                repeat=True, extra=tap_runs(projs, lo, step, nd, C + 3))
        unets.append((f"cr{s}", cascade.cost_regularization[s], C,
                      (nd, h, w)))
    rc = render.MVSNet["cost_reg_2"]
    unets.append(("render", rc, rc.conv0.conv.in_channels,
                  (render.num_planes, Hs // 4, Ws // 4)))

    for net_name, net, ci, dims in unets:
        layers = [(n, m, conv_bn(getattr(net, n))[0].weight)
                  for n, m in TRUNK]
        if hasattr(net, "prob"):
            layers.append(("prob", "s1", net.prob.weight))
        cur = (ci, *dims)                  # the layer's input [C, D, H, W]
        for name, mode, wgt in layers:
            cin, d, h, w = cur
            co = wgt.shape[1] if mode == "t2" else wgt.shape[0]
            cur = (co, *K2.out_shape(mode, d, h, w))
            x = rand(1, cin, d, h, w)
            g = rand(1, *cur)
            adj_w = K8._adjoint_weight(wgt, mode)
            adj = K8.ADJOINT[mode]
            zo, zi = torch.zeros(co, device=dev), torch.zeros(cin, device=dev)
            tag = f"{net_name} {name} {mode} {tuple(x.shape)}"
            y = K2.conv3d_plain(x, wgt, None, mode, relu=False)
            ledger.compare(
                "conv3d", f"train fwd {tag}",
                lambda: K2.conv3d(x, wgt, zo, mode, relu=False),
                lambda: K2.conv3d_plain(x, wgt, None, mode, relu=False),
                *conv3d_work(x, wgt, y, mode),
                fn_lib=lambda: library_conv3d(x, wgt, None, mode))
            ledger.compare(
                "conv3d", f"train dx {tag}",
                lambda: K2.conv3d(g, adj_w, zi, adj, relu=False),
                lambda: K2.conv3d_plain(g, adj_w, None, adj, relu=False),
                *conv3d_work(g, adj_w, x, adj),
                fn_lib=lambda: library_conv3d(g, adj_w, None, adj))
            _, flops = conv3d_work(x, wgt, y, mode)
            ledger.compare(
                "conv3d_dw", tag,
                lambda: K8.conv3d_dw(x, g, mode),
                lambda: K8.conv3d_dw_plain(x, g, mode),
                nbytes(x, g, wgt), flops,
                fn_lib=lambda: library_conv3d_dw(x, g, wgt, mode))
            del x, g, y
    sync(dev)
    ledger.check("train kernels")


def library_conv3d_dw(x, g, w, mode):
    """One cuDNN call for the same weight gradient (TF32 off)."""
    import torch
    t2 = mode == "t2"
    s = 1 if mode == "s1" else 2
    return torch.ops.aten.convolution_backward(
        g, x, w, None, [s] * 3, [1] * 3, [1] * 3, t2, [1 if t2 else 0] * 3,
        1, [False, True, False])[1]


def phase_train(batch, cascade_sd, smi, dev, cfg=None, warmup=2, timed=5):
    """Phase 6: the fused train step, kernels then plain versions, from
    one init and one batch with the draws fixed once."""
    import torch
    from rcmvsnet_tpu_torch.config import Config
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import draw_step, make_train_step
    cfg = cfg or Config()
    cuda = dev.type == "cuda"
    B, Vn, Hs, Ws = batch["imgs"].shape[:4]
    draws = draw_step(torch.Generator(device=dev).manual_seed(SEED), cfg, B,
                      Hs, Ws)
    paths = {}
    for plain in (False, True):
        state = create_train_state(cfg, Vn, 1000, dev, seed=SEED,
                                   state_dicts=(cascade_sd, None))
        step = make_train_step(cfg, plain=plain)
        wrappers = zero_launches()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        torch.backends.cudnn.deterministic = plain
        first = {k: float(v) for k, v in step(state, batch, draws).items()}
        torch.backends.cudnn.deterministic = False
        grads = {f"render.{n}": p.grad.detach().clone()
                 for n, p in state.render.named_parameters()}
        grads.update({n: p.grad.detach().clone()
                      for n, p in state.cascade.named_parameters()})
        for _ in range(warmup - 1):
            step(state, batch, draws)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(timed):
            last = step(state, batch, draws)
        sync(dev)
        dt = time.perf_counter() - t0
        paths["plain" if plain else "kernel"] = {
            "first": first, "grads": grads, "steps_per_s": timed / dt,
            "last_loss": float(last["loss"]),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if cuda else None),
            "launches": {k: fn.launches for k, fn in wrappers.items()}}
        del state
        if cuda:
            torch.cuda.empty_cache()

    k, p = paths["kernel"], paths["plain"]
    rel = {n: abs(k["first"][n] - v) / max(abs(v), 1e-12)
           for n, v in p["first"].items()}
    scale = {m: max(float(g.abs().max()) for n, g in p["grads"].items()
                    if n.startswith("render.") == (m == "render"))
             for m in ("render", "cascade")}
    grad_err = {n: float((k["grads"][n] - g).abs().max())
                / scale["render" if n.startswith("render.") else "cascade"]
                for n, g in p["grads"].items()}
    grad_l2 = {n: float((k["grads"][n] - g).norm())
               / max(float(g.norm()), 1e-30) for n, g in p["grads"].items()}
    result = {
        "device": smi, "input": f"{Ws}x{Hs} B={B} V={Vn}",
        "steps_per_s_kernel": k["steps_per_s"],
        "steps_per_s_plain": p["steps_per_s"],
        "max_memory_allocated_kernel": k["max_memory_allocated"],
        "max_memory_allocated_plain": p["max_memory_allocated"],
        "launches": k["launches"], "launches_plain": p["launches"],
        "step1_loss_kernel": k["first"]["loss"],
        "step1_loss_plain": p["first"]["loss"],
        "step1_metrics_kernel": k["first"],
        "step1_rel_delta": rel,
        "grad_max_l2_rel": max(grad_l2.values()),
        "grad_worst_l2_rel": sorted(grad_l2.items(),
                                    key=lambda t: -t[1])[:5],
        "grad_max_err_of_model_scale": max(grad_err.values()),
        "step7_loss_kernel": k["last_loss"], "step7_loss_plain":
            p["last_loss"]}
    print(json.dumps({"train_path": result}), flush=True)
    missing = [n for n in TRAIN_KERNELS if k["launches"][n] == 0]
    if missing:
        raise AssertionError(f"train path never launched {missing}")
    if any(p["launches"].values()):
        raise AssertionError(f"plain train path launched kernels: "
                             f"{p['launches']}")
    terms = ("loss", "repr_loss", "aug_loss", "img_loss", "ray_depth_loss")
    bad = {n: rel[n] for n in terms if not rel[n] <= LOSS_RTOL}
    if bad or not all(map(lambda v: v == v, k["first"].values())):
        raise AssertionError(f"step-1 losses kernel vs plain: {bad}")
    if not max(grad_l2.values()) <= GRAD_L2_TOL:
        raise AssertionError(f"gradients kernel vs plain: "
                             f"{result['grad_worst_l2_rel']}")
    return result


def _depth_gate(name, dk, dp):
    """Phase 4's gate on one kernel-path depth map against the plain
    path's: finite, max relative delta ≤ DEPTH_REL_MAX, no pixel above
    DEPTH_GATE. Returns the max relative delta."""
    import numpy as np
    dk, dp = np.asarray(dk), np.asarray(dp)
    rel = np.abs(dk - dp) / np.abs(dp)
    if dk.shape != dp.shape or not np.isfinite(dk).all() \
            or float(rel.max()) > DEPTH_REL_MAX or (rel > DEPTH_GATE).any():
        n_gate = int((rel > DEPTH_GATE).sum())
        raise AssertionError(f"{name}, kernel vs plain depth: max rel "
                             f"{float(rel.max()):.3e} (limit "
                             f"{DEPTH_REL_MAX}), {n_gate} pixels above "
                             f"{DEPTH_GATE}")
    return float(rel.max())


def _state_tensors(state) -> dict:
    """Every model and optimizer tensor of a train state, by name."""
    out = {f"cascade.{k}": v for k, v in state.cascade.state_dict().items()}
    out.update({f"render.{k}": v
                for k, v in state.render.state_dict().items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in st.items()})
    return out


def phase_train_cli(dtu_sample, smi, dev, logdir, shape=(TH, TW, TV),
                    ndepth=NDEPTH, steps=3, cfg=None):
    """Phase 9: the train CLI's loop, `cli.train.fit`, on in-memory
    plane-scene datasets: `steps` train items at `shape`, 2 val items with
    one more view, the golden backbone and a seeded render branch; 2
    epochs (validate and save every epoch), then `--resume` for a third;
    then one step each of render v1 and v2."""
    import dataclasses
    import numpy as np
    import torch
    from rcmvsnet_tpu_torch.cli.train import fit
    from rcmvsnet_tpu_torch.config import Config, DataConfig, RunConfig
    from rcmvsnet_tpu_torch.data.plane_scene import plane_items
    from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet, infer_views
    from rcmvsnet_tpu_torch.train.checkpoint import (checkpoint_paths,
                                                     restore_checkpoint)
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import batch_to, make_val_step
    from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict
    cuda = dev.type == "cuda"
    Hs, Ws, Vn = shape
    logdir = Path(logdir)
    train_ds = plane_items(steps, Hs, Ws, Vn, ndepth, SEED)
    val_ds = plane_items(2, Hs, Ws, Vn + 1, ndepth, SEED + 1000, val=True)
    base = cfg or Config()
    cfg = base.replace(data=DataConfig(num_views=Vn, numdepth=ndepth),
                       run=RunConfig(epochs=2, eval_freq=1, save_freq=1,
                                     summary_freq=1, seed=SEED,
                                     logdir=str(logdir)))
    golden = (load_state_dict(ASSET), None)
    wrappers = zero_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    run1 = fit(cfg, train_ds, val_ds, dev, state_dicts=golden)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    missing = [k for k in dict.fromkeys(TRAIN_KERNELS + EVAL_KERNELS)
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"train CLI never launched {missing}")
    state = run1["state"]
    saved_step = state.step
    recs = [json.loads(line) for line in
            (logdir / "scalars.jsonl").read_text().splitlines()]
    modes = {r["mode"] for r in recs}
    losses = [v for r in recs for k, v in r.items() if "loss" in k]
    if not {"train", "fulltrain", "fulltest"} <= modes or not losses \
            or not all(np.isfinite(losses)):
        raise AssertionError(f"train CLI records {sorted(modes)}: losses "
                             f"{losses}")
    for epoch in range(cfg.run.epochs):
        cas, nerf = checkpoint_paths(logdir, epoch)
        keys = (set(torch.load(cas, map_location="cpu")),
                set(torch.load(nerf, map_location="cpu")))
        if keys != ({"epoch", "model", "optimizer", "step"}, {"model"}):
            raise AssertionError(f"epoch {epoch} checkpoint keys {keys}")

    # one image-summary call alone (ten 512x640 maps, as a step logs them):
    # the summaries' share of the loop's host time
    from rcmvsnet_tpu_torch.train.logging import MetricLogger
    probe = MetricLogger(logdir / "log_probe")
    maps = {f"map{i}": np.random.RandomState(i).rand(1, Hs, Ws).astype(
        np.float32) for i in range(10)}
    t0 = time.perf_counter()
    probe.log_images("probe", maps, 1)
    log_images_s = time.perf_counter() - t0
    tensorboard = probe._tb is not None
    probe.close()

    # the saved pair restores into a fresh state, tensor for tensor
    fresh = create_train_state(cfg, Vn, steps, dev, seed=SEED + 1)
    sync(dev)
    t0 = time.perf_counter()
    fresh, start = restore_checkpoint(logdir, fresh)
    sync(dev)
    restore_s = time.perf_counter() - t0
    want, got = _state_tensors(state), _state_tensors(fresh)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    if set(want) != set(got) or differ or start != cfg.run.epochs \
            or fresh.step != state.step:
        raise AssertionError(f"restored state differs: {differ[:5]}, "
                             f"epoch {start}, step {fresh.step} vs "
                             f"{state.step}")
    del fresh

    # the val step's depth, kernels vs plain, on one val batch
    vb = batch_to({k: ({kk: vv[None] for kk, vv in v.items()}
                       if isinstance(v, dict) else v[None])
                   for k, v in val_ds[0].items()}, dev)
    val_rel = _depth_gate("val step", *(
        make_val_step(cfg, plain=plain, with_depth=True)(
            state, vb)["depth"][0].cpu() for plain in (False, True)))

    # the last *_cas.ckpt into a fresh model: a DTU-shape depth map
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(checkpoint_paths(
        logdir, cfg.run.epochs - 1)[0]), strict=True)
    model = model.to(dev).eval()
    (dk, _), = infer_views(model, [dtu_sample], dev)
    (dp, _), = infer_views(model, [dtu_sample], dev, plain=True)
    ckpt_rel = _depth_gate("eval from the saved checkpoint", dk, dp)
    del model, state, run1["state"]

    # --resume for a third epoch
    cfg3 = cfg.replace(run=dataclasses.replace(cfg.run, epochs=3))
    run2 = fit(cfg3, train_ds, val_ds, dev, resume=True, state_dicts=golden)
    if run2["start_epoch"] != 2 or run2["start_step"] != saved_step \
            or not checkpoint_paths(logdir, 2)[0].exists():
        raise AssertionError(f"resume: epoch {run2['start_epoch']}, step "
                             f"{run2['start_step']}")
    del run2["state"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None

    # render v1 and v2: one step each through the same loop
    variants = {}
    for net in ("v1", "v2"):
        cfg_n = cfg.replace(
            render=dataclasses.replace(cfg.render, net_type=net),
            run=dataclasses.replace(cfg.run, epochs=1,
                                    logdir=str(logdir / net)))
        wrappers = zero_launches()
        run = fit(cfg_n, train_ds, val_ds, dev, max_steps=1,
                  state_dicts=golden)
        del run["state"]
        rec = [json.loads(line) for line in (logdir / net / "scalars.jsonl")
               .read_text().splitlines() if '"train"' in line][0]
        variants[net] = {"loss": rec["loss"], "launches": {
            k: fn.launches for k, fn in wrappers.items()}}
        used = variants[net]["launches"]
        if not np.isfinite([v for k, v in rec.items() if "loss" in k]).all() \
                or not all(used[k] for k in ("warp_volume", "warp_volume_bwd",
                                             "conv3d_dw")):
            raise AssertionError(f"render {net}: {variants[net]}")
    result = {
        "device": smi, "input": f"{Ws}x{Hs} B=1 V={Vn}, val V={Vn + 1}",
        "launches": launches,
        "steps_per_s_with_loading": run1["train_steps"]
        / sum(run1["epoch_s"]),
        # the same loop less the summaries it writes at summary_freq 1
        "steps_per_s_without_summaries": run1["train_steps"]
        / (sum(run1["epoch_s"]) - run1["log_s"]),
        "steps_per_s_epoch": [steps / t for t in run1["epoch_s"]],
        "loading_s": run1["load_s"], "summary_logging_s": run1["log_s"],
        "one_log_images_call_s": log_images_s, "tensorboard": tensorboard,
        "val_batches_per_s": run1["val_batches"] / run1["val_s"],
        "save_s": run1["save_s"], "restore_s": restore_s,
        "resume_restore_s": run2["restore_s"],
        "max_memory_allocated": peak,
        "val_depth_max_rel_delta_vs_plain": val_rel,
        "ckpt_depth_max_rel_delta_vs_plain": ckpt_rel,
        "losses": [r["loss"] for r in recs if r["mode"] == "train"],
        "render_variants": variants}
    print(json.dumps({"train_cli": result}), flush=True)
    return result

# K4 past its register instances (its streaming instance) and K8 dw past
# one group of 64 output channels, at widths the JAX package runs
# (--ndepths 96,32,8 or 192 planes in a stage; --cr_base_chs 16,16,16):
# (label, D, h, w) and (label, Ci, Co, input (D, H, W), mode)
WIDE_TAIL_CASES = (("stage1 D96 216x288", 96, 216, 288),
                   ("stage1 D192 216x288", 192, 216, 288),
                   ("stage3 slab D96 864x1152", 96, 864, 1152),
                   ("stage3 slab D192 864x1152", 192, 864, 1152))
WIDE_DW_CASES = (("cr16 stage1 conv5 s2 64>128", 64, 128, (12, 32, 40), "s2"),
                 ("cr16 stage1 conv6 s1 128>128", 128, 128, (6, 16, 20),
                  "s1"))


def phase_wide_kernels(ledger, dev, tail_cases=WIDE_TAIL_CASES,
                       dw_cases=WIDE_DW_CASES):
    """Phases 3 and 5, their rows past the widths the kernels once
    refused: K4 at D > 64 against `depth_tail_plain` at K4's bounds
    (costs 3·N(0, 1), the full sweep, as `tools/ab_depth_tail` makes
    them), K8 dw at 128 output channels (two Co groups) in modes s1 and
    s2 against `conv3d_dw_plain` at 1e-4 of the largest value. Their rows
    carry the phase "wide", so the kernels line's sums keep the main
    paths' calls alone."""
    import torch
    from rcmvsnet_tpu_torch.ops import conv3d_train as K8
    from rcmvsnet_tpu_torch.ops import depth_tail as K4
    from rcmvsnet_tpu_torch.ops.conv3d import out_shape
    from rcmvsnet_tpu_torch.tools.ab_depth_tail import inputs
    ledger.phase = "wide"
    for label, D, h, w in tail_cases:
        (cost, lo, step), = inputs(dev, ((label, D, h, w),)).values()
        ledger.compare("depth_tail", label,
                       lambda: K4.depth_tail(cost, lo, step),
                       lambda: K4.depth_tail_plain(cost, lo, step),
                       nbytes(cost, lo, step) + 8 * h * w, 12 * D * h * w)
        del cost, lo, step
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, ci, co, dhw, mode in dw_cases:
        x = torch.randn(1, ci, *dhw, generator=gen, device=dev)
        g = torch.randn(1, co, *out_shape(mode, *dhw), generator=gen,
                        device=dev)
        wgt = torch.zeros(co, ci, 3, 3, 3, device=dev)   # shape only
        _, flops = conv3d_work(x, wgt, g, mode)
        ledger.compare("conv3d_dw", label, lambda: K8.conv3d_dw(x, g, mode),
                       lambda: K8.conv3d_dw_plain(x, g, mode),
                       nbytes(x, g, wgt), flops,
                       fn_lib=lambda: library_conv3d_dw(x, g, wgt, mode))
        del x, g
    sync(dev)
    ledger.check("wide kernels")


def phase_wide_paths(samples, scene, batch, smi, dev, cfg=None):
    """Phase 10: the configurations the repaired kernels serve, end to
    end. `infer_views` with the golden backbone at --ndepths 96,32,8
    (stage 1's K4 through its streaming instance) through the kernels and
    the plain versions, phase 4's gate; one train step at --cr_base_chs
    16,16,16 (conv5 and conv6 128 channels wide, K8 dw over two Co
    groups) from a seeded init through the kernels: finite losses, every
    train kernel launched."""
    from rcmvsnet_tpu_torch.config import BackboneConfig
    from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
    from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict
    model = CascadeMVSNet(BackboneConfig(ndepths=(96, 32, 8)))
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model = model.to(dev).eval()
    evaluation = phase_main(model, samples, scene, dev, "wide_eval_path",
                            smi)
    del model
    return {"device": smi, "eval_96_32_8": evaluation,
            "train_cr_base_chs_16": wide_train_step(batch, smi, dev, cfg)}


def wide_train_step(batch, smi, dev, cfg=None):
    """Phase 10's train step at --cr_base_chs 16,16,16 (see
    `phase_wide_paths`)."""
    import dataclasses
    import numpy as np
    import torch
    from rcmvsnet_tpu_torch.config import Config
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import draw_step, make_train_step
    base = cfg or Config()
    cfg16 = base.replace(backbone=dataclasses.replace(
        base.backbone, cr_base_chs=(16, 16, 16)))
    B, Vn, Hs, Ws = batch["imgs"].shape[:4]
    state = create_train_state(cfg16, Vn, 1000, dev, seed=SEED)
    wrappers = zero_launches()
    first = {k: float(v) for k, v in make_train_step(cfg16)(
        state, batch, draw_step(torch.Generator(device=dev).manual_seed(
            SEED), cfg16, B, Hs, Ws)).items()}
    launches = {k: fn.launches for k, fn in wrappers.items()}
    del state
    result = {"device": smi, "input": f"{Ws}x{Hs} B={B} V={Vn}",
              "step1_metrics": first, "launches": launches}
    print(json.dumps({"wide_train_path": result}), flush=True)
    if not all(np.isfinite(v) for v in first.values()):
        raise AssertionError(f"cr_base_chs 16 step: {first}")
    missing = [n for n in TRAIN_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"wide train path never launched {missing}")
    return result


def _device_draws(draws, dev):
    from rcmvsnet_tpu_torch.render.rays import RayDraws
    from rcmvsnet_tpu_torch.train.step import StepDraws
    return StepDraws(draws.mask_origin.to(dev), tuple(
        RayDraws(*(t.to(dev) for t in r)) for r in draws.rays))


def _grads(state) -> dict:
    out = {f"render.{n}": p.grad.detach().cpu().clone()
           for n, p in state.render.named_parameters()}
    out.update({n: p.grad.detach().cpu().clone()
                for n, p in state.cascade.named_parameters()})
    return out


def _dp_step_rank(rank, world, device, batch, draws, cascade_sd, cfg, out,
                  timed):
    """Phase 11 (b), one rank: its rows of the global batch through the
    data-parallel kernel step; step 1's
    metrics, gradients (summed over the ranks), launches and parameters
    after Adam, then `timed` steps."""
    import torch
    from rcmvsnet_tpu_torch.core.geometry import set_full_precision
    from rcmvsnet_tpu_torch.parallel import mesh
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import make_train_step
    if device.type == "cuda":
        set_full_precision()
    torch.backends.cudnn.deterministic = True
    group = mesh.batch_group()
    mine = _rows_to(batch, rank, device)
    state = create_train_state(cfg, mine["imgs"].shape[1], 1000, device,
                               seed=SEED, state_dicts=(cascade_sd, None),
                               group=group)
    step = make_train_step(cfg, group=group)
    draws = _device_draws(draws, device)
    wrappers = zero_launches()
    first = {k: float(v) for k, v in step(state, mine, draws).items()}
    launches = {k: fn.launches for k, fn in wrappers.items()}
    res = {"first": first, "grads": _grads(state), "launches": launches,
           "params": {k: v.detach().cpu().clone() for k, v in
                      _state_tensors(state).items()}}
    sync(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        step(state, mine, draws)
    sync(device)
    res["steps_per_s"] = timed / (time.perf_counter() - t0) if timed else None
    torch.save(res, Path(out) / f"dp_step{rank}.pt")


def _dp_eval_rank(rank, world, device, shape, ndepth, out):
    """Phase 11 (c), one rank: `infer_views_sharded` over the plane
    scene's reference views (the scene rebuilt from SEED)."""
    import torch
    from rcmvsnet_tpu_torch.core.geometry import set_full_precision
    from rcmvsnet_tpu_torch.models.cascade import (CascadeMVSNet,
                                                   infer_views_sharded)
    from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict
    if device.type == "cuda":
        set_full_precision()
    samples = dtu_samples(plane_scene(*shape, SEED), ndepth)
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model = model.to(device).eval()
    wrappers = zero_launches()
    views = [(i, d, c) for i, _, d, c in
             infer_views_sharded(model, samples, device, rank, world)]
    torch.save({"views": views, "launches": {
        k: fn.launches for k, fn in wrappers.items()}},
        Path(out) / f"dp_eval{rank}.pt")


def phase_parallel(batch1, draws1, batch2, draws2, cascade_sd, phase6,
                   eval_out, smi, dev, out_dir, cfg=None, shape=(H, W, V),
                   ndepth=NDEPTH, timed=3, timeout=900):
    """Phase 11, data parallelism (`parallel/`).
    (a) A group of one rank (NCCL on the card): one train step on phase
        6's batch and draws (batch1, draws1) through the data-parallel
        step (group `batch_group()`, None at world 1, so nothing is
        swapped) must give phase 6's kernel step-1 metrics in every bit,
        and an all-reduce of its gradients over the one-rank
        group must return them unchanged.
    (b) Two ranks on this one card over Gloo (NCCL puts no two ranks on
        one card), B=1 each, against the single-process kernel step at B=2
        on the same global batch and draws (cudnn.deterministic in both),
        held two ways:
          * against that step with its BatchNorms the cross-rank layer's
            at one rank (which sums each row alone and the rows in a fixed
            tree, so two ranks reach its statistics bit for bit): every
            step-1 loss term within LOSS_RTOL and every parameter gradient
            within GRAD_L2_TOL in relative L2;
          * against that step with PyTorch's own BatchNorm: repr_loss and
            aug_loss within LOSS_RTOL and every gradient outside the
            render network within GRAD_L2_TOL. img_loss, ray_depth_loss
            (and so loss) and the render network's gradients are printed,
            not gated: the render terms are discontinuous (a sample's
            in-bounds mask in the colour volume flips), and a
            rounding-level change of the pseudo-depth, such as the two
            BatchNorms' different summation orders give, moves a single
            ray's depth by a large share.
        Both ranks' parameters and buffers after Adam equal in every bit,
        K1, K2, K6, K7 and K8 launched in each rank; steps/s of 2 ranks
        sharing one card (not a scaling figure).
    (c) Two ranks run `infer_views_sharded` over phase 4's reference
        views; the gathered depth and confidence must equal phase 4's
        kernel output in every bit, or else pass phase 4's gate (the
        result names which held)."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from rcmvsnet_tpu_torch.config import Config
    from rcmvsnet_tpu_torch.parallel import mesh, sync_bn
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import batch_to, make_train_step
    cfg = cfg or Config()
    cuda = dev.type == "cuda"
    result = {"device": smi}

    # (a) one rank
    store = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    mesh.init_process(0, 1, f"file://{store}/store", dev)
    try:
        state = create_train_state(cfg, batch1["imgs"].shape[1], 1000, dev,
                                   seed=SEED, state_dicts=(cascade_sd, None),
                                   group=mesh.batch_group())
        step = make_train_step(cfg, group=mesh.batch_group())
        first = {k: float(v) for k, v in step(state, batch1, draws1).items()}
        grads = [p.grad for p in state.optimizer.param_groups[0]["params"]
                 if p.grad is not None]
        before = [g.clone() for g in grads]
        mesh.allreduce_gradients(state.optimizer.param_groups[0]["params"],
                                 dist.group.WORLD)
        unchanged = all(torch.equal(a, b) for a, b in zip(before, grads))
        backend = dist.get_backend()
        del state, grads, before
    finally:
        dist.destroy_process_group()
    want = phase6["step1_metrics_kernel"]
    differ = {k: (first[k], want[k]) for k in want
              if k != "lr" and first[k] != want[k]}
    result["one_rank"] = {"backend": backend, "step1_metrics": first,
                          "equal_to_phase6": not differ,
                          "allreduce_unchanged": unchanged}
    print(json.dumps({"parallel_one_rank": result["one_rank"]}), flush=True)
    if differ or not unchanged:
        raise AssertionError(f"one-rank group: step-1 metrics differ from "
                             f"phase 6 {differ}, all-reduce unchanged "
                             f"{unchanged}")
    if cuda:
        torch.cuda.empty_cache()

    # (b) two ranks against the single-process step at B=2, its
    # BatchNorms the cross-rank layer's at one rank, and PyTorch's own
    refs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for bn in ("cross_rank_one_rank", "pytorch"):
            state = create_train_state(cfg, batch2["imgs"].shape[1], 1000,
                                       dev, seed=SEED,
                                       state_dicts=(cascade_sd, None))
            if bn == "cross_rank_one_rank":
                for m in (state.cascade, state.render):
                    sync_bn.convert(m, None, one_rank=True)
            first = {k: float(v) for k, v in make_train_step(cfg)(
                state, batch_to(batch2, dev),
                _device_draws(draws2, dev)).items()}
            refs[bn] = (first, _grads(state))
            del state
    finally:
        torch.backends.cudnn.deterministic = False
    ref, ref_grads = refs["cross_rank_one_rank"]
    if cuda:
        torch.cuda.empty_cache()
    devices = [str(dev)] * 2
    mesh.spawn(_dp_step_rank, 2, (batch2, draws2, cascade_sd, cfg,
                                  str(out_dir), timed),
               devices=devices, backend="gloo", timeout=timeout)
    ranks = [torch.load(Path(out_dir) / f"dp_step{r}.pt", weights_only=False)
             for r in range(2)]
    terms = ("loss", "repr_loss", "aug_loss", "img_loss", "ray_depth_loss")
    rel = {n: max(abs(r["first"][n] - ref[n]) / max(abs(ref[n]), 1e-12)
                  for r in ranks) for n in terms}
    grad_l2 = {n: max(float((r["grads"][n] - g).norm())
                      / max(float(g.norm()), 1e-30) for r in ranks)
               for n, g in ref_grads.items()}
    same = [k for k, v in ranks[0]["params"].items()
            if not torch.equal(v, ranks[1]["params"][k])]
    pt, pt_grads = refs["pytorch"]
    pt_rel = {n: max(abs(r["first"][n] - pt[n]) / max(abs(pt[n]), 1e-12)
                     for r in ranks) for n in terms}
    pt_l2 = {n: max(float((r["grads"][n] - g).norm())
                    / max(float(g.norm()), 1e-30) for r in ranks)
             for n, g in pt_grads.items()}
    pt_backbone_l2 = {n: v for n, v in pt_l2.items()
                      if not n.startswith("render.")}
    vs_pytorch_bn = {
        "step1_rel_delta": pt_rel,
        "grad_max_l2_rel_backbone": max(pt_backbone_l2.values()),
        "grad_worst_l2_rel_backbone": sorted(
            pt_backbone_l2.items(), key=lambda t: -t[1])[:5],
        "not_gated": {"img_loss": pt_rel["img_loss"],
                      "ray_depth_loss": pt_rel["ray_depth_loss"],
                      "loss": pt_rel["loss"],
                      "grad_max_l2_rel_render": max(
                          v for n, v in pt_l2.items()
                          if n.startswith("render."))}}
    result["two_ranks"] = {
        "input": f"{batch2['imgs'].shape[3]}x{batch2['imgs'].shape[2]} "
                 f"B=1 per rank, global B=2, V={batch2['imgs'].shape[1]}",
        "backend": "gloo, 2 ranks on one card",
        "step1_loss_ranks": [r["first"]["loss"] for r in ranks],
        "step1_loss_single_b2": ref["loss"], "step1_rel_delta": rel,
        "step1_metrics_rel_delta": {
            n: max(abs(r["first"][n] - v) / max(abs(v), 1e-12)
                   for r in ranks) for n, v in ref.items()},
        "grad_max_l2_rel": max(grad_l2.values()),
        "grad_worst_l2_rel": sorted(grad_l2.items(), key=lambda t: -t[1])[:5],
        "params_differ_across_ranks": same,
        "vs_b2_pytorch_batchnorm": vs_pytorch_bn,
        "launches": [r["launches"] for r in ranks],
        "steps_per_s_2_ranks_sharing_one_card_not_a_scaling_figure":
            [r["steps_per_s"] for r in ranks]}
    print(json.dumps({"parallel_two_ranks": result["two_ranks"]}),
          flush=True)
    bad = {n: v for n, v in rel.items() if not v <= LOSS_RTOL}
    bad.update({f"{n} vs PyTorch BN": pt_rel[n]
                for n in ("repr_loss", "aug_loss")
                if not pt_rel[n] <= LOSS_RTOL})
    pt_bad = not vs_pytorch_bn["grad_max_l2_rel_backbone"] <= GRAD_L2_TOL
    if (bad or not max(grad_l2.values()) <= GRAD_L2_TOL or pt_bad
            or same):
        worst = (result["two_ranks"]["grad_worst_l2_rel"],
                 vs_pytorch_bn["grad_worst_l2_rel_backbone"])
        raise AssertionError(f"two ranks vs one at B=2: losses {bad}, "
                             f"gradients (vs cross-rank BN, vs PyTorch BN "
                             f"outside render) {worst}, parameters "
                             f"differing {same[:5]}")
    if cuda:
        torch.cuda.empty_cache()

    # (c) sharded eval against phase 4's output
    mesh.spawn(_dp_eval_rank, 2, (shape, ndepth, str(out_dir)),
               devices=devices, backend="gloo", timeout=timeout)
    got = {}
    eval_launches = []
    for r in range(2):
        blob = torch.load(Path(out_dir) / f"dp_eval{r}.pt",
                          weights_only=False)
        eval_launches.append(blob["launches"])
        got.update({i: (d, c) for i, d, c in blob["views"]})
    if sorted(got) != list(range(len(eval_out))):
        raise AssertionError(f"sharded eval views {sorted(got)}")
    bitwise = all(np.array_equal(got[i][0], d) and np.array_equal(got[i][1], c)
                  for i, (d, c) in enumerate(eval_out))
    rel_max = max(_depth_gate(f"sharded eval view {i}", got[i][0], d)
                  for i, (d, _) in enumerate(eval_out))
    result["sharded_eval"] = {
        "views": len(got), "held": "bit for bit" if bitwise
        else "phase 4's gate", "depth_max_rel_delta_vs_phase4": rel_max,
        "launches": eval_launches}
    print(json.dumps({"parallel_sharded_eval": result["sharded_eval"]}),
          flush=True)
    missing = [(r, k) for r, l in enumerate(result["two_ranks"]["launches"])
               for k in ("warp_variance", "conv3d", "warp_variance_bwd",
                         "warp_volume", "warp_volume_bwd", "conv3d_dw")
               if l[k] == 0]
    missing += [(r, k) for r, l in enumerate(eval_launches)
                for k in EVAL_KERNELS if l[k] == 0]
    if missing:
        raise AssertionError(f"parallel ranks never launched {missing}")
    return result


def _rows_to(batch, r, dev):
    """Row r of a numpy batch as a B=1 batch of tensors on dev."""
    from rcmvsnet_tpu_torch.train.step import batch_to
    return batch_to({k: ({kk: vv[r:r + 1] for kk, vv in v.items()}
                         if isinstance(v, dict) else
                         (v[r:r + 1] if v.ndim else v))
                     for k, v in batch.items()}, dev)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
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
    mma = sass_mma_counts()
    print(json.dumps({"sass_tf32_mma": mma}), flush=True)
    no_mma = [k for lib in mma.values() for k, n in lib["kernels"].items()
              if "_tc" in k and n == 0]
    if not all(lib["kernels"] for lib in mma.values()) or no_mma:
        raise AssertionError(f"3D-conv kernels without TF32 MMAs: {no_mma}"
                             f" of {mma}")

    # 3. kernels against their plain versions
    scene = plane_scene(H, W, V, SEED)
    samples = dtu_samples(scene, NDEPTH)
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model = model.cuda().eval()
    dev = torch.device("cuda")
    ledger = Ledger(make_timer(dev), split=lambda fn: split_times(fn, dev))
    with torch.no_grad():
        phase_kernels(model, samples, scene, ledger, dev)
        phase_wide_kernels(ledger, dev, dw_cases=())
    torch.cuda.empty_cache()

    # 4. eval main path
    eval_out = []
    main_path = phase_main(model, samples, scene, dev, smi=smi,
                           keep=eval_out)
    dtu_sample = samples[0]
    torch.cuda.empty_cache()

    # 5. train kernels against their plain versions
    from rcmvsnet_tpu_torch.config import Config
    from rcmvsnet_tpu_torch.data.synthetic import batch_from_views
    from rcmvsnet_tpu_torch.train.state import make_models
    from rcmvsnet_tpu_torch.train.step import batch_to
    tscene = plane_scene(TH, TW, TV, SEED)
    batch = batch_to(batch_from_views([tscene], NDEPTH, SEED), dev)
    torch.manual_seed(SEED)
    render = make_models(Config(), TV)[1].to(dev)
    with torch.no_grad():
        phase_train_kernels(model, render, batch, tscene, ledger, dev)
        phase_wide_kernels(ledger, dev, tail_cases=())
    del render
    torch.cuda.empty_cache()

    # 6. train main path
    train_path = phase_train(batch, load_state_dict(ASSET), smi, dev)
    torch.cuda.empty_cache()

    # 7. Tanks & Temples eval path
    tanks_path = phase_tanks(model, dev, smi)
    torch.cuda.empty_cache()

    # 8. profiling tools, and K9 / K10 against their plain versions
    from rcmvsnet_tpu_torch.tools.profile_conv3d import CASES
    with torch.no_grad():
        tools_path = phase_tools(model, dtu_sample, dev, CASES)
        phase_tools_kernels(model, dtu_sample, ledger, dev, CASES)

    # 9. the train CLI's loop: train, validate, save, restore, resume
    import shutil
    cli_dir = ROOT / "chiprun_out" / "train_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    train_cli = phase_train_cli(dtu_sample, smi, dev, cli_dir)
    shutil.rmtree(cli_dir)
    torch.cuda.empty_cache()

    # 10. the configurations the repaired kernels serve, end to end
    wide_path = phase_wide_paths(samples, scene, batch, smi, dev)
    torch.cuda.empty_cache()

    # 11. data parallelism: one rank over NCCL, two ranks on this card
    from rcmvsnet_tpu_torch.train.step import draw_step
    draws1 = draw_step(torch.Generator(device=dev).manual_seed(SEED),
                       Config(), 1, TH, TW)
    batch2 = batch_from_views([tscene, plane_scene(TH, TW, TV, SEED + 1)],
                              NDEPTH, SEED)
    draws2 = draw_step(torch.Generator().manual_seed(SEED), Config(), 2,
                       TH, TW)
    dp_dir = ROOT / "chiprun_out" / "parallel"
    shutil.rmtree(dp_dir, ignore_errors=True)
    dp_dir.mkdir(parents=True)
    parallel = phase_parallel(batch, draws1, batch2, draws2,
                              load_state_dict(ASSET), train_path, eval_out,
                              smi, dev, dp_dir)
    shutil.rmtree(dp_dir)
    del batch, samples
    torch.cuda.empty_cache()

    # 12. report
    source = "rcmvsnet_tpu_torch/ops/"
    meta = [
        ("warp_variance", "eval", "cuda", source + "csrc/warp_variance.cu",
         "rcmvsnet_tpu/ops/pallas_warp2.py:393"),
        ("conv3d", "eval", "cuda", source + "csrc/conv3d.cu",
         "rcmvsnet_tpu/ops/pallas_costreg.py:383 + "
         "rcmvsnet_tpu/ops/pallas_resample.py:59,117"),
        ("depth_tail", "eval", "cuda", source + "csrc/depth_tail.cu",
         "rcmvsnet_tpu/ops/pallas_tail.py:133"),
        ("conv2d", "eval", "cuda", source + "csrc/conv2d.cu",
         "rcmvsnet_tpu/ops/pallas_conv2d.py:306"),
        ("warp_variance_bwd", "train", "cuda",
         source + "csrc/warp_variance.cu",
         "rcmvsnet_tpu/ops/pallas_warp_train.py:306 (bwd :108, :374)"),
        ("warp_volume", "train", "cuda", source + "csrc/warp_volume.cu",
         "rcmvsnet_tpu/ops/pallas_warp_volume.py:263 (fwd :101, :340)"),
        ("warp_volume_bwd", "train", "cuda", source + "csrc/warp_volume.cu",
         "rcmvsnet_tpu/ops/pallas_warp_volume.py:263 (bwd :178, :406)"),
        ("conv3d_dw", "train", "cuda", source + "csrc/conv3d_dw.cu",
         "rcmvsnet_tpu/ops/pallas_costreg_train.py:81 (dw :163, :258)"),
        ("conv3d_lanewise", "tools", "cuda", source + "csrc/conv3d.cu",
         "rcmvsnet_tpu/ops/pallas_conv3d.py:167 (pallas_call :139)"),
        ("warp_view", "tools", "cuda", source + "csrc/warp_view.cu",
         "rcmvsnet_tpu/ops/pallas_warp.py:88 (pallas_call :109)"),
    ]
    paths = {"eval": main_path, "train": train_path, "tools": tools_path}
    kernels = []
    for name, phase, route, src, replaces in meta:
        s = ledger.summary(name, phase)
        path = paths[phase]
        row = {"name": name, "route": route, "source": src,
               "replaces": replaces, "launches": path["launches"][name],
               "max_abs_err": s["max_abs_err"], "ms": s["ms"],
               "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
               "bound_by": s["bound_by"], "library_ms": s["library_ms"],
               "calls_timed": s["calls"], "shapes": phase}
        if name in TC_KERNELS:
            row.update(bound_tc_ms=s["bound_tc_ms"],
                       bound_tc_by=s["bound_tc_by"])
        if "library_unfused_ms" in s:
            row["library_unfused_ms"] = s["library_unfused_ms"]
        if "repeats_bit_for_bit" in s:
            row["repeats_bit_for_bit"] = s["repeats_bit_for_bit"]
        if "device_ms" in s:
            row.update(device_ms=s["device_ms"], host_ms=s["host_ms"])
        if name in TRAIN_KERNELS and phase == "eval":
            t = ledger.summary(name, "train")
            row["train"] = {"launches": train_path["launches"][name],
                            **{k: t[k] for k in (
                                "max_abs_err", "ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by",
                                "bound_tc_ms", "bound_tc_by") if k in t},
                            "calls_timed": t["calls"]}
        kernels.append(row)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "build_s": build_s, "nvcc": logs,
        "sass_tf32_mma": mma,
        "calls": ledger.rows, "main_path": main_path,
        "train_path": train_path, "tanks_path": tanks_path,
        "tools_path": tools_path, "train_cli": train_cli,
        "wide_path": wide_path, "parallel": parallel,
        "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
