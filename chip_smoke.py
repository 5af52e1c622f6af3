#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rcmvsnet_tpu_torch) on one card.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero without
the final "ok" line):
  1. device   require CUDA, print the card's name and power limit, TF32 off;
  2. build    compile the twelve CUDA sources (sm_90a, one nvcc each, in
              parallel) and print the build seconds; count the tensor-core
              MMAs that `cuobjdump -sass` finds in each tensor-core kernel
              (a "_tc" in its name) of K2/K9, K8 dw and K5 and of
              K2-bf16, K8dw-bf16 and K5-bf16 (mma.sync's HMMA and wgmma's
              HGMMA alike): TF32 ones in each float32 kernel and bf16
              ones in each bf16 kernel, which must be > 0, with no bf16
              one in a float32 kernel and no TF32 one in a bf16 kernel;
              K5-bf16's tensor-core kernels (`conv2d_bf16.cu`) with
              HMMA.16816 or, at 8-channel chunks, HMMA.1688 (both kinds
              built) and no 16-bit shared load, none left in `conv2d.cu`;
              count each bf16 warp kernel's global loads by width: K1-bf16
              and K6-bf16 (`warp_variance_bf16.cu`) at every C, gathering
              in 16- and 8-byte loads, none left in `warp_variance.cu`;
              K7-bf16 and K7bwd-bf16 (`warp_volume_bf16.cu`) at every C,
              gathering in 16- and 8-byte loads, no bf16 function left in
              `warp_volume.cu`;
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
              backward, one Adam step; the default config, so remat at both
              levels: phase 15 prints the steps/s and peak without remat
              beside this phase's) at 512x640, V=4, 192 planes, 1024
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
              inputs, under remat (as phase 6) and without: phase 6's
              kernel step-1 metrics in every bit, each, and
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
 12. bf16     the bf16 eval path (eval_dtype bfloat16): phase 3 again
              with the bf16 instances of K5 (every call), K1-bf16 (3
              stages; `warp_variance_bf16.cu`) and K2 (every mode of the
              3 U-Nets, the prob head writing float32), each against its
              bf16 plain version to one bf16 ulp of each element plus
              1e-4 of the largest value (rows
              "<kernel>_bf16", phase "bf16"; library: cuDNN on bf16
              tensors with the same folded weights); then `infer_views`
              at bf16 over phase 4's DTU views and phase 7's T&T views
              through the kernels (every bf16 instance and K4 launched
              once per call of the path, 12 + 3 + 33 + 3 a map, so no
              plain version ran there; no float32 instance of K5, K1 or
              K2; phases 4, 7 and 10 in turn bar the bf16 instances) and the plain versions (no
              pixel beyond 0.01 relative), and against the float32 kernel
              path's depth (at most 1e-3 of pixels beyond 0.01: the fused
              TPU path's budget); prints max, mean, p99 and p999 of the
              relative deltas and both dtypes' maps/s and peak memory;
 13. report   one {"kernels": [...]} JSON line (ten kernels, the three
              bf16 eval instances and the four bf16 train instances), the
              nvidia-smi line, and the final {"ok": true, "device": {...}}
              line.
 14. bf16 train  (run before the report) the bf16 train path
              (train_dtype bfloat16 for the backbone and the render
              U-Net) at phase 6's cell: (a) phase
              5 again with the bf16 instances (rows "<kernel>_bf16", phase
              "bf16_train": K1-bf16 and K6-bf16 (`warp_variance_bf16.cu`)
              at the 3 stages, K7 forward and
              backward at stage 1, K2 in its train modes and K8 dw for
              every conv of the 3 CostRegNets and the render U-Net), each
              against its bf16 plain version to one bf16 ulp of each
              element + 1e-4 of the largest value (dw, float32 out: 1e-4
              of the largest), K6-bf16 and K7's bf16 backward twice, bit
              for bit; library: cuDNN on bf16 tensors for K2 and dw, none
              for the warps; (b) the bf16 train step, 2 warm-up and 5 timed
              steps through the kernels then the bf16 plain versions:
              every bf16 train instance launched, no float32 instance of
              K1, K2, K6, K7 or K8 dw; step-1 losses within
              BF16_STEP_LOSS_RTOL, each network's gradients within its
              BF16_GRAD_NET_TOL in relative L2;
              parameters, BN buffers and Adam's moments float32; (c) the
              first five steps of the bf16 kernel step against phase 6's
              float32 kernel step (same init and draws), each logged loss
              within BF16_VS_F32 (the JAX package's own budget); (d) steps/s
              and peak memory of both dtypes;
 15. remat    (run before the report) rematerialization (`RunConfig.
              remat` / `remat_modules`, `nn/remat.py`) at phase 6's cell
              and draws, through the kernels, in float32 and in bf16,
              under cudnn.deterministic: the step without remat, with
              pass-level remat only and with both levels, 2 compared steps
              each (then 2 timed), and two more runs without remat for the
              step's own spread: (a, b) step-1 metrics, BatchNorm buffers
              after step 1 and num_batches_tracked after both steps equal
              in every bit; step-1 gradients equal in every bit in each
              network whose gradients repeat without remat, the others
              (behind grid_sampler_3d's atomic adds) within
              REMAT_NOISE_FACTOR × their spread; step 2's running
              statistics within REMAT_STEP2_BN_L2, its losses and
              gradients printed beside the spread; (c) launches
              per step: K1, K2 and K7's forward above their count without
              remat, K6, K7's backward and K8 dw at it; (d) steps/s and
              peak memory per setting, beside phase 6's;
 16. quality  (run before the report) the two end-to-end quality goldens
              (`tools/quality.py`: the supervised and the unsupervised
              backbone, each on its scene from `assets/golden_scenes.npz`,
              5 views at 128x160, 64 planes, then geometric-consistency
              fusion and the DTU metric against the exact GT cloud) through
              the float32 plain versions, the float32 kernels and the bf16
              kernels: each path within its golden's JAX test (bounds, and
              pins against tests/golden/e2e_quality*.json); each kernel
              path launches exactly K5 12, K1 3, K2 33 and K4 3 a map (the
              bf16 instances on the bf16 path), nothing else; prints the
              metrics, launches and the final-mask flip rate and acc / comp
              deltas against the float32 plain path;
Bounds use the published H100 SXM peaks: 3.35 TB/s of HBM and 67 TFLOP/s
of float32 outside the tensor cores (TF32 is off in PyTorch on this path);
the convs (K2, K5, K8 dw, K9), which run 3xTF32 on the tensor cores (K5
on its "tc" route), also get `bound_tc_ms`: bytes over HBM against 3 TF32
products per multiply-add over 495 TFLOP/s. The bf16 convs' bound and
`bound_tc_ms` count one bf16 product per multiply-add over 989 TFLOP/s,
and bytes at each tensor's own element size (2 for bf16). Per-call
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
BF16_FLOPS_PER_S = 989e12                   # bf16 tensor cores, dense
# the kernels that run 3xTF32 MMAs: three TF32 products per multiply-add
TC_KERNELS = ("conv3d", "conv3d_dw", "conv3d_lanewise", "conv2d")
# the bf16 instances of the bf16 eval path (phase 12); the convs among
# them run one bf16 MMA per multiply-add (K8 dw's bf16 instance too, phase
# 14)
BF16_KERNELS = ("conv2d_bf16", "warp_variance_bf16", "conv3d_bf16")
BF16_TC_KERNELS = ("conv2d_bf16", "conv3d_bf16", "conv3d_dw_bf16")
# held to one bf16 ulp of their plain versions: the bf16 instances with a
# bf16 output (K8 dw's bf16 instance writes float32: TOL["conv3d_dw_bf16"])
BF16_ULP_KERNELS = BF16_KERNELS + ("warp_variance_bwd_bf16",
                                   "warp_volume_bf16", "warp_volume_bwd_bf16")
# a bf16 instance against its bf16 plain version, per element: one bf16
# ulp of the plain value (2^-7 of its magnitude) plus BF16_ATOL of the
# largest; both sum in float32 in different orders and round once, so a
# result may land one ulp away
BF16_ULP, BF16_ATOL = 2.0 ** -7, 1e-4
# bf16 kernels against the float32 kernel path, end to end: at most this
# share of pixels beyond DEPTH_GATE (tests/test_parity_budget.py's budget
# for the fused bf16 TPU path against XLA float32)
BF16_SHARE = 1e-3
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
       "warp_view_route": (0.0, 1e-5), "conv3d_dw_bf16": (0.0, 1e-4)}
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
# The bf16 train step, kernels vs the bf16 plain versions, step-1 losses
# relative, each term: both round to bf16 at the same places, but sums in
# another order flip a rounding now and then
BF16_STEP_LOSS_RTOL = 2e-3
# The bf16 step's gradients, kernels vs plain, per network (relative L2
# over the network's gradients). Both round to bf16 at the same places, but
# each conv sums in another order, which flips a rounding now and then,
# and the flips multiply layer by layer and through the render losses.
# Limits: 1.25 × the largest of six seeds (`chip_train_probe.py --bf16`,
# NVIDIA H100 80GB HBM3, 700 W; seed SEED read 0.061, 0.0039, 0.015,
# 0.030, 0.017, 0.0079). They catch K8 dw scaled by 1.01 in the first
# U-Net and by 1.1 in three of the four; K6 or K7 scaled by 1.1 stays
# inside FeatureNet's limit (its gradient is mostly the render terms'),
# so those two rest on (a)'s per-call gates and repeat checks
BF16_GRAD_NET_TOL = {"feature.": 0.123, "cost_regularization.0.": 0.0053,
                     "cost_regularization.1.": 0.039,
                     "cost_regularization.2.": 0.11,
                     "render.MVSNet.": 0.080, "render.network_fn.": 0.0235}
NETWORKS = ("feature.", "cost_regularization.0.", "cost_regularization.1.",
            "cost_regularization.2.", "render.MVSNet.", "render.network_fn.")
# bf16 train step against the float32 one, each logged loss of the first
# five steps: |bf16 − f32| ≤ 0.05·|f32| + 1e-3 (the JAX package's own
# budget, tests/test_train_bf16.py:41-46)
BF16_VS_F32 = (0.05, 1e-3)
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


def bound_tc_ms(n_bytes: float, flops: float, kernel: str = "conv3d"):
    """bound_ms of a tensor-core kernel: 3 TF32 products per multiply-add
    (3xTF32), or one bf16 product (a bf16 instance)."""
    if kernel in BF16_TC_KERNELS:
        return bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    return bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S)


def op_rate(kernel: str) -> float:
    """The card's peak rate for the kind of operation a kernel issues: the
    bf16 tensor cores for a bf16 conv, else float32 outside them."""
    return BF16_FLOPS_PER_S if kernel in BF16_TC_KERNELS else F32_FLOPS_PER_S


# the libraries of the tensor-core convs: K2/K9, K8 dw, K5, K2-bf16,
# K8dw-bf16, K5-bf16
MMA_LIBS = ("conv3d", "conv3d_dw", "conv2d", "conv3d_bf16", "conv3d_dw_bf16",
            "conv2d_bf16")


def count_mma(sass: str) -> dict:
    """{"kernels": {kernel: {"tf32": n, "bf16": n}}, "example": one TF32
    MMA, "example_bf16": one bf16 MMA} of `cuobjdump -sass` text: the
    tensor-core instructions of each function, mma.sync (HMMA) and
    wgmma (HGMMA) alike, by operand type."""
    import re
    counts, name, example = {}, None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"tf32": 0, "bf16": 0}
            continue
        kind = ("tf32" if re.search(r"H(G)?MMA\.\S*TF32", line) else
                "bf16" if re.search(r"H(G)?MMA\.\S*BF16", line) else None)
        if name and kind:
            counts[name][kind] += 1
            example.setdefault(kind, " ".join(line.split()))
    return {"kernels": counts, "example": example.get("tf32"),
            "example_bf16": example.get("bf16")}


def sass_mma_counts() -> dict:
    """{library: count_mma(its SASS)} of the conv libraries (MMA_LIBS),
    from `cuobjdump -sass` of the built files (the CUDA toolkit's)."""
    from rcmvsnet_tpu_torch.ops import _build
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    return {lib: count_mma(subprocess.run(
        [tool, "-sass", str(_build._target(lib))], capture_output=True,
        text=True, check=True).stdout) for lib in MMA_LIBS}


# the library of K1-bf16 and K6-bf16 (phase 2's SASS check), the C widths
# of its instances, and the float32 library they left; K7-bf16 and
# K7bwd-bf16's library and the one they left
WARP_BF16_LIB, WARP_LIB, WARP_CHANNELS = ("warp_variance_bf16",
                                          "warp_variance", (8, 16, 32))
VOLUME_BF16_LIB, VOLUME_LIB = "warp_volume_bf16", "warp_volume"


def sass_loads(sass: str, op: str = "LDG") -> dict:
    """{function: {"128": n, "64": n, "32": n, "16": n}} of `cuobjdump
    -sass` text: each function's loads of one kind (LDG global, LDS
    shared) by width in bits (8-bit loads counted as 16)."""
    import re
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"128": 0, "64": 0, "32": 0, "16": 0}
            continue
        m = re.search(rf"\b{op}((?:\.[\w]+)*)\s", line)
        if name and m:
            mods = m.group(1).split(".")
            width = next((w for w in ("128", "64") if w in mods),
                         "16" if {"U16", "S16", "U8", "S8"} & set(mods)
                         else "32")
            counts[name][width] += 1
    return counts


def warp_bf16_faults(loads: dict) -> list:
    """Phase 2's rule on {library: sass_loads(its SASS)}: K1-bf16 and
    K6-bf16, K7-bf16 and K7bwd-bf16 in their own libraries, an instance of
    each at every C, K1-bf16 and K7-bf16 gathering in 16-byte loads (8
    channels a lane), K6-bf16 and K7bwd-bf16 in 8-byte ones (4 channels a
    lane), and no bf16 function left in the float32 libraries. Returns
    what breaks it."""
    faults = [k for lib in (WARP_LIB, VOLUME_LIB) for k in loads[lib]
              if "bfloat16" in k]
    for lib, kernel, width in (
            (WARP_BF16_LIB, "warp_variance_bf16_kernel", "128"),
            (WARP_BF16_LIB, "warp_variance_bwd_bf16_kernel", "64"),
            (VOLUME_BF16_LIB, "warp_volume_bf16_kernel", "128"),
            (VOLUME_BF16_LIB, "warp_volume_bwd_bf16_kernel", "64")):
        new = loads[lib]
        for c in WARP_CHANNELS:
            mine = [k for k in new if kernel in k and f"ILi{c}E" in k]
            if not mine or not all(new[k][width] for k in mine):
                faults.append(f"{kernel} C={c}: {mine}")
    return faults


def check_warp_bf16_sass() -> dict:
    """`warp_bf16_faults` of the built libraries' SASS (`cuobjdump`);
    returns each warp kernel's global loads by width."""
    from rcmvsnet_tpu_torch.ops import _build
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    loads = {lib: sass_loads(subprocess.run(
        [tool, "-sass", str(_build._target(lib))], capture_output=True,
        text=True, check=True).stdout)
        for lib in (WARP_BF16_LIB, WARP_LIB, VOLUME_BF16_LIB, VOLUME_LIB)}
    faults = warp_bf16_faults(loads)
    if faults:
        raise AssertionError(f"bf16 warp kernels' SASS: {faults} of {loads}")
    return {k: v for lib in loads.values() for k, v in lib.items()
            if "warp_variance" in k or "warp_volume" in k}


def k5_bf16_faults(sass: str, f32_sass: str) -> list:
    """Phase 2's rule on K5-bf16's library (`conv2d_bf16.cu`): every
    tensor-core kernel (`conv2d_bf16_tc`, `lateral_conv2d_bf16_tc`) runs
    bf16 m16n8k16 (HMMA.16816) or m16n8k8 (HMMA.1688) products, both kinds
    are built (8-channel chunks at Ci <= 8), and none reads shared memory
    16 bits at a time (its fragments are 8- and 4-byte loads); the float32
    library `conv2d.cu` holds no bf16 function. Returns what breaks it."""
    import re
    mma, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            mma[name] = {"16816": 0, "1688": 0}
            continue
        m = re.search(r"\bHMMA\.(16816|1688)\.F32\.BF16\b", line)
        if name and m:
            mma[name][m.group(1)] += 1
    lds = sass_loads(sass, "LDS")
    tc = [k for k in mma if "conv2d_bf16_tc" in k]
    faults = [f"{k}: {mma[k]}, LDS {lds[k]}" for k in tc
              if not (mma[k]["16816"] or mma[k]["1688"]) or lds[k]["16"]]
    for kind in ("16816", "1688"):
        if not any(mma[k][kind] for k in tc):
            faults.append(f"no K5-bf16 kernel with HMMA.{kind}")
    faults += [k for k in sass_loads(f32_sass) if "bfloat16" in k]
    return faults


def check_k5_bf16_sass() -> dict:
    """`k5_bf16_faults` of the built libraries' SASS (`cuobjdump`); returns
    each K5-bf16 tensor-core kernel's shared loads by width."""
    from rcmvsnet_tpu_torch.ops import _build
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = {lib: subprocess.run(
        [tool, "-sass", str(_build._target(lib))], capture_output=True,
        text=True, check=True).stdout for lib in ("conv2d_bf16", "conv2d")}
    faults = k5_bf16_faults(sass["conv2d_bf16"], sass["conv2d"])
    if faults:
        raise AssertionError(f"K5-bf16's SASS: {faults}")
    return {k: v for k, v in sass_loads(sass["conv2d_bf16"], "LDS").items()
            if "conv2d_bf16_tc" in k}


def missing_mma(mma: dict) -> list:
    """Tensor-core kernels (a "_tc" in the name) without their MMAs: a
    float32 one without TF32 MMAs or with bf16 ones, a bf16 one (its name
    carries __nv_bfloat16) without bf16 MMAs or with TF32 ones."""
    out = []
    for lib in mma.values():
        for k, n in lib["kernels"].items():
            own, other = ("bf16", "tf32") if "bfloat16" in k else ("tf32",
                                                                   "bf16")
            if "_tc" in k and (n[own] == 0 or n[other] > 0):
                out.append(k)
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
        err, scale, rel, over = 0.0, 0.0, 0.0, 0
        for a, p in pairs:
            if a.dtype != p.dtype:
                self.failures.append(f"{kernel} {label}: dtype {a.dtype} "
                                     f"vs the plain version's {p.dtype}")
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
            if kernel in BF16_ULP_KERNELS:
                over += int(((a - p).abs()
                             > BF16_ULP * p.abs() + BF16_ATOL * m).sum())
        b_ms, b_by = bound_ms(n_bytes, flops, op_rate(kernel))
        row = {"kernel": kernel, "phase": self.phase, "label": label,
               "shape": list(outs_p[0].shape), "dtype": str(outs_k[0].dtype),
               "max_abs_err": err, "max_rel_err": rel,
               "bytes": n_bytes, "flops": flops, "bound_ms": b_ms,
               "bound_by": b_by}
        if kernel in BF16_ULP_KERNELS:
            row["tol"] = (f"{BF16_ULP:.4g}·|plain| + {BF16_ATOL:g}·"
                          f"max|plain| per element")
            row["elements_over_tol"] = over
            if over or err == float("inf"):
                self.failures.append(f"{kernel} {label}: {over} elements "
                                     f"beyond {row['tol']} (max|Δ| "
                                     f"{err:.3e})")
        else:
            atol, rtol = TOL[kernel]
            row["tol"] = atol + rtol * scale
            if not err <= row["tol"]:
                self.failures.append(f"{kernel} {label}: max|Δ| {err:.3e} "
                                     f"> {row['tol']:.3e}")
        if kernel in TC_KERNELS + BF16_TC_KERNELS:
            row["bound_tc_ms"], row["bound_tc_by"] = bound_tc_ms(
                n_bytes, flops, kernel)
        if kernel == "depth_tail":
            flips = float(((outs_k[1] - outs_p[1]).abs() > CONF_TOL)
                          .float().mean())
            row["conf_share_above_tol"] = flips
            if flips > CONF_SHARE:
                self.failures.append(f"{kernel} {label}: confidence differs "
                                     f"on {flips:.2e} of pixels")
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
        t_f = sum(bound_ms(0, r["flops"], op_rate(kernel))[0] for r in rows)
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
        if kernel in TC_KERNELS + BF16_TC_KERNELS:
            t_f = sum(bound_tc_ms(0, r["flops"], kernel)[0] for r in rows)
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
    [N, H, W, Co] output in lat's element type; the 1x1 lateral conv and
    out3's 3x3 conv."""
    N, Cl, H, W = lat.shape
    Co, Cu = w.shape[:2]
    out_bytes = lat.element_size() * N * H * W * Co
    return (nbytes(up, lat, wi, bi, w) + out_bytes,
            2 * N * H * W * (Cu * Cl + Co * Cu * 9))


def phase_kernels(model, samples, scene, ledger, dev, dtype=None):
    """Phase 3: each kernel against its plain version at the main path's
    shapes, on realistic inputs (the plain path's own intermediates).
    dtype=torch.bfloat16 (phase 12): the bf16 instances of K5, K1 and K2
    on the bf16 path's inputs and weights, rows "<kernel>_bf16" (K4 is
    the float32 kernel there, held here in float32)."""
    import torch
    import torch.nn.functional as F
    from rcmvsnet_tpu_torch.core.geometry import compose_projection
    from rcmvsnet_tpu_torch.nn.layers import bn_scale_shift, fold_block
    from rcmvsnet_tpu_torch.ops import conv2d as K5
    from rcmvsnet_tpu_torch.ops import conv3d as K2
    from rcmvsnet_tpu_torch.ops import depth_tail as K4
    from rcmvsnet_tpu_torch.ops import warp_variance as K1

    bf16 = dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    # the weights as the eval path hands them to the kernels (bf16: rounded
    # once, BN's scale folded into the bf16-rounded conv weight first)
    cast = (lambda w: w.to(torch.bfloat16)) if bf16 else (lambda w: w)
    s0 = samples[0]
    x = torch.from_numpy(s0["imgs"]).to(dev).permute(0, 3, 1, 2).contiguous()
    x = x.to(dtype) if bf16 else x

    # K5: every call of the eval FeatureNet, 5 views at 864x1152
    fn = model.feature

    def k5(label, x, wgt, extra, fn_lib, **kw):
        y = K5.conv2d_plain(x, wgt, **kw)
        way = K5.route(wgt.shape[-1], kw.get("stride", 1),
                       kw.get("padding", 0), x.shape[1])
        return ledger.compare(
            "conv2d" + sfx, f"{label} {tuple(x.shape)}",
            lambda: K5.conv2d(x, wgt, **kw),
            lambda: K5.conv2d_plain(x, wgt, **kw),
            *conv2d_work(x, wgt, y, *extra), fn_lib=fn_lib,
            extra={"route": way})

    acts = []
    for si, seq in enumerate((fn.conv0, fn.conv1, fn.conv2)):
        for li, blk in enumerate(seq):
            sc, sh = bn_scale_shift(blk.bn)
            wgt = blk.conv.weight
            if bf16:
                wgt, sc = cast(cast(wgt) * sc[:, None, None, None]), None
            kw = dict(scale=sc, shift=sh, stride=blk.conv.stride[0],
                      padding=blk.conv.padding[0], relu=True)
            x = k5(f"conv{si}.{li}", x, wgt, [t for t in (sc, sh)
                                               if t is not None],
                   lambda x=x, kw=kw, w=wgt: F.conv2d(
                       x, w, stride=kw["stride"], padding=kw["padding"]),
                   **kw)
        acts.append(x)
    conv0, conv1, intra = acts
    w_out1, w_in1, w_out2 = (cast(fn.out1.weight), cast(fn.inner1.weight),
                             cast(fn.out2.weight))
    feats = {"stage1": k5("out1 warp", intra, w_out1, (),
                          lambda: F.conv2d(intra, w_out1),
                          out_layout="warp")}
    b_in1 = fn.inner1.bias
    intra = k5("inner1+up", conv1, w_in1, (b_in1, intra),
               lambda: F.conv2d(conv1, w_in1, cast(b_in1)),
               shift=b_in1, up=intra)
    feats["stage2"] = k5("out2 warp", intra, w_out2, (),
                         lambda: F.conv2d(intra, w_out2, padding=1),
                         padding=1, out_layout="warp")
    # stage 3's lateral head against its plain composition; no one PyTorch
    # call fuses the two convs: the row's "library_unfused_ms" times the
    # two cuDNN calls of the unfused head (inner2 1x1 with bias, then out3
    # on the sum as the plain path writes it)
    w_in2, w_out3 = cast(fn.inner2.weight), cast(fn.out3.weight)
    lat = (intra, conv0, w_in2, fn.inner2.bias, w_out3)
    s3 = K5.conv2d_plain(conv0, w_in2, shift=fn.inner2.bias, up=intra)
    feats["stage3"] = ledger.compare(
        "conv2d" + sfx, f"out3 lateral warp {tuple(conv0.shape)} up "
        f"{tuple(intra.shape)}",
        lambda: K5.lateral_conv2d(*lat, out_layout="warp"),
        lambda: K5.lateral_conv2d_plain(*lat, out_layout="warp"),
        *lateral_work(*lat),
        extra={"route": "lateral", "library_unfused_ms": ledger.timer(
            lambda: (F.conv2d(conv0, w_in2, cast(fn.inner2.bias)),
                     F.conv2d(s3, w_out3, padding=1)))})
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
            "warp_variance" + sfx, f"{key} V{Vn} {h}x{w} C{C} D{nd}",
            lambda: K1.warp_variance(f, projs, lo, step, nd),
            lambda: K1.warp_variance_plain(f, projs, lo, step, nd),
            nbytes(f, projs, lo, step) + f.element_size() * C * nd * h * w,
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
            wgt = cast(wgt)
            sk = saved.get(skip)
            y = K2.conv3d_plain(t, wgt, b, mode, skip=sk)
            t = ledger.compare(
                "conv3d" + sfx, f"{key} {name} {mode} {tuple(t.shape)}",
                lambda t=t, wgt=wgt, b=b, mode=mode, sk=sk: K2.conv3d(
                    t, wgt, b, mode, skip=sk),
                lambda t=t, wgt=wgt, b=b, mode=mode, sk=sk: K2.conv3d_plain(
                    t, wgt, b, mode, skip=sk),
                *conv3d_work(t, wgt, y, mode, (b, sk)),
                fn_lib=lambda t=t, wgt=wgt, b=b, mode=mode: library_conv3d(
                    t, wgt, cast(b), mode))
            saved[name] = t
        zero = torch.zeros(1, device=dev)
        w_prob = cast(cr.prob.weight)
        prob = dict(relu=False, out_dtype=torch.float32)
        y = K2.conv3d_plain(t, w_prob, zero, "s1", **prob)
        cost = ledger.compare(
            "conv3d" + sfx, f"{key} prob s1 {tuple(t.shape)}",
            lambda: K2.conv3d(t, w_prob, zero, "s1", **prob),
            lambda: K2.conv3d_plain(t, w_prob, zero, "s1", **prob),
            *conv3d_work(t, w_prob, y, "s1"),
            fn_lib=lambda: library_conv3d(t, w_prob, cast(zero), "s1"))
        del saved, t, var
        c = cost[0, 0].contiguous()
        if not bf16:
            ledger.compare("depth_tail", f"{key} D{nd} {h}x{w}",
                           lambda: K4.depth_tail(c, lo, step),
                           lambda: K4.depth_tail_plain(c, lo, step),
                           nbytes(c, lo, step) + 8 * h * w, 12 * nd * h * w)
    sync(dev)
    ledger.check("bf16 eval kernels" if bf16 else "eval kernels")


def library_conv3d(x, w, b, mode):
    """One cuDNN call for the same 3D conv (TF32 off)."""
    import torch.nn.functional as F
    if mode == "t2":
        return F.conv_transpose3d(x, w, b, stride=2, padding=1,
                                  output_padding=1)
    return F.conv3d(x, w, b, stride=1 if mode == "s1" else 2, padding=1)


EVAL_KERNELS = ("warp_variance", "conv3d", "depth_tail", "conv2d")
# the bf16 eval path: K5, K1 and K2's bf16 instances and K4; none of the
# three's float32 instances may run on it, and no bf16 instance on the
# float32 path
BF16_EVAL_KERNELS = BF16_KERNELS + ("depth_tail",)
F32_ONLY = ("warp_variance", "conv3d", "conv2d")
# one depth map's calls of each on the bf16 path (12 FeatureNet calls, one
# warp, 11 U-Net convs and one tail per stage): launches of exactly this
# many a map show that no call of the path ran a plain version
BF16_LAUNCHES_PER_MAP = {"conv2d_bf16": 12, "warp_variance_bf16": 3,
                         "conv3d_bf16": 33, "depth_tail": 3}
TRAIN_KERNELS = ("warp_variance", "conv3d", "warp_variance_bwd",
                 "warp_volume", "warp_volume_bwd", "conv3d_dw")
# the bf16 train path's instances of the same kernels (phase 14); neither
# path may launch the other's
BF16_TRAIN_KERNELS = tuple(f"{k}_bf16" for k in TRAIN_KERNELS)
TOOLS_KERNELS = EVAL_KERNELS + ("warp_view", "conv3d_lanewise")
# K9 at odd sizes, each mode (Ci=16, Co=8): (label, D, H, W, Ci, Co, mode)
ODD_CONV_CASES = tuple((f"odd 5x9x7 {m}", 5, 9, 7, 16, 8, m)
                       for m in ("s1", "s2", "t2"))


def kernel_wrappers():
    """{name: launch count} of every kernel instance: its wrapper, or for
    a bf16 instance the wrapper's `bf16` count; each `launches` counts
    that instance's launches."""
    from rcmvsnet_tpu_torch.ops import (conv2d, conv3d, conv3d_train,
                                        depth_tail, warp_variance,
                                        warp_view, warp_volume)
    return {"warp_variance": warp_variance.warp_variance,
            "conv3d": conv3d.conv3d, "depth_tail": depth_tail.depth_tail,
            "conv2d": conv2d.conv2d,
            "warp_variance_bf16": warp_variance.warp_variance.bf16,
            "conv3d_bf16": conv3d.conv3d.bf16,
            "conv2d_bf16": conv2d.conv2d.bf16,
            "warp_variance_bwd_bf16": warp_variance.warp_variance_bwd.bf16,
            "warp_volume_bf16": warp_volume.warp_volume.bf16,
            "warp_volume_bwd_bf16": warp_volume.warp_volume_bwd.bf16,
            "conv3d_dw_bf16": conv3d_train.conv3d_dw.bf16,
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
               keep=None, kernels=EVAL_KERNELS,
               barred=BF16_KERNELS + BF16_TRAIN_KERNELS,
               rel_max=DEPTH_REL_MAX):
    """Phases 4 and 7: an eval path, `infer_views` over every sample
    through the kernels, then through the plain versions. Every one of
    `kernels` must launch on the first, none of `barred` there and nothing
    on the second; depth must agree within the TPU path's budget (max
    relative delta `rel_max`, None: not gated; no pixel above DEPTH_GATE).
    keep: a list that receives the kernel path's (depth, confidence) per
    view."""
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
        missing = [k for k in kernels if runs[plain]["launches"][k] == 0]
        if not plain and missing:
            raise AssertionError(f"{name} never launched {missing}")
    wrong = {k: runs[False]["launches"][k] for k in barred
             if runs[False]["launches"][k]}
    if wrong:
        raise AssertionError(f"{name} launched instances of another dtype: "
                             f"{wrong}")
    if any(runs[True]["launches"].values()):
        raise AssertionError(f"{name}: the plain path launched kernels "
                             f"{runs[True]['launches']}")
    if keep is not None:
        keep.extend(runs[False]["out"])

    rel_all, n_gate, plane_err = [], 0, []
    hw = samples[0]["imgs"].shape[1:3]
    for i, ((dk, ck), (dp, cp)) in enumerate(zip(runs[False]["out"],
                                                  runs[True]["out"])):
        if dk.shape != hw or not np.isfinite(dk).all() \
                or not np.isfinite(ck).all():
            raise AssertionError(f"{name} view {i}: depth {dk.shape} not "
                                 f"finite {hw}")
        rel = np.abs(dk - dp) / np.abs(dp)
        rel_all.append(rel.ravel())
        n_gate += int((rel > DEPTH_GATE).sum())
        plane_err.append(float(np.median(np.abs(dk - scene["depths"][i]))))
    rel_all = np.concatenate(rel_all)
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
        "depth_max_rel_delta_vs_plain": float(rel_all.max()),
        "depth_rel_delta_vs_plain": depth_stats(rel_all),
        "depth_pixels_above_gate": n_gate,
        "median_abs_depth_err_vs_plane": plane_err,
    }
    print(json.dumps({name: result}), flush=True)
    if (rel_max is not None and rel_all.max() > rel_max) or n_gate:
        raise AssertionError(f"{name}, kernel vs plain depth: max rel "
                             f"{rel_all.max():.3e} (limit {rel_max}), "
                             f"{n_gate} pixels above {DEPTH_GATE}")
    return result


def depth_stats(rel) -> dict:
    """max, mean, p99 and p999 of per-pixel relative depth deltas, and the
    share of pixels beyond DEPTH_GATE."""
    import numpy as np
    return {"max": float(rel.max()), "mean": float(rel.mean()),
            "p99": float(np.quantile(rel, 0.99)),
            "p999": float(np.quantile(rel, 0.999)),
            "share_above_gate": float((rel > DEPTH_GATE).mean())}


def phase_tanks(model, dev, smi, shape=(TT_H, TT_W, TT_V), keep=None,
                name="tanks_path", **gates):
    """Phase 7: the eval path at Tanks & Temples' input, with the T&T
    loader's depth range."""
    scene = plane_scene(*shape, SEED)
    return phase_main(model, tanks_samples(scene, NDEPTH), scene, dev,
                      name, smi, keep, **gates)


def phase_bf16(model, samples, scene, ref_dtu, ref_tanks, f32_paths, smi,
               dev, tanks_shape=(TT_H, TT_W, TT_V)):
    """Phase 12, end to end: `infer_views` with eval_dtype bfloat16 over
    phase 4's DTU views and phase 7's T&T views, through the bf16 kernels
    (every bf16 instance and K4 launched, no float32 instance of K5, K1 or
    K2) and through the bf16 plain versions (no pixel beyond DEPTH_GATE);
    then against the float32 kernel path's depth (ref_dtu, ref_tanks: its
    (depth, confidence) per view): at most BF16_SHARE of pixels beyond
    DEPTH_GATE. Prints both dtypes' maps/s and peak memory (f32_paths:
    phases 4 and 7's results)."""
    import numpy as np
    from rcmvsnet_tpu_torch.config import BackboneConfig
    from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
    bf = CascadeMVSNet(BackboneConfig(eval_dtype="bfloat16"))
    bf.load_state_dict(model.state_dict(), strict=True)
    bf = bf.to(dev).eval()
    gates = dict(kernels=BF16_EVAL_KERNELS, barred=F32_ONLY, rel_max=None)
    out, results = {}, {}
    for name, run, ref, f32 in (
            ("dtu", lambda keep: phase_main(
                bf, samples, scene, dev, "bf16_dtu_path", smi, keep,
                **gates), ref_dtu, f32_paths[0]),
            ("tanks", lambda keep: phase_tanks(
                bf, dev, smi, tanks_shape, keep, "bf16_tanks_path",
                **gates), ref_tanks, f32_paths[1])):
        keep = []
        res = run(keep)
        rel = np.concatenate([(np.abs(db - d32) / np.abs(d32)).ravel()
                              for (db, _), (d32, _) in zip(keep, ref)])
        res["depth_rel_delta_vs_float32_kernels"] = depth_stats(rel)
        res["float32"] = {k: f32[k] for k in (
            "depth_maps_per_s_kernel", "depth_maps_per_s_plain",
            "max_memory_allocated_kernel", "max_memory_allocated_plain")}
        results[name] = res
        out[name] = {"vs_float32_kernels": depth_stats(rel),
                     "maps_per_s": {"bf16": res["depth_maps_per_s_kernel"],
                                    "float32": f32["depth_maps_per_s_kernel"]},
                     "peak_bytes": {
                         "bf16": res["max_memory_allocated_kernel"],
                         "float32": f32["max_memory_allocated_kernel"]}}
    print(json.dumps({"bf16_paths": {"device": smi, **out}}), flush=True)
    for name, res in results.items():
        per_map = {k: res["launches_per_map"].get(k, 0)
                   for k in BF16_LAUNCHES_PER_MAP}
        if per_map != BF16_LAUNCHES_PER_MAP:
            raise AssertionError(f"bf16 {name}: launches a map {per_map}, "
                                 f"not one per call {BF16_LAUNCHES_PER_MAP}")
        share = res["depth_rel_delta_vs_float32_kernels"]["share_above_gate"]
        if share > BF16_SHARE:
            raise AssertionError(f"bf16 {name}: {share:.2e} of pixels beyond "
                                 f"{DEPTH_GATE} against the float32 kernel "
                                 f"path (limit {BF16_SHARE})")
    return results


# phase 16: the quality goldens (tools/quality.py) and their committed
# results; the paths as (name, eval dtype, plain), the float32 plain path
# first: the others' flip rates and deltas are taken against it
QUALITY_GOLDENS = ("sup", "unsup")
QUALITY_JSON = {"sup": "e2e_quality.json", "unsup": "e2e_quality_unsup.json"}
QUALITY_PATHS = (("float32_plain", "float32", True),
                 ("float32_kernels", "float32", False),
                 ("bf16_kernels", "bfloat16", False))
# launches a depth map on each kernel path, exactly (every other count 0)
QUALITY_LAUNCHES_PER_MAP = {
    "float32": {"conv2d": 12, "warp_variance": 3, "conv3d": 33,
                "depth_tail": 3},
    "bfloat16": BF16_LAUNCHES_PER_MAP}


def quality_delta(res: dict, ref: dict) -> dict:
    """One path against the float32 plain path, as `PARITY_data.json` holds
    the bf16 TPU path against XLA float32: the share of final-mask pixels
    that differ, and the acc / comp deltas."""
    m, r = res["metrics"], ref["metrics"]
    return {"final_mask_flip_rate": float((res["masks"] != ref["masks"])
                                          .mean()),
            "acc_delta": m["acc_mean"] - r["acc_mean"],
            "comp_delta": m["comp_mean"] - r["comp_mean"],
            "overall_rel_delta": (m["acc_mean"] + m["comp_mean"])
            / (r["acc_mean"] + r["comp_mean"]) - 1.0}


def phase_quality(smi, dev, goldens=QUALITY_GOLDENS, paths=QUALITY_PATHS):
    """Phase 16: each quality golden (`tools/quality.run`: its 5 views at
    128x160, 64 planes, through `infer_views`, fusion and the DTU metric)
    on each path. Every path is held to its golden's JAX test
    (`tools/quality.check`: the bounds, and the pins against the committed
    JSON under tests/golden/); each kernel path launches exactly
    QUALITY_LAUNCHES_PER_MAP for its dtype and nothing else, the plain path
    nothing. Prints every path's metrics, launches and seconds, and its
    final-mask flip rate and acc / comp deltas against the first path."""
    from rcmvsnet_tpu_torch.tools import quality
    pinned = {g: json.loads((ROOT / "tests" / "golden" / f).read_text())
              for g, f in QUALITY_JSON.items()}
    results, failures = {}, []
    for golden in goldens:
        ref = None
        for name, dtype, plain in paths:
            wrappers = zero_launches()
            sync(dev)
            t0 = time.perf_counter()
            res = quality.run(golden, dev, dtype, plain)
            sync(dev)
            seconds = time.perf_counter() - t0
            n = len(res["maps"])
            got = {k: fn.launches for k, fn in wrappers.items()
                   if fn.launches}
            want = {} if plain else {
                k: v * n for k, v in QUALITY_LAUNCHES_PER_MAP[dtype].items()}
            if got != want:
                failures.append(f"{golden} {name}: launches {got}, not "
                                f"{want}")
            failures += [f"{golden} {name}: {msg}" for msg in quality.check(
                golden, res["metrics"], pinned[golden], pinned["sup"])]
            ref = ref or res
            results.setdefault(golden, {})[name] = {
                "metrics": res["metrics"], "launches": got,
                "seconds": seconds,
                "vs_float32_plain": quality_delta(res, ref)}
    print(json.dumps({"quality": {"device": smi, **results}}), flush=True)
    if failures:
        raise AssertionError("quality: " + "; ".join(failures))
    return results


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



def phase_train_kernels(cascade, render, batch, scene, ledger, dev,
                        dtype=None):
    """Phase 5: the train kernels against their plain versions at the
    train shapes, forward and backward from fixed random cotangents.
    dtype=torch.bfloat16 (phase 14): their bf16 instances on the same
    inputs and cotangents rounded to bf16 (rows "<kernel>_bf16", phase
    "bf16_train"; the prob head's cotangent float32, as the train step
    hands it over, rounded by K8 before its dx and dw)."""
    import torch
    from rcmvsnet_tpu_torch.nn.costreg import TRUNK, conv_bn
    from rcmvsnet_tpu_torch.ops import conv3d as K2
    from rcmvsnet_tpu_torch.ops import conv3d_train as K8
    from rcmvsnet_tpu_torch.ops import warp_variance as K1
    from rcmvsnet_tpu_torch.ops import warp_volume as K7
    from rcmvsnet_tpu_torch.ops.sampling import resize_bilinear
    from rcmvsnet_tpu_torch.tools.repeat_warp_bwd import train_stages

    bf16 = dtype == torch.bfloat16
    ledger.phase = "bf16_train" if bf16 else "train"
    sfx = "_bf16" if bf16 else ""
    cast = (lambda t: t.to(torch.bfloat16)) if bf16 else (lambda t: t)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda *shape: cast(torch.randn(*shape, generator=gen,
                                           device=dev))
    imgs = batch["imgs"][0]                                   # [V,H,W,3]
    Hs, Ws = imgs.shape[1:3]
    unets = []
    for s, (key, f, projs, lo, step, nd) in enumerate(
            train_stages(cascade, batch, scene, rand)):
        f = cast(f)
        Vn, h, w, C = f.shape
        tag = f"{key} V{Vn} {h}x{w} C{C} D{nd}"
        ledger.compare(
            "warp_variance" + sfx, tag,
            lambda: K1.warp_variance(f, projs, lo, step, nd),
            lambda: K1.warp_variance_plain(f, projs, lo, step, nd),
            nbytes(f, projs, lo, step) + f.element_size() * C * nd * h * w,
            warp_flops(Vn, h, w, C, nd))
        g = rand(C, nd, h, w)
        ledger.compare(
            "warp_variance_bwd" + sfx, tag,
            lambda: K1.warp_variance_bwd(f, projs, lo, step, g),
            lambda: K1.warp_variance_bwd_plain(f, projs, lo, step, g),
            2 * nbytes(f) + nbytes(projs, lo, step, g),
            warp_flops(Vn, h, w, C, nd, bwd=True), repeat=True,
            extra=tap_runs(projs, lo, step, nd, C))
        if s == 0:
            im = cast(resize_bilinear(imgs, h, w).contiguous())
            ledger.compare(
                "warp_volume" + sfx, tag,
                lambda: K7.warp_volume(f, im, projs, lo, step, nd),
                lambda: K7.warp_volume_plain(f, im, projs, lo, step, nd),
                nbytes(f, im, projs, lo, step)
                + f.element_size() * (2 * C + 3 * (Vn - 1)) * nd * h * w,
                warp_flops(Vn, h, w, C, nd, images=3))
            # var's cotangent, then the render volume's (images, no-ref)
            cots = (g, rand(3 * (Vn - 1) + C, nd, h, w))
            ledger.compare(
                "warp_volume_bwd" + sfx, tag,
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
            prob = bf16 and name == "prob"
            out = torch.float32 if prob else None
            x = rand(1, cin, d, h, w)
            g = cast(torch.randn(1, *cur, generator=gen, device=dev))
            wgt = cast(wgt)
            adj_w = K8._adjoint_weight(wgt, mode)
            adj = K8.ADJOINT[mode]
            zo, zi = torch.zeros(co, device=dev), torch.zeros(cin, device=dev)
            tag = f"{net_name} {name} {mode} {tuple(x.shape)}"
            y = K2.conv3d_plain(x, wgt, None, mode, relu=False,
                                out_dtype=out)
            ledger.compare(
                "conv3d" + sfx, f"train fwd {tag}",
                lambda: K2.conv3d(x, wgt, zo, mode, relu=False,
                                  out_dtype=out),
                lambda: K2.conv3d_plain(x, wgt, None, mode, relu=False,
                                        out_dtype=out),
                *conv3d_work(x, wgt, y, mode),
                fn_lib=lambda: library_conv3d(x, wgt, None, mode))
            ledger.compare(
                "conv3d" + sfx, f"train dx {tag}",
                lambda: K2.conv3d(g, adj_w, zi, adj, relu=False),
                lambda: K2.conv3d_plain(g, adj_w, None, adj, relu=False),
                *conv3d_work(g, adj_w, x, adj),
                fn_lib=lambda: library_conv3d(g, adj_w, None, adj))
            _, flops = conv3d_work(x, wgt, y, mode)
            ledger.compare(
                "conv3d_dw" + sfx, tag,
                lambda: K8.conv3d_dw(x, g, mode),
                lambda: K8.conv3d_dw_plain(x, g, mode),
                nbytes(x, g) + 4 * wgt.numel(), flops,
                fn_lib=lambda: library_conv3d_dw(x, g, wgt, mode))
            del x, g, y
    sync(dev)
    ledger.check("bf16 train kernels" if bf16 else "train kernels")


def library_conv3d_dw(x, g, w, mode):
    """One cuDNN call for the same weight gradient (TF32 off)."""
    import torch
    t2 = mode == "t2"
    s = 1 if mode == "s1" else 2
    return torch.ops.aten.convolution_backward(
        g, x, w, None, [s] * 3, [1] * 3, [1] * 3, t2, [1 if t2 else 0] * 3,
        1, [False, True, False])[1]


LOSS_TERMS = ("loss", "repr_loss", "aug_loss", "img_loss", "ray_depth_loss")


def _float32_state(state) -> list:
    """Names of the floating-point parameters, buffers and Adam moments of
    a train state that are not float32."""
    import torch
    return [n for n, t in _state_tensors(state).items()
            if t.dtype.is_floating_point and t.dtype != torch.float32]


def phase_train(batch, cascade_sd, smi, dev, cfg=None, warmup=2, timed=5):
    """Phase 6: the fused train step, kernels then plain versions, from
    one init and one batch with the draws fixed once. With the train
    dtypes bfloat16 in cfg (phase 14 (b)) the bf16 step: its bf16
    instances must launch and no float32 instance of the train kernels
    (and the reverse at float32), step-1 losses within
    BF16_STEP_LOSS_RTOL, and the state float32 after the steps. The
    result keeps every step's loss terms ("step_losses_kernel")."""
    import torch
    from rcmvsnet_tpu_torch.config import Config
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import draw_step, make_train_step
    cfg = cfg or Config()
    bf16 = cfg.backbone.train_dtype == "bfloat16"
    wanted, barred = ((BF16_TRAIN_KERNELS, TRAIN_KERNELS) if bf16
                      else (TRAIN_KERNELS, BF16_TRAIN_KERNELS))
    name = "bf16_train_path" if bf16 else "train_path"
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
        losses = [{n: first[n] for n in LOSS_TERMS}]
        later = []
        for _ in range(warmup - 1):
            later.append(step(state, batch, draws))
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(timed):
            last = step(state, batch, draws)
            later.append(last)
        sync(dev)
        dt = time.perf_counter() - t0
        losses += [{n: float(m[n]) for n in LOSS_TERMS} for m in later]
        paths["plain" if plain else "kernel"] = {
            "first": first, "grads": grads, "steps_per_s": timed / dt,
            "last_loss": float(last["loss"]), "step_losses": losses,
            "not_float32": _float32_state(state),
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

    def net_l2(a, b):
        """{network: ‖a − b‖₂ / ‖b‖₂ over its gradients}."""
        out = {}
        for net in NETWORKS:
            names = [n for n in b if n.startswith(net)]
            d = sum(float((a[n] - b[n]).norm()) ** 2 for n in names)
            r = sum(float(b[n].norm()) ** 2 for n in names)
            out[net] = (d / max(r, 1e-60)) ** 0.5
        return out
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
            p["last_loss"], "step_losses_kernel": k["step_losses"]}
    if bf16:
        result["grad_l2_per_network"] = net_l2(k["grads"], p["grads"])
    print(json.dumps({name: result}), flush=True)
    what = name.replace("_", " ")
    missing = [n for n in wanted if k["launches"][n] == 0]
    if missing:
        raise AssertionError(f"{what} never launched {missing}")
    wrong = {n: k["launches"][n] for n in barred if k["launches"][n]}
    if wrong:
        raise AssertionError(f"{what} launched the other dtype's "
                             f"instances {wrong}")
    if any(p["launches"].values()):
        raise AssertionError(f"plain {what} launched kernels: "
                             f"{p['launches']}")
    tol = BF16_STEP_LOSS_RTOL if bf16 else LOSS_RTOL
    bad = {n: rel[n] for n in LOSS_TERMS if not rel[n] <= tol}
    if bad or not all(map(lambda v: v == v, k["first"].values())):
        raise AssertionError(f"{what} step-1 losses kernel vs plain: {bad}")
    if bf16:
        over = {n: v for n, v in result["grad_l2_per_network"].items()
                if not v <= BF16_GRAD_NET_TOL[n]}
        if over:
            raise AssertionError(f"{what} gradients kernel vs plain, per "
                                 f"network: {over} (limits "
                                 f"{BF16_GRAD_NET_TOL})")
    elif not max(grad_l2.values()) <= GRAD_L2_TOL:
        raise AssertionError(f"{what} gradients kernel vs plain: "
                             f"{result['grad_worst_l2_rel']}")
    if k["not_float32"] or p["not_float32"]:
        raise AssertionError(f"{what}: state tensors not float32 "
                             f"{k['not_float32'] + p['not_float32']}")
    return result


def phase_bf16_train(batch, cascade_sd, f32_path, smi, dev, cfg=None,
                     **kw):
    """Phase 14 (b)-(d): the bf16 train step (`phase_train` with cfg's
    train dtypes set to bfloat16, kernels then plain versions), then its
    first five steps' loss terms against phase 6's float32 kernel step
    (f32_path; the same init, batch and draws): each within BF16_VS_F32.
    Prints steps/s and peak memory of both dtypes."""
    import dataclasses
    from rcmvsnet_tpu_torch.config import Config
    base = cfg or Config()
    cfg = base.replace(
        backbone=dataclasses.replace(base.backbone, train_dtype="bfloat16"))
    res = phase_train(batch, cascade_sd, smi, dev, cfg, **kw)
    rtol, atol = BF16_VS_F32
    pairs = list(zip(res["step_losses_kernel"][:5],
                     f32_path["step_losses_kernel"][:5]))
    delta = [{n: abs(b[n] - f[n]) for n in LOSS_TERMS} for b, f in pairs]
    over = [(i + 1, n, b[n], f[n]) for i, (b, f) in enumerate(pairs)
            for n in LOSS_TERMS if not abs(b[n] - f[n]) <= rtol * abs(f[n])
            + atol]
    res["vs_float32_kernel_steps"] = {"bf16": [b for b, _ in pairs],
                                      "float32": [f for _, f in pairs],
                                      "abs_delta": delta}
    out = {"device": smi,
           "steps_per_s": {"bf16": res["steps_per_s_kernel"],
                           "float32": f32_path["steps_per_s_kernel"]},
           "steps_per_s_plain": {"bf16": res["steps_per_s_plain"],
                                 "float32": f32_path["steps_per_s_plain"]},
           "peak_bytes": {"bf16": res["max_memory_allocated_kernel"],
                          "float32": f32_path["max_memory_allocated_kernel"]},
           "vs_float32_kernel_steps": res["vs_float32_kernel_steps"]}
    print(json.dumps({"bf16_train": out}), flush=True)
    if len(pairs) < 5 or over:
        raise AssertionError(f"bf16 train step vs float32: {over} beyond "
                             f"{rtol}·|f32| + {atol} (steps {len(pairs)})")
    return res


# the remat phase's settings, (name, RunConfig.remat, remat_modules), and
# the extra runs without remat that measure the step's own run-to-run
# spread
REMAT_SETTINGS = (("none", False, True), ("pass", True, False),
                  ("both", True, True))
REMAT_NOISE_RUNS = ("none2", "none3")
# the forward kernels a recompute runs again (their launches per step must
# exceed the step's without remat), and the backward ones (unchanged)
RECOMPUTED_KERNELS = ("warp_variance", "conv3d", "warp_volume")
BACKWARD_KERNELS = ("warp_variance_bwd", "warp_volume_bwd", "conv3d_dw")
# Remat against no remat on the card. The step without remat does not
# repeat bit for bit there even under cudnn.deterministic:
# `grid_sampler_3d_backward` (the render branch's volume lookup) adds with
# float atomics, so the render U-Net's gradient and, through K7's
# backward, FeatureNet's vary from run to run (NVIDIA H100 80GB HBM3,
# 700 W: 54 float32 gradient tensors, max 1.1e-5; at bf16 FeatureNet's
# 25). A network whose step-1 gradients repeat bit for bit in two more
# runs without remat must match in every bit; a network that varies is
# held to REMAT_NOISE_FACTOR × the larger of those runs' distances
# (relative L2 over the network). Step 2 starts from parameters that
# carry that spread, and the render losses amplify it as chaos does: a
# ray's depth flips or not (two runs without remat, same card: step-2
# loss 1.7e-4 or 9e-7 apart, relative; at bf16 the networks' step-2
# gradients 0.01–0.13 apart, relative L2, beyond phase 14's limits). So
# step 2's losses and gradients are printed beside that spread, not
# gated; its num_batches_tracked must match in every bit and its running
# statistics lie within REMAT_STEP2_BN_L2 relative L2 per network (runs
# without remat read ≤ 2.3e-4): a second update in a recompute moves a
# statistic by momentum × (batch − running), ≈ 10 % of it.
REMAT_NOISE_FACTOR = 4.0
REMAT_STEP2_BN_L2 = 1e-3


def _remat_setting(batch, cascade_sd, draws, cfg, dev, timed):
    """One run of phase 15: two compared steps (each one's metrics,
    launches, parameter gradients and BatchNorm buffers after it, named
    as `_grads` names the gradients), then `timed` timed steps; the peak
    memory over all of them."""
    import torch
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import make_train_step
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    state = create_train_state(cfg, batch["imgs"].shape[1], 1000, dev,
                               seed=SEED, state_dicts=(cascade_sd, None))
    step = make_train_step(cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for _ in range(2):
        wrappers = zero_launches()
        metrics = step(state, batch, draws)
        buffers = {f"render.{k}": v.detach().cpu().clone()
                   for k, v in state.render.named_buffers()}
        buffers.update({k: v.detach().cpu().clone()
                        for k, v in state.cascade.named_buffers()})
        steps.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "launches": {k: fn.launches for k, fn in wrappers.items()},
            "grads": _grads(state), "buffers": buffers})
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(timed):
        step(state, batch, draws)
    sync(dev)
    dt = time.perf_counter() - t0
    out = {"steps": steps, "steps_per_s": timed / dt if timed else None,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                          else None)}
    del state
    return out


def _per_network(a: dict, b: dict) -> dict:
    """{network: [‖a − b‖₂ / ‖b‖₂ over its tensors, the number of its
    tensors that differ in any bit]} of two {name: tensor} dicts."""
    out = {}
    for net in NETWORKS:
        names = [n for n in b if n.startswith(net)]
        d = sum(float((a[n].double() - b[n].double()).norm()) ** 2
                for n in names)
        r = sum(float(b[n].double().norm()) ** 2 for n in names)
        out[net] = [(d / max(r, 1e-60)) ** 0.5,
                    sum(not a[n].equal(b[n]) for n in names)]
    return out


def _remat_compare(got, want) -> dict:
    """One run against another (see REMAT_NOISE_FACTOR): what differs at
    step 1, and how far step 2 lies."""
    g1, w1 = got["steps"][0], want["steps"][0]
    g2, w2 = got["steps"][1], want["steps"][1]
    stats = lambda s: {k: v for k, v in s["buffers"].items()
                       if v.dtype.is_floating_point}
    return {
        "step1_metrics_differing": {k: (g1["metrics"][k], v) for k, v in
                                    w1["metrics"].items()
                                    if g1["metrics"][k] != v},
        "step1_buffers_differing": [k for k, v in w1["buffers"].items()
                                    if not g1["buffers"][k].equal(v)],
        "num_batches_tracked_differing": [
            (i + 1, k) for i, (g, w) in enumerate(((g1, w1), (g2, w2)))
            for k, v in w["buffers"].items()
            if not v.dtype.is_floating_point and not g["buffers"][k].equal(v)],
        "step1_grads": _per_network(g1["grads"], w1["grads"]),
        "step2_loss_rel": {n: abs(g2["metrics"][n] - w2["metrics"][n])
                           / max(abs(w2["metrics"][n]), 1e-12)
                           for n in LOSS_TERMS},
        "step2_grads": _per_network(g2["grads"], w2["grads"]),
        "step2_grad_tensor_l2_max": max(
            float((g2["grads"][n] - v).norm()) / max(float(v.norm()), 1e-30)
            for n, v in w2["grads"].items()),
        "step2_running_stats": _per_network(stats(g2), stats(w2))}


def phase_remat(batch, cascade_sd, smi, dev, cfg=None, phase6=None,
                dtypes=("float32", "bfloat16"), timed=2):
    """Phase 15: rematerialization (`RunConfig.remat`, `nn/remat.py`) at
    phase 6's cell and draws, through the kernels, in each of `dtypes`
    (the train dtypes of the backbone and the render U-Net), under
    cudnn.deterministic: the step without remat, with pass-level remat
    only (`remat_modules=False`) and with both levels (the default), two
    steps each from one init, and two more runs without remat for the
    step's own spread (REMAT_NOISE_RUNS).
    (a), (b) Against the step without remat: every step-1 metric, every
        BatchNorm buffer after step 1 and num_batches_tracked after both
        steps equal in every bit (the forwards alone make them); step-1
        gradients equal in every bit in each network whose gradients
        repeat bit for bit without remat, the others within
        REMAT_NOISE_FACTOR × their spread; step 2's running statistics
        within REMAT_STEP2_BN_L2, its losses (finite) and gradients
        printed beside the spread of the runs without remat
        (REMAT_NOISE_FACTOR's comment says why).
    (c) Launches per step of each train kernel in each setting: every
        kernel a recompute reruns (K1, K2, K7's forward) above its count
        without remat, the backward kernels (K6, K7's backward, K8 dw) at
        it; the counts and their ratios are printed.
    (d) Steps/s over `timed` steps and peak max_memory_allocated per
        setting, beside phase 6's (which runs the default, both levels,
        over 5 timed steps)."""
    import dataclasses
    import torch
    from rcmvsnet_tpu_torch.config import Config
    from rcmvsnet_tpu_torch.train.step import draw_step
    base = cfg or Config()
    B, _, Hs, Ws = batch["imgs"].shape[:4]
    draws = draw_step(torch.Generator(device=dev).manual_seed(SEED), base,
                      B, Hs, Ws)
    result, failures = {"device": smi}, []
    for dtype in dtypes:
        bf16 = dtype == "bfloat16"
        suffix = "_bf16" if bf16 else ""
        dcfg = base.replace(backbone=dataclasses.replace(
            base.backbone, train_dtype=dtype))
        cfgs = {name: dcfg.replace(run=dataclasses.replace(
            dcfg.run, remat=rm, remat_modules=mods))
            for name, rm, mods in REMAT_SETTINGS}
        runs = {}
        torch.backends.cudnn.deterministic = True
        try:
            for name in cfgs:
                runs[name] = _remat_setting(batch, cascade_sd, draws,
                                            cfgs[name], dev, timed)
            for name in REMAT_NOISE_RUNS:
                runs[name] = _remat_setting(batch, cascade_sd, draws,
                                            cfgs["none"], dev, 0)
        finally:
            torch.backends.cudnn.deterministic = False
        cmp = {name: _remat_compare(runs[name], runs["none"])
               for name in ("pass", "both") + REMAT_NOISE_RUNS}
        spread = {net: max(cmp[n]["step1_grads"][net][0]
                           for n in REMAT_NOISE_RUNS) for net in NETWORKS}
        repeats = {net: not any(cmp[n]["step1_grads"][net][1]
                                for n in REMAT_NOISE_RUNS)
                   for net in NETWORKS}
        none = runs["none"]["steps"][0]["launches"]
        kernels = tuple(k + suffix for k in RECOMPUTED_KERNELS
                        + BACKWARD_KERNELS)
        res = {"settings": {}, "compared_to_none": cmp,
               "step1_grad_spread_without_remat": spread,
               "step1_grads_repeat_without_remat": repeats}
        for name in cfgs:
            run = runs[name]
            launches = run["steps"][0]["launches"]
            res["settings"][name] = {
                "launches_per_step": {k: launches[k] for k in kernels},
                "launch_ratio_vs_none": {
                    k: launches[k] / none[k] if none[k] else None
                    for k in kernels},
                "steps_per_s": run["steps_per_s"],
                "peak_bytes": run["peak_bytes"],
                "step_losses": [{n: s["metrics"][n] for n in LOSS_TERMS}
                                for s in run["steps"]]}
        if phase6 is not None and not bf16:
            res["phase6_both_levels"] = {
                "steps_per_s": phase6["steps_per_s_kernel"],
                "peak_bytes": phase6["max_memory_allocated_kernel"]}
        result[dtype] = res
        for name in ("pass", "both"):
            c = cmp[name]
            bad = {k: c[k] for k in ("step1_metrics_differing",
                                     "step1_buffers_differing",
                                     "num_batches_tracked_differing")
                   if c[k]}
            bad.update({f"step1 grads {net}": v
                        for net, v in c["step1_grads"].items()
                        if v[1] and not (not repeats[net] and v[0]
                                         <= REMAT_NOISE_FACTOR
                                         * spread[net])})
            second = runs[name]["steps"][1]["metrics"]
            bad.update({f"step2 loss {n}": second[n] for n in LOSS_TERMS
                        if not abs(second[n]) < float("inf")})
            bad.update({f"step2 running statistics {net}": v[0]
                        for net, v in c["step2_running_stats"].items()
                        if not v[0] <= REMAT_STEP2_BN_L2})
            if bad:
                failures.append(f"{dtype} {name} vs none: {bad} (spread "
                                f"without remat {spread})")
            got = runs[name]["steps"][0]["launches"]
            low = [k + suffix for k in RECOMPUTED_KERNELS
                   if not got[k + suffix] > none[k + suffix]]
            moved = [k + suffix for k in BACKWARD_KERNELS
                     if got[k + suffix] != none[k + suffix]]
            if low or moved:
                failures.append(f"{dtype} {name}: recomputed kernels not "
                                f"above their count without remat {low}, "
                                f"backward kernels off it {moved}")
    print(json.dumps({"remat": result}), flush=True)
    if failures:
        raise AssertionError("remat: " + "; ".join(failures))
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
        swapped), under cfg's remat (both levels by default, as phase 6)
        and again without remat, must each give phase 6's kernel step-1
        metrics in every bit, and an all-reduce of its gradients over the
        one-rank group must return them unchanged.
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
    import dataclasses
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

    # (a) one rank, under cfg's remat and without remat
    store = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    mesh.init_process(0, 1, f"file://{store}/store", dev)
    firsts, unchanged = {}, True
    try:
        for remat in (cfg.run.remat, False):
            rcfg = cfg.replace(run=dataclasses.replace(cfg.run, remat=remat))
            state = create_train_state(rcfg, batch1["imgs"].shape[1], 1000,
                                       dev, seed=SEED,
                                       state_dicts=(cascade_sd, None),
                                       group=mesh.batch_group())
            step = make_train_step(rcfg, group=mesh.batch_group())
            firsts[f"remat={remat}"] = {
                k: float(v) for k, v in step(state, batch1, draws1).items()}
            grads = [p.grad for p in state.optimizer.param_groups[0]["params"]
                     if p.grad is not None]
            before = [g.clone() for g in grads]
            mesh.allreduce_gradients(
                state.optimizer.param_groups[0]["params"], dist.group.WORLD)
            unchanged &= all(torch.equal(a, b)
                             for a, b in zip(before, grads))
            del state, grads, before
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    want = phase6["step1_metrics_kernel"]
    differ = {(r, k): (first[k], want[k]) for r, first in firsts.items()
              for k in want if k != "lr" and first[k] != want[k]}
    first = firsts[f"remat={cfg.run.remat}"]
    result["one_rank"] = {"backend": backend, "step1_metrics": first,
                          "runs": list(firsts),
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
    print(json.dumps({"sass_mma": mma}), flush=True)
    no_mma = missing_mma(mma)
    if not all(lib["kernels"] for lib in mma.values()) or no_mma:
        raise AssertionError(f"tensor-core kernels without their MMAs "
                             f"(TF32, or bf16 in a bf16 instance): {no_mma}"
                             f" of {mma}")
    warp_loads = check_warp_bf16_sass()
    print(json.dumps({"sass_warp_loads": warp_loads}), flush=True)
    k5_lds = check_k5_bf16_sass()
    print(json.dumps({"sass_k5_bf16_shared_loads": k5_lds}), flush=True)

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
    tanks_out = []
    tanks_path = phase_tanks(model, dev, smi, keep=tanks_out)
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
    torch.cuda.empty_cache()

    # 12. the bf16 eval path: its kernels against their plain versions,
    # then end to end at DTU and T&T against the plain path and float32
    ledger.phase = "bf16"
    with torch.no_grad():
        phase_kernels(model, samples, scene, ledger, dev, torch.bfloat16)
    torch.cuda.empty_cache()
    bf16_paths = phase_bf16(model, samples, scene, eval_out, tanks_out,
                            (main_path, tanks_path), smi, dev)
    del samples, eval_out, tanks_out
    torch.cuda.empty_cache()

    # 14. the bf16 train path: its kernels against their bf16 plain
    # versions, then the bf16 step against its plain versions and against
    # phase 6's float32 step (run before the report, phase 13)
    torch.manual_seed(SEED)
    render = make_models(Config(), TV)[1].to(dev)
    with torch.no_grad():
        phase_train_kernels(model, render, batch, tscene, ledger, dev,
                            torch.bfloat16)
    del render
    torch.cuda.empty_cache()
    bf16_train = phase_bf16_train(batch, load_state_dict(ASSET), train_path,
                                  smi, dev)
    torch.cuda.empty_cache()

    # 15. rematerialization: none, pass level, both levels (phase 6's
    # default), in float32 and bf16 (run before the report, phase 13)
    remat = phase_remat(batch, load_state_dict(ASSET), smi, dev,
                        phase6=train_path)
    del batch
    torch.cuda.empty_cache()

    # 16. the quality goldens through fusion and the DTU metric, float32
    # plain, float32 kernels and bf16 kernels (run before the report)
    quality = phase_quality(smi, dev)
    torch.cuda.empty_cache()

    # 13. report
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
        ("conv2d_bf16", "bf16", "cuda", source + "csrc/conv2d_bf16.cu",
         "rcmvsnet_tpu/ops/pallas_conv2d.py:306"),
        ("warp_variance_bf16", "bf16", "cuda",
         source + "csrc/warp_variance_bf16.cu",
         "rcmvsnet_tpu/ops/pallas_warp2.py:393"),
        ("conv3d_bf16", "bf16", "cuda", source + "csrc/conv3d_bf16.cu",
         "rcmvsnet_tpu/ops/pallas_costreg.py:383 + "
         "rcmvsnet_tpu/ops/pallas_resample.py:59,117"),
        ("warp_variance_bwd_bf16", "bf16_train", "cuda",
         source + "csrc/warp_variance_bf16.cu",
         "rcmvsnet_tpu/ops/pallas_warp_train.py:306 (bwd :108, :374)"),
        ("warp_volume_bf16", "bf16_train", "cuda",
         source + "csrc/warp_volume_bf16.cu",
         "rcmvsnet_tpu/ops/pallas_warp_volume.py:263 (fwd :101, :340)"),
        ("warp_volume_bwd_bf16", "bf16_train", "cuda",
         source + "csrc/warp_volume_bf16.cu",
         "rcmvsnet_tpu/ops/pallas_warp_volume.py:263 (bwd :178, :406)"),
        ("conv3d_dw_bf16", "bf16_train", "cuda",
         source + "csrc/conv3d_dw_bf16.cu",
         "rcmvsnet_tpu/ops/pallas_costreg_train.py:81 (dw :163, :258)"),
    ]
    paths = {"eval": main_path, "train": train_path, "tools": tools_path,
             "bf16": bf16_paths["dtu"], "bf16_train": bf16_train}
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
        if name in TC_KERNELS + BF16_TC_KERNELS:
            row.update(bound_tc_ms=s["bound_tc_ms"],
                       bound_tc_by=s["bound_tc_by"])
        if "library_unfused_ms" in s:
            row["library_unfused_ms"] = s["library_unfused_ms"]
        if "repeats_bit_for_bit" in s:
            row["repeats_bit_for_bit"] = s["repeats_bit_for_bit"]
        if "device_ms" in s:
            row.update(device_ms=s["device_ms"], host_ms=s["host_ms"])
        if name in TRAIN_KERNELS + BF16_TRAIN_KERNELS and phase in (
                "eval", "bf16"):
            train_phase, tpath = (("train", train_path) if phase == "eval"
                                  else ("bf16_train", bf16_train))
            t = ledger.summary(name, train_phase)
            row["train"] = {"launches": tpath["launches"][name],
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
        "sass_mma": mma, "sass_warp_loads": warp_loads,
        "sass_k5_bf16_shared_loads": k5_lds,
        "calls": ledger.rows, "main_path": main_path,
        "train_path": train_path, "tanks_path": tanks_path,
        "tools_path": tools_path, "train_cli": train_cli,
        "wide_path": wide_path, "parallel": parallel,
        "bf16_paths": bf16_paths, "bf16_train_path": bf16_train,
        "remat": remat, "quality": quality, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
