"""K9 (`ops/conv3d.conv3d_lanewise`) at the CostRegNet's layer shapes.

Counterpart of `scripts/profile_conv3d.py`: its eight cases (stage 2 and
stage 3 of the 864×1152 cascade), each the median of 7 calls after 2
warm-ups (CUDA events on the card) and printed with its rate. The JAX tool runs them in bf16;
the port is float32 only, so these run in float32. The rate counts the
dense 27-tap work on the output grid (2·27·Ci·Co per output voxel), as the
JAX tool does, so for the transposed cases it includes the 7 taps in 8
that land on stuffed zeros, which K2's gather never computes.

Usage:
  python -m rcmvsnet_tpu_torch.tools.profile_conv3d [--device cuda]
`--device cpu` runs the plain version (`F.conv3d` / `F.conv_transpose3d`)
on the host clock.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..cli.eval_dtu import resolve_device
from ..ops.conv3d import conv3d_lanewise, out_shape
from .timing import device_label, make_timer

# (label, D, H, W, Ci, Co, mode), scripts/profile_conv3d.py:31-40
CASES = (
    ("S2 conv0 16->8 s1", 32, 432, 576, 16, 8, "s1"),
    ("S2 conv1 8->16 s2", 32, 432, 576, 8, 16, "s2"),
    ("S2 conv2 16->16 s1", 16, 216, 288, 16, 16, "s1"),
    ("S2 deconv11 16->8 t", 16, 216, 288, 16, 8, "t2"),
    ("S2 prob 8->1 s1", 32, 432, 576, 8, 1, "s1"),
    ("S3 conv0 8->8 s1", 8, 864, 1152, 8, 8, "s1"),
    ("S3 deconv11 16->8 t", 4, 432, 576, 16, 8, "t2"),
    ("S3 prob 8->1 s1", 8, 864, 1152, 8, 1, "s1"),
)


def case_inputs(case, device):
    """x [1, Ci, D, H, W] ~ N(0, 1) and a weight 0.1·N(0, 1) in the port's
    layout ([Co, Ci, 3, 3, 3], or [Ci, Co, 3, 3, 3] for "t2")."""
    _, D, H, W, ci, co, mode = case
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(1, ci, D, H, W, generator=g, device=device)
    shape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    return x, 0.1 * torch.randn(*shape, generator=g, device=device)


def dense_flops(case) -> float:
    """2·27·Ci·Co per output voxel (the JAX tool's count)."""
    _, D, H, W, ci, co, mode = case
    Do, Ho, Wo = out_shape(mode, D, H, W)
    return 2.0 * 27 * ci * co * Do * Ho * Wo


def run(device, cases=None) -> list[dict]:
    """Time K9 on every case (default CASES); print one line each; return
    the rows."""
    cases = CASES if cases is None else cases
    timer = make_timer(device)
    rows = []
    for case in cases:
        x, w = case_inputs(case, device)
        mode = case[-1]
        ms = timer(lambda: conv3d_lanewise(x, w, mode))
        gf = dense_flops(case) / 1e9
        rows.append({"label": case[0], "shape": list(case[1:6]),
                     "mode": mode, "ms": ms, "gflop": gf,
                     "tflops": gf / ms})
        print(f"{case[0]}: {ms:8.3f} ms  ({gf:.1f} GF dense, "
            f"{gf / ms:.2f} TF/s)")
        del x, w
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    device = resolve_device(p.parse_args(argv).device)
    label = device_label(device)
    print(f"device: {label} | float32")
    rows = run(device)
    print(json.dumps({"device": label, "cases": rows}))
    return rows


if __name__ == "__main__":
    main()
