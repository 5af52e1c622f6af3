"""The end-to-end quality goldens on the port: depth → geometric-consistency
fusion → the DTU metric.

Counterpart of `scripts/train_synth_golden.py` `run_quality`, `golden` and
`golden_unsup`: `infer_views` over the 5 reference views of a golden's
scene (`data/golden_scene.py`, from `assets/golden_scenes.npz`; 128×160,
V=5, 64 planes, 48/32/8), `fusion/fuse.filter_depth_views` of each
reference against the other four at the protocol's thresholds (confidence >
0.5, 3 consistent views; train_synth_golden.py:39), the exact GT cloud, and
`fusion/dtu_eval.dtu_point_compare(dst=0.2)`. Goldens:
  * sup    the supervised backbone (`assets/backbone_synth.npz`) on the
           baseline-8 scene, pinned by tests/golden/e2e_quality.json;
  * unsup  the backbone trained without ground truth
           (`assets/backbone_synth_unsup.npz`) on the baseline-48,
           sharper-texture scene, pinned by e2e_quality_unsup.json.
`check` holds a result to its golden's JAX test
(tests/test_e2e_quality.py:42-54, tests/test_e2e_quality_unsup.py:53-72).
Imports no cv2 and no PIL.

Usage:
  python -m rcmvsnet_tpu_torch.tools.quality --golden {sup,unsup} \
      [--eval_dtype bfloat16] [--no_pallas] [--device cpu]
prints the golden's metric keys and `n_fused_raw` as one JSON line. It runs
on the card unless `--device cpu` is given; `--no_pallas` runs every
kernel's plain PyTorch version.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..cli.eval_dtu import add_eval_dtype, resolve_device
from ..config import BackboneConfig
from ..data.golden_scene import GoldenScan, gt_cloud, load_scene
from ..fusion.dtu_eval import dtu_point_compare
from ..fusion.fuse import filter_depth_views
from ..models.cascade import CascadeMVSNet, infer_views
from ..weights import ASSET, UNSUP_ASSET, load_state_dict

WEIGHTS = {"sup": ASSET, "unsup": UNSUP_ASSET}
PROB_THRES, NUM_CONSISTENT = 0.5, 3
# the JAX tests' bounds: n_fused_raw above, the others below
BOUNDS = {"sup": {"n_fused_raw": 50_000, "acc_mean": 1.0, "comp_mean": 2.0},
          "unsup": {"n_fused_raw": 50_000, "acc_mean": 3.0,
                    "comp_mean": 4.5, "acc_median": 3.1}}
# the unsupervised golden within these factors of the supervised one's
UNSUP_VS_SUP = {"acc_mean": 12.0, "comp_mean": 8.0}
# pins against the committed JSON: (rtol, atol), and n_data within 5 %
PINS = {"acc_mean": (0.15, 0.02), "comp_mean": (0.15, 0.05),
        "acc_median": (0.15, 0.02)}
N_DATA_RTOL = 0.05


def score(maps, samples, scene) -> tuple[dict, np.ndarray]:
    """One path's (depth, confidence) maps → (metrics, final masks
    [V, H, W]): `filter_depth_views` of each reference view against the
    others as run_quality calls it, then the DTU metric of the fused cloud
    against the exact GT cloud."""
    cams = [(s["proj_matrices"]["stage3"][0, 1][:3, :3],
             s["proj_matrices"]["stage3"][0, 0]) for s in samples]
    verts, masks = [], []
    for ref, (depth, conf) in enumerate(maps):
        srcs = [v for v in range(len(maps)) if v != ref]
        xyz, _, final, _, _ = filter_depth_views(
            depth, conf, np.zeros(depth.shape + (3,), np.float32),
            *cams[ref], [maps[v][0] for v in srcs],
            [cams[v][0] for v in srcs], [cams[v][1] for v in srcs],
            prob_threshold=PROB_THRES, num_consistent=NUM_CONSISTENT)
        verts.append(xyz)
        masks.append(final)
    fused = np.concatenate(verts, axis=0)
    metrics = dtu_point_compare(fused, gt_cloud(scene), dst=0.2)
    metrics["n_fused_raw"] = int(len(fused))
    return metrics, np.stack(masks)


def run(golden: str, device, eval_dtype: str = "float32",
        plain: bool = False) -> dict:
    """One golden through the port: {"metrics", "masks", "maps"}."""
    scene = load_scene(golden)
    scan = GoldenScan(scene)
    samples = [scan[i] for i in range(len(scan))]
    model = CascadeMVSNet(BackboneConfig(eval_dtype=eval_dtype))
    model.load_state_dict(load_state_dict(WEIGHTS[golden]), strict=True)
    maps = infer_views(model.to(device).eval(), samples, device, plain=plain)
    metrics, masks = score(maps, samples, scene)
    return {"metrics": metrics, "masks": masks, "maps": maps}


def check(golden: str, metrics: dict, pinned: dict,
          sup_pinned: dict | None = None) -> list[str]:
    """What of its golden's JAX test `metrics` fails: the bounds, the
    factors against the supervised golden's committed JSON (`sup_pinned`,
    unsup only) and the pins against `pinned`, each as a message."""
    bad = []
    for key, bound in BOUNDS[golden].items():
        above = key == "n_fused_raw"
        if not (metrics[key] > bound if above else metrics[key] < bound):
            bad.append(f"{key} {metrics[key]} not {'>' if above else '<'} "
                       f"{bound}")
    if golden == "unsup":
        for key, factor in UNSUP_VS_SUP.items():
            if not metrics[key] < factor * sup_pinned[key]:
                bad.append(f"{key} {metrics[key]} not < {factor} x the "
                           f"supervised golden's {sup_pinned[key]}")
    for key, (rtol, atol) in PINS.items():
        if not abs(metrics[key] - pinned[key]) <= atol + rtol * abs(
                pinned[key]):
            bad.append(f"{key} {metrics[key]} not within rtol {rtol} atol "
                       f"{atol} of {pinned[key]}")
    if not abs(metrics["n_data"] - pinned["n_data"]) < \
            N_DATA_RTOL * pinned["n_data"]:
        bad.append(f"n_data {metrics['n_data']} not within {N_DATA_RTOL} "
                   f"of {pinned['n_data']}")
    return bad


def main(argv=None) -> dict:
    """Prints the metrics line; returns `run`'s result."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--golden", choices=sorted(WEIGHTS), default="sup")
    p.add_argument("--no_pallas", action="store_true",
                   help="run every kernel's plain PyTorch version")
    p.add_argument("--device", default="cuda")
    add_eval_dtype(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    res = run(args.golden, device, args.eval_dtype, args.no_pallas)
    print(json.dumps(res["metrics"]))
    return res


if __name__ == "__main__":
    main()
