"""Tanks & Temples inference + fusion command line (PyTorch port).

Counterpart of `rcmvsnet_tpu/cli/eval_tanks.py`: 1920×1056 inputs, 7
views, the per-scene fusion tables of the reference's
eval_rcmvsnet_tanks.py, one .ply per scene for the benchmark website. Same
flags plus `--device` (default `cuda`; a missing GPU is an error, not a
CPU run).

Phase 1 (depth): the cascade per reference view (`infer_views_sharded`,
one view at a time), the next view decoded on a worker thread meanwhile;
depth / confidence PFMs, cams and images per view. `--no_pallas` runs
every kernel's plain PyTorch version; `--n_devices N` shards the
reference views over N workers, one process per device, as
`cli/eval_dtu.py` does, and fuses once all have ended. Phase 2
(fusion): `fuse_scan` per scene with that scene's thresholds, into
`<outdir>/<scene>.ply`.

Usage:
  python -m rcmvsnet_tpu_torch.cli.eval_tanks --testpath /data/tanks \\
      --loadckpt model_cas.ckpt --outdir ./tanks_exp --split intermediate
`--loadckpt` takes a reference `*_cas.ckpt` or the port's `.npz`.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..core import io as _io
from ..data import tanks as _tanks
from ..data import transforms as _transforms
from ..core.geometry import set_full_precision
from ..fusion.fuse import fuse_scan
from ..models.cascade import infer_views_sharded
from .eval_dtu import build_model, run_ranks

# per-scene fusion hyperparameters of the reference's
# eval_rcmvsnet_tanks.py:400-440 (intermediate) and :460-491 (advanced);
# equal to the JAX CLI's tables (tests/test_torch_tanks.py)
PHOTO_THRESHOLD = {
    "Family": 0.9, "Francis": 0.8, "Horse": 0.8, "Lighthouse": 0.8,
    "M60": 0.9, "Panther": 0.9, "Playground": 0.85, "Train": 0.9,
    "Auditorium": 0.7, "Ballroom": 0.8, "Courtroom": 0.8, "Museum": 0.8,
    "Palace": 0.9, "Temple": 0.8,
}
GEO_MASK_THRESHOLD = {
    "Family": 6, "Francis": 8, "Horse": 4, "Lighthouse": 7, "M60": 6,
    "Panther": 7, "Playground": 7, "Train": 6,
    "Auditorium": 3, "Ballroom": 4, "Courtroom": 3, "Museum": 4,
    "Palace": 5, "Temple": 3,
}
GEO_PIXEL_THRESHOLD = {
    "Family": 0.75, "Francis": 1.0, "Horse": 1.25, "Lighthouse": 1.0,
    "M60": 0.75, "Panther": 1.0, "Playground": 1.0, "Train": 1.5,
    "Auditorium": 4.0, "Ballroom": 4.0, "Courtroom": 3.0, "Museum": 4.0,
    "Palace": 4.0, "Temple": 4.0,
}
GEO_DEPTH_THRESHOLD = {
    "Family": 0.01, "Francis": 0.01, "Horse": 0.01, "Lighthouse": 0.01,
    "M60": 0.005, "Panther": 0.01, "Playground": 0.01, "Train": 0.01,
    "Auditorium": 0.005, "Ballroom": 0.005, "Courtroom": 0.005,
    "Museum": 0.01, "Palace": 0.005, "Temple": 0.01,
}
# native capture resolutions per scene, kept as parity documentation only:
# the reference never reads its own table (the loader rescales intrinsics
# from the decoded image's size to img_wh, as data/tanks.py does)
IMAGE_SIZES = {
    "Family": (1920, 1080), "Francis": (1920, 1080), "Horse": (1920, 1080),
    "Lighthouse": (2048, 1080), "M60": (2048, 1080), "Panther": (2048, 1080),
    "Playground": (1920, 1080), "Train": (1920, 1080),
    "Auditorium": (1920, 1080), "Ballroom": (1920, 1080),
    "Courtroom": (1920, 1080), "Museum": (1920, 1080),
    "Palace": (1920, 1080), "Temple": (1920, 1080),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Tanks&Temples eval")
    p.add_argument("--testpath", required=True)
    p.add_argument("--split", default="intermediate",
                   choices=["intermediate", "advanced"])
    p.add_argument("--loadckpt", required=True,
                   help="reference *_cas.ckpt (torch) or the port's .npz "
                        "state_dict")
    p.add_argument("--outdir", default="./tanks_exp")
    p.add_argument("--num_view", type=int, default=7)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--img_wh", default="1920,1056")
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--cr_base_chs", default="8,8,8")
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--no_test", action="store_true")
    p.add_argument("--no_filter", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device for inference (cuda, cuda:N or cpu; "
                        "with --n_devices, cuda or cpu)")
    p.add_argument("--no_pallas", action="store_true",
                   help="run every kernel's plain PyTorch version")
    p.add_argument("--n_devices", type=int, default=None,
                   help="shard the reference views over this many devices "
                        "of this host, one process each (default 1)")
    return p.parse_args(argv)


def _write_tanks_view(outdir, sample, depth, conf):
    """One reference view's outputs (pfm / cams / images), the reference's
    per-view output tree."""
    import cv2
    fn = sample["filename"]
    for sub in ["depth_est", "confidence", "cams", "images"]:
        (outdir / fn.format(sub, "")).parent.mkdir(
            parents=True, exist_ok=True)
    _io.save_pfm(outdir / fn.format("depth_est", ".pfm"), depth)
    _io.save_pfm(outdir / fn.format("confidence", ".pfm"), conf)
    cam = sample["proj_matrices"]["stage3"][0]
    dvals = sample["depth_values"]
    _io.write_cam_file(outdir / fn.format("cams", "_cam.txt"),
                       cam[0], cam[1, :3, :3],
                       [dvals[0], dvals[1] - dvals[0], len(dvals),
                        dvals[-1]])
    img = (sample["imgs"][0] * _transforms.IMAGENET_STD
           + _transforms.IMAGENET_MEAN)
    cv2.imwrite(str(outdir / fn.format("images", ".jpg")),
                cv2.cvtColor((img.clip(0, 1) * 255).astype(np.uint8),
                             cv2.COLOR_RGB2BGR))


def save_depth(args, device, rank: int = 0, world: int = 1):
    """Phase 1 for the reference views i % world == rank; the next one is
    decoded on a worker thread while one runs (the 1920x1056 decode and
    resize would otherwise serialise with the card's work)."""
    outdir = Path(args.outdir)
    img_wh = tuple(int(x) for x in args.img_wh.split(","))
    ds = _tanks.TanksDataset(args.testpath, args.split, nviews=args.num_view,
                             img_wh=img_wh, ndepths=args.numdepth)
    model = build_model(args, device)
    t0 = time.time()
    for i, sample, depth, conf in infer_views_sharded(
            model, ds, device, rank, world, plain=args.no_pallas):
        print(f"{sample['filename']} {i}/{len(ds)} "
              f"{time.time() - t0:.3f}s")
        _write_tanks_view(outdir, sample, depth, conf)
        t0 = time.time()


def _save_depth_rank(rank: int, world: int, device, args):
    """One worker of `--n_devices`: its share of phase 1."""
    if device.type == "cuda":
        set_full_precision()
    save_depth(args, device, rank, world)


def main(argv=None):
    args = parse_args(argv)
    outdir = Path(args.outdir)
    scans = (_tanks.INTERMEDIATE_SCANS if args.split == "intermediate"
             else _tanks.ADVANCED_SCANS)
    if not args.no_test:
        run_ranks(args, _save_depth_rank)
    if not args.no_filter:
        for scan in scans:
            ply = outdir / f"{scan}.ply"
            n = fuse_scan(outdir / scan,
                          Path(args.testpath) / args.split / scan / "pair.txt",
                          ply,
                          prob_threshold=PHOTO_THRESHOLD[scan],
                          num_consistent=GEO_MASK_THRESHOLD[scan],
                          img_dist_thresh=GEO_PIXEL_THRESHOLD[scan],
                          depth_thresh=GEO_DEPTH_THRESHOLD[scan])
            print(f"fused {scan}: {n} points -> {ply}")


if __name__ == "__main__":
    main()
