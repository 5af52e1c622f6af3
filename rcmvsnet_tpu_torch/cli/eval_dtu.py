"""DTU inference + fusion command line (PyTorch port).

Counterpart of `rcmvsnet_tpu/cli/eval_dtu.py`, same flags plus `--device`
(default `cuda`; a missing GPU is an error, not a CPU run). `--no_pallas`
runs every kernel's plain PyTorch version. `--n_devices N` spawns N
workers (one process per device, `parallel/mesh.spawn`; worker r on
`cuda:r`, or the CPU under `--device cpu`), each inferring and writing the
reference views i with i % N == r (`infer_views_sharded`, no collectives);
once every worker has ended, the launching process fuses and scores.

Phase 1 (save_depth): the cascade per reference view
(`infer_views_sharded`), then depth_est / confidence PFMs, cams, images
and visualizations — the JAX CLI's output tree. Phase 2 (fusion):
photometric + geometric filtering into mvsnet{scan:03d}_l3.ply (the
port's `fusion/fuse.py`).
Optional phase 3: the ported DTU acc/comp benchmark when --gt_dir is given.

Usage:
  python -m rcmvsnet_tpu_torch.cli.eval_dtu --testpath /data/dtu_test \\
      --loadckpt model_cas.ckpt --outdir ./dtu_exp [--device cuda]
`--loadckpt` takes a reference `*_cas.ckpt` (loaded strictly) or the port's
`.npz` state_dict (e.g. rcmvsnet_tpu_torch/assets/backbone_synth.npz).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import time
from pathlib import Path

import numpy as np
import torch

from ..config import BackboneConfig
from ..core import io as _io
from ..core.geometry import set_full_precision
from ..data import dtu_test as _dtu_test
from ..data import transforms as _transforms
from ..fusion import fuse as _fuse
from ..models.cascade import CascadeMVSNet, infer_views_sharded
from ..parallel import mesh
from ..weights import load_state_dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DTU eval: depth + fusion")
    p.add_argument("--testpath", required=True)
    p.add_argument("--testlist", default="lists/dtu/test.txt")
    p.add_argument("--loadckpt", required=True,
                   help="reference *_cas.ckpt (torch) or the port's .npz "
                        "state_dict")
    p.add_argument("--outdir", default="./dtu_exp")
    p.add_argument("--num_view", type=int, default=5)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--max_h", type=int, default=1200)
    p.add_argument("--max_w", type=int, default=1600)
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--cr_base_chs", default="8,8,8")
    p.add_argument("--prob_thres", type=float, default=0.8)
    p.add_argument("--num_consistency", type=int, default=3)
    p.add_argument("--depth_thres", type=float, default=0.01)
    p.add_argument("--num_worker", type=int, default=4)
    p.add_argument("--no_test", action="store_true", help="fusion only")
    p.add_argument("--no_filter", action="store_true", help="depth only")
    p.add_argument("--device", default="cuda",
                   help="torch device for inference (cuda, cuda:N or cpu; "
                        "with --n_devices, cuda or cpu)")
    p.add_argument("--no_pallas", action="store_true",
                   help="run every kernel's plain PyTorch version")
    p.add_argument("--n_devices", type=int, default=None,
                   help="shard the reference views over this many devices "
                        "of this host, one process each (default 1)")
    p.add_argument("--gt_dir", default=None,
                   help="DTU SampleSet/MVS Data dir (Points/stl + ObsMask); "
                        "when given, phase 3 runs the ported acc/comp "
                        "benchmark on the fused clouds and writes "
                        "dtu_metrics.json")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The inference device; a CUDA device that is absent is an error."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device available "
                             f"(pass --device cpu to run on the CPU)")
        set_full_precision()
    return device


def build_model(args, device) -> CascadeMVSNet:
    csv = lambda s, t: tuple(t(x) for x in s.split(",") if x)
    model = CascadeMVSNet(BackboneConfig(
        ndepths=csv(args.ndepths, int),
        depth_intervals_ratio=csv(args.depth_inter_r, float),
        cr_base_chs=csv(args.cr_base_chs, int)))
    model.load_state_dict(load_state_dict(args.loadckpt), strict=True)
    return model.to(device).eval()


def _save_rainbow(path, arr, vmin, vmax):
    """JET-colormapped visualization jpg (rainbow-equivalent)."""
    import cv2
    norm = np.clip((arr - vmin) / max(vmax - vmin, 1e-8), 0, 1)
    img = cv2.applyColorMap((norm * 255).astype(np.uint8), cv2.COLORMAP_JET)
    cv2.imwrite(str(path), img)


def _write_view(outdir, sample, depth, conf):
    """One reference view's outputs: pfm / cams / images / rainbow
    visualizations, the JAX CLI's output tree."""
    import cv2
    fn = sample["filename"]
    for sub in ["depth_est", "confidence", "cams", "images",
                "depth_map", "confidence_map"]:
        (outdir / fn.format(sub, "")).parent.mkdir(
            parents=True, exist_ok=True)
    _io.save_pfm(outdir / fn.format("depth_est", ".pfm"), depth)
    _io.save_pfm(outdir / fn.format("confidence", ".pfm"), conf)
    dvals = sample["depth_values"]
    _save_rainbow(outdir / fn.format("depth_map", ".jpg"), depth,
                  dvals[0], dvals[-1])
    _save_rainbow(outdir / fn.format("confidence_map", ".jpg"),
                  conf, conf.min(), conf.max())
    cam = sample["proj_matrices"]["stage3"][0]  # ref view, full-res K
    _io.write_cam_file(outdir / fn.format("cams", "_cam.txt"),
                       cam[0], cam[1, :3, :3],
                       [dvals[0], dvals[1] - dvals[0], len(dvals),
                        dvals[-1]])
    img = (sample["imgs"][0] * _transforms.IMAGENET_STD
           + _transforms.IMAGENET_MEAN)
    cv2.imwrite(str(outdir / fn.format("images", ".jpg")),
                cv2.cvtColor((img.clip(0, 1) * 255).astype(np.uint8),
                             cv2.COLOR_RGB2BGR))


def save_depth(args, testlist, device, rank: int = 0, world: int = 1):
    """Phase 1 for the reference views i % world == rank of every scan
    (the next one decoded on a worker thread while one runs)."""
    outdir = Path(args.outdir)
    model = build_model(args, device)
    for scan in testlist:
        ds = _dtu_test.DTUTestDataset(
            args.testpath, [scan], nviews=args.num_view,
            ndepths=args.numdepth, interval_scale=args.interval_scale,
            max_h=args.max_h, max_w=args.max_w)
        t0 = time.time()
        for i, sample, depth, conf in infer_views_sharded(
                model, ds, device, rank, world, plain=args.no_pallas):
            print(f"{scan} view {i}/{len(ds)} {time.time() - t0:.3f}s "
                  f"res {depth.shape}")
            _write_view(outdir, sample, depth, conf)
            t0 = time.time()


def _save_depth_rank(rank: int, world: int, device, args, testlist):
    """One worker of `--n_devices`: its share of phase 1."""
    if device.type == "cuda":
        set_full_precision()
    save_depth(args, testlist, device, rank, world)


def run_ranks(args, rank_fn, *fn_args) -> None:
    """rank_fn(rank, world, device, args, *fn_args) on `--device`, or in
    `--n_devices` spawned workers; returns when every one has ended."""
    n = args.n_devices or 1
    if n > 1:
        mesh.spawn(rank_fn, n, (args, *fn_args),
                   device_type=torch.device(args.device).type)
    else:
        rank_fn(0, 1, resolve_device(args.device), args, *fn_args)


def fuse_one(args_tuple):
    scan, args = args_tuple
    scan_id = int(scan[4:])
    ply = Path(args.outdir) / f"mvsnet{scan_id:03d}_l3.ply"
    n = _fuse.fuse_scan(
        Path(args.outdir) / scan, Path(args.testpath) / scan / "pair.txt",
        ply, prob_threshold=args.prob_thres,
        num_consistent=args.num_consistency,
        img_dist_thresh=_fuse.DTU_IMG_DIST_THRESHOLDS.get(scan_id, 0.5),
        depth_thresh=args.depth_thres)
    print(f"fused {scan}: {n} points -> {ply}")
    return scan, n


def main(argv=None):
    args = parse_args(argv)
    if Path(args.testlist).exists():
        testlist = [l.strip() for l in open(args.testlist) if l.strip()]
    else:
        testlist = [s for s in args.testlist.split(",") if s]

    if not args.no_test:
        run_ranks(args, _save_depth_rank, testlist)
    if not args.no_filter:
        work = [(scan, args) for scan in testlist]
        if args.num_worker > 1:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(args.num_worker) as pool:
                results = pool.map(fuse_one, work)
        else:
            results = [fuse_one(w) for w in work]
        print(json.dumps({s: n for s, n in results}))

    if args.gt_dir:
        from ..fusion.dtu_eval import dtu_eval_scans
        sets = sorted(int(s[4:]) for s in testlist)
        metrics = dtu_eval_scans(args.outdir, args.gt_dir, sets=sets)
        out = Path(args.outdir) / "dtu_metrics.json"
        out.write_text(json.dumps(metrics, indent=2, default=str))
        print(json.dumps({"acc": metrics["acc"], "comp": metrics["comp"],
                          "overall": metrics["overall"]}))


if __name__ == "__main__":
    main()
