"""The eval scenes of the two end-to-end quality goldens, from a committed
asset, for hosts without cv2.

`tests/test_e2e_quality.py` (the supervised golden, "sup") and
`tests/test_e2e_quality_unsup.py` (the unsupervised one, "unsup") score
depth → fusion → the DTU metric on a scan that
`data/synthetic.write_synthetic_scan` writes (128×160, V=5, seed 5; unsup
at baseline 48 and tex_upscale 2, scripts/train_synth_golden.py
build_samples, build_samples_unsup): the textured plane of
`make_synthetic_views` (its texture from cv2.resize), its views as JPEG
files that `DTUTestDataset` reads back with cv2.imread.
`assets/golden_scenes.npz` holds, for each golden (keys "<golden>.<name>"),
what that scan gives and what a host without cv2 cannot make:
  * images          uint8 [V, H, W, 3], the views as read back (RGB);
  * cam_intrinsics, cam_extrinsics, cam_depth   each view's cam file as
    `core.io.read_cam_file` parses it (cam_depth: depth_min,
    depth_interval, num_depth, depth_max);
  * pairs           int [V, 1 + sources], the pair file's rows (ref first);
  * depths, intrinsics, extrinsics   the scene's GT depths and cameras,
    which `gt_cloud` unprojects.
`GoldenScan(scene)` is a `DTUTestDataset` over one scene: its items equal,
in every bit, those of `DTUTestDataset(scan, ["scan1"], nviews=5,
ndepths=64, max_h=128, max_w=160)` over the written scan.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.io import CameraFile
from .dtu_test import DTUTestDataset

SCENE_ASSET = (Path(__file__).resolve().parent.parent / "assets"
               / "golden_scenes.npz")
# the eval protocol's loader arguments (run_quality)
NVIEWS, NDEPTHS, MAX_H, MAX_W = 5, 64, 128, 160


def load_scene(golden: str, path=SCENE_ASSET) -> dict:
    """One golden's arrays from the asset, keyed without the prefix."""
    prefix = golden + "."
    with np.load(path) as z:
        scene = {k[len(prefix):]: z[k] for k in z.files
                 if k.startswith(prefix)}
    if not scene:
        raise ValueError(f"{path} holds no golden {golden!r}")
    return scene


class GoldenScan(DTUTestDataset):
    """`DTUTestDataset` over a loaded scene ("scan1") instead of files."""

    def __init__(self, scene: dict, nviews=NVIEWS, ndepths=NDEPTHS,
                 max_h=MAX_H, max_w=MAX_W, **kwargs):
        self.scene = scene
        super().__init__(".", ["scan1"], nviews=nviews, ndepths=ndepths,
                         max_h=max_h, max_w=max_w, **kwargs)

    def _pairs(self, scan):
        return [(int(row[0]), [int(v) for v in row[1:]])
                for row in self.scene["pairs"]]

    def _image(self, scan, vid):
        # core.io.read_image: uint8 RGB → float32 / 255
        return self.scene["images"][vid].astype(np.float32) / 255.0

    def _cam_file(self, scan, vid):
        depth = [float(v) for v in self.scene["cam_depth"][vid]]
        return CameraFile(self.scene["cam_intrinsics"][vid].copy(),
                          self.scene["cam_extrinsics"][vid].copy(), *depth)


def gt_cloud(scene: dict) -> np.ndarray:
    """The exact GT cloud [V·H·W, 3], float64: every view's GT depth map
    unprojected into the world (run_quality's, train_synth_golden.py
    :192-205)."""
    depths = scene["depths"]
    V, H, W = depths.shape
    K = scene["intrinsics"]
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    pts = []
    for v in range(V):
        E = scene["extrinsics"][v]
        d = depths[v].reshape(-1).astype(np.float64)
        cam = (np.linalg.inv(K) @ pix.T) * d
        world = np.linalg.inv(E) @ np.vstack([cam, np.ones_like(d)[None]])
        pts.append(world[:3].T)
    return np.concatenate(pts, axis=0)
