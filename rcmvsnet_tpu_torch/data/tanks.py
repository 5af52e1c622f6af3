"""Tanks & Temples dataset (intermediate / advanced submissions).

Parity target: the reference's datasets/tanks.py — fixed scan lists with
per-scene native sizes, images force-resized to img_wh (1920×1056 default,
/32-aligned), cams from cams_1/, depth range [min, max] from cam line 11
with ndepths−1 intervals.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.io import read_cam_file, read_image, read_pair_file
from . import transforms as T

INTERMEDIATE_SCANS = ["Family", "Francis", "Horse", "Lighthouse",
                      "M60", "Panther", "Playground", "Train"]
ADVANCED_SCANS = ["Auditorium", "Ballroom", "Courtroom",
                  "Museum", "Palace", "Temple"]


class TanksDataset:
    def __init__(self, datapath, split="intermediate", nviews=7,
                 img_wh=(1920, 1056), ndepths=192, **kwargs):
        self.datapath = Path(datapath)
        self.split = split
        self.nviews = nviews
        self.img_wh = img_wh
        self.ndepths = ndepths
        self.scans = (INTERMEDIATE_SCANS if split == "intermediate"
                      else ADVANCED_SCANS)
        self.metas = []
        for scan in self.scans:
            pair = read_pair_file(self.datapath / split / scan / "pair.txt")
            for ref, srcs in pair:
                self.metas.append((scan, ref, srcs))
        self._hw_cache: dict = {}

    def __len__(self):
        return len(self.metas)

    def _scan_hw(self, scan):
        """Native (h, w) of the scene's first image (decoded once per
        scene and cached) — T&T scenes are single-resolution captures."""
        if scan not in self._hw_cache:
            vid = next(r for s, r, _ in self.metas if s == scan)
            img = read_image(self.datapath / self.split / scan /
                             "images" / f"{vid:08d}.jpg")
            self._hw_cache[scan] = img.shape[:2]
        return self._hw_cache[scan]

    def sample_cams(self, idx):
        """proj_matrices + depth_values of sample idx WITHOUT decoding its
        images — cheap per-view geometry for the Pallas warp band-coverage
        probes (cli/eval_dtu.pick_fast_path), mirroring __getitem__'s
        intrinsic rescale from the scene's native size to img_wh."""
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]
        W, H = self.img_wh
        h, w = self._scan_hw(scan)

        proj_matrices, depth_values = [], None
        for i, vid in enumerate(view_ids):
            cam = read_cam_file(self.datapath / self.split / scan /
                                "cams_1" / f"{vid:08d}_cam.txt")
            intr = cam.intrinsics.copy()
            intr[:2, :] /= 4.0
            intr[0, :] *= W / w
            intr[1, :] *= H / h
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = cam.extrinsics
            proj[1, :3, :3] = intr
            proj_matrices.append(proj)
            if i == 0:
                depth_min = cam.depth_min
                depth_max = cam.depth_interval  # line-11 field 2 IS max
                interval = (depth_max - depth_min) / (self.ndepths - 1)
                depth_values = np.arange(
                    depth_min, interval * (self.ndepths - 0.5) + depth_min,
                    interval, dtype=np.float32)
        proj_matrices = np.stack(proj_matrices)
        stage2 = proj_matrices.copy()
        stage2[:, 1, :2, :] *= 2
        stage3 = proj_matrices.copy()
        stage3[:, 1, :2, :] *= 4
        return {"proj_matrices": {"stage1": proj_matrices, "stage2": stage2,
                                  "stage3": stage3},
                "depth_values": depth_values, "hw": (H, W)}

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]
        W, H = self.img_wh

        imgs, proj_matrices = [], []
        depth_values = None
        for i, vid in enumerate(view_ids):
            img = read_image(self.datapath / self.split / scan /
                             "images" / f"{vid:08d}.jpg")
            cam = read_cam_file(self.datapath / self.split / scan /
                                "cams_1" / f"{vid:08d}_cam.txt")
            intr = cam.intrinsics.copy()
            intr[:2, :] /= 4.0
            h, w = img.shape[:2]
            intr[0, :] *= W / w
            intr[1, :] *= H / h
            import cv2
            img = cv2.resize(img, (W, H))
            imgs.append(T.normalize_imagenet(img))

            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = cam.extrinsics
            proj[1, :3, :3] = intr
            proj_matrices.append(proj)
            if i == 0:
                depth_min = cam.depth_min
                depth_max = cam.depth_interval  # line-11 field 2 IS max here
                interval = (depth_max - depth_min) / (self.ndepths - 1)
                depth_values = np.arange(
                    depth_min, interval * (self.ndepths - 0.5) + depth_min,
                    interval, dtype=np.float32)

        proj_matrices = np.stack(proj_matrices)
        stage2 = proj_matrices.copy()
        stage2[:, 1, :2, :] *= 2
        stage3 = proj_matrices.copy()
        stage3[:, 1, :2, :] *= 4
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": {"stage1": proj_matrices, "stage2": stage2,
                              "stage3": stage3},
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
        }
