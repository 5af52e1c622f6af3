"""DTU evaluation dataset: full-res images scaled to ≤(max_w, max_h)
rounded down to /32, ImageNet-normalized; stage-1 intrinsics pre-divided
by 4.

Parity target: the reference's datasets/dtu_test.py (incl. its cam-file
variant that rescales depth_interval when the depth line carries a third
field, :98-103).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.io import read_cam_file, read_image, read_pair_file
from . import transforms as T


class DTUTestDataset:
    def __init__(self, datapath, listfile, mode="test", nviews=5,
                 ndepths=192, interval_scale=1.06, max_h=1200, max_w=1600,
                 **kwargs):
        self.datapath = Path(datapath)
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.max_h, self.max_w = max_h, max_w
        if isinstance(listfile, (list, tuple)):
            scans = list(listfile)
        else:
            scans = [l.strip() for l in open(listfile) if l.strip()]
        self.metas = []
        for scan in scans:
            for ref, srcs in self._pairs(scan):
                if len(srcs) < self.nviews:
                    srcs = srcs + [srcs[0]] * (self.nviews - len(srcs))
                self.metas.append((scan, ref, srcs))
        self._hw_cache: dict = {}

    def __len__(self):
        return len(self.metas)

    def _scan_hw(self, scan):
        """Native (h, w) of the scan's first image, decoded once per scan
        and cached — __getitem__ aligns every view to the ref view's
        resolution, so cams-only probes use the same dims."""
        if scan not in self._hw_cache:
            vid = next(r for s, r, _ in self.metas if s == scan)
            self._hw_cache[scan] = self._image(scan, vid).shape[:2]
        return self._hw_cache[scan]

    def _pairs(self, scan):
        """The scan's (ref view, [src views]) in pair-file order."""
        return read_pair_file(self.datapath / scan / "pair.txt")

    def _image(self, scan, vid):
        """View vid's image, float32 RGB in [0, 1] (HWC)."""
        path = self.datapath / scan / "images_post" / f"{vid:08d}.jpg"
        if not path.exists():
            path = self.datapath / scan / "images" / f"{vid:08d}.jpg"
        return read_image(path)

    def _cam_file(self, scan, vid):
        """View vid's parsed cam file (`core.io.CameraFile`)."""
        return read_cam_file(
            self.datapath / scan / "cams" / f"{vid:08d}_cam.txt")

    def sample_cams(self, idx):
        """proj_matrices + depth_values of sample idx WITHOUT decoding its
        images — cheap enough to probe EVERY reference view's geometry
        against the Pallas warp kernel's band-coverage precondition
        (cli/eval_dtu.pick_fast_path). Intrinsics use the scan's cached
        first-image size, the dims __getitem__ aligns all views to."""
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]
        h, w = self._scan_hw(scan)
        new_h, new_w = T.scaled_mvs_dims(h, w, self.max_w, self.max_h)

        proj_matrices, depth_values = [], None
        for i, vid in enumerate(view_ids):
            intr, extr, depth_min, depth_interval = self._read_cam(scan, vid)
            intr = T.scale_mvs_intrinsics(intr, h, w, new_h, new_w)
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extr
            proj[1, :3, :3] = intr
            proj_matrices.append(proj)
            if i == 0:
                depth_values = np.arange(
                    depth_min,
                    depth_interval * (self.ndepths - 0.5) + depth_min,
                    depth_interval, dtype=np.float32)
        proj_matrices = np.stack(proj_matrices)
        stage2 = proj_matrices.copy()
        stage2[:, 1, :2, :] *= 2
        stage3 = proj_matrices.copy()
        stage3[:, 1, :2, :] *= 4
        return {"proj_matrices": {"stage1": proj_matrices, "stage2": stage2,
                                  "stage3": stage3},
                "depth_values": depth_values, "hw": (new_h, new_w)}

    def _read_cam(self, scan, vid):
        cam = self._cam_file(scan, vid)
        intr = cam.intrinsics.copy()
        intr[:2, :] /= 4.0
        depth_interval = cam.depth_interval
        if cam.num_depth is not None:
            depth_max = cam.depth_min + cam.num_depth * depth_interval
            depth_interval = (depth_max - cam.depth_min) / self.ndepths
        depth_interval *= self.interval_scale
        return intr, cam.extrinsics, cam.depth_min, depth_interval

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, proj_matrices = [], []
        depth_values = None
        s_h = s_w = None
        for i, vid in enumerate(view_ids):
            img = self._image(scan, vid)
            intr, extr, depth_min, depth_interval = self._read_cam(scan, vid)
            img, intr = T.scale_mvs_input(img, intr, self.max_w, self.max_h)
            if i == 0:
                s_h, s_w = img.shape[:2]
            elif img.shape[:2] != (s_h, s_w):
                # align src views to the ref view's standard resolution
                # (mixed native sizes — reference dtu_test.py:176-196)
                import cv2
                intr[0, :] *= s_w / img.shape[1]
                intr[1, :] *= s_h / img.shape[0]
                img = cv2.resize(img, (s_w, s_h))
            imgs.append(T.normalize_imagenet(img))

            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extr
            proj[1, :3, :3] = intr
            proj_matrices.append(proj)
            if i == 0:
                depth_values = np.arange(
                    depth_min, depth_interval * (self.ndepths - 0.5) + depth_min,
                    depth_interval, dtype=np.float32)

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
