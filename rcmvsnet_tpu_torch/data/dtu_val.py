"""DTU validation dataset: minimal samples for supervised monitoring.

Parity target: the reference's datasets/dtu_yao.py — raw [0,1] images (NO
ImageNet normalization), stage projection pyramids, GT depth/mask pyramids,
full sweep depth_values. Used as the per-epoch test loader with 5 views
(train_rcmvsnet.py:589-590).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.io import read_cam_file, read_image, read_pair_file, read_pfm
from . import transforms as T


class DTUValDataset:
    def __init__(self, datapath, listfile, mode="test", nviews=5,
                 ndepths=192, interval_scale=1.06, **kwargs):
        self.datapath = Path(datapath)
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        if isinstance(listfile, (list, tuple)):
            scans = list(listfile)
        else:
            scans = [l.strip() for l in open(listfile) if l.strip()]
        pairs = read_pair_file(self.datapath / "Cameras" / "pair.txt")
        self.metas = [(scan, light, ref, srcs)
                      for scan in scans
                      for ref, srcs in pairs
                      for light in range(7)]

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        scan, light, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, proj_matrices = [], []
        depth_ms = mask_ms = depth_values = None
        for i, vid in enumerate(view_ids):
            imgs.append(read_image(
                self.datapath / "Rectified" / f"{scan}_train" /
                f"rect_{vid + 1:03d}_{light}_r5000.png"))
            cam = read_cam_file(
                self.datapath / "Cameras" / "train" / f"{vid:08d}_cam.txt")
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = cam.extrinsics
            proj[1, :3, :3] = cam.intrinsics
            proj_matrices.append(proj)

            if i == 0:
                interval = cam.depth_interval * self.interval_scale
                depth_values = np.arange(
                    cam.depth_min, cam.depth_min + interval * self.ndepths,
                    interval, dtype=np.float32)[: self.ndepths]
                from PIL import Image
                mask_img = np.asarray(Image.open(
                    self.datapath / "Depths_raw" / scan /
                    f"depth_visual_{vid:04d}.png"), np.float32)
                mask_ms = T.stage_pyramid(
                    T.prepare_img((mask_img > 10).astype(np.float32)))
                depth = T.prepare_img(np.asarray(read_pfm(
                    self.datapath / "Depths_raw" / scan /
                    f"depth_map_{vid:04d}.pfm")[0], np.float32))
                depth_ms = T.stage_pyramid(depth)

        proj_matrices = np.stack(proj_matrices)
        stage2 = proj_matrices.copy()
        stage2[:, 1, :2, :] *= 2
        stage3 = proj_matrices.copy()
        stage3[:, 1, :2, :] *= 4
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": {"stage1": proj_matrices, "stage2": stage2,
                              "stage3": stage3},
            "depth": depth_ms, "mask": mask_ms,
            "depth_values": depth_values,
        }
