"""DTU training dataset (Yao Yao preprocessing layout).

Parity target: the reference's datasets/dtu_train.py — metas = scan × 49 ref
views × 7 lights; per sample: three image variants (ImageNet-normalized,
jitter+gamma-augmented, per-image-centered), stage projection pyramids,
GT depth/mask pyramids (monitoring only), full sweep depth_values with
interval_scale 1.06, and the NeRF extras (full-res depths, w2cs/c2ws,
×4 intrinsics, near/far).

Layout on disk:
  Cameras/pair.txt, Cameras/train/{vid:08d}_cam.txt
  Rectified/{scan}_train/rect_{vid+1:03d}_{light}_r5000.png   (512×640)
  Depths_raw/{scan}/depth_map_{vid:04d}.pfm, depth_visual_{vid:04d}.png
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.io import read_cam_file, read_pair_file, read_pfm
from . import transforms as T


class DTUTrainDataset:
    def __init__(self, datapath, listfile, mode="train", nviews=4,
                 ndepths=192, interval_scale=1.06, seed=0,
                 random_view=False, **kwargs):
        self.datapath = Path(datapath)
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.random_view = random_view  # dtu_train.py:232-238
        self.rs = np.random.RandomState(seed)

        if isinstance(listfile, (list, tuple)):
            scans = list(listfile)
        else:
            scans = [l.strip() for l in open(listfile) if l.strip()]
        pairs = read_pair_file(self.datapath / "Cameras" / "pair.txt")
        self.metas = [(scan, light, ref, srcs)
                      for scan in scans
                      for ref, srcs in pairs
                      for light in range(7)]

        # NeRF-extra camera tables (full-res ×4 intrinsics), mirroring
        # build_proj_mats at dtu_train.py:31-53
        ids = sorted({v for _, _, ref, srcs in self.metas
                      for v in [ref] + srcs})
        self.cam_table = {}
        for vid in ids:
            cam = read_cam_file(
                self.datapath / "Cameras" / "train" / f"{vid:08d}_cam.txt")
            intr4 = cam.intrinsics.copy()
            intr4[:2] *= 4
            near_far = [cam.depth_min,
                        cam.depth_min + cam.depth_interval
                        * self.interval_scale * self.ndepths]
            self.cam_table[vid] = (intr4, cam.extrinsics,
                                   np.linalg.inv(cam.extrinsics).astype(np.float32),
                                   np.asarray(near_far, np.float32))

    def __len__(self):
        return len(self.metas)

    def sample_cams_all(self):
        """Camera-only probes for the Pallas warp band-coverage check
        (cli/eval_dtu.pick_fast_path): one entry per unique reference
        view, each carrying ALL of its pair-file source views.

        DTU's training camera rig is global (Cameras/train/*_cam.txt is
        shared by every scan) and depth_values depend only on the ref
        view's cam file, so coverage over these probes implies coverage
        of every (scan, light, src-subset) training sample — including
        random_view subsets, since check_group_coverage tests each source
        view independently against the reference."""
        pairs = {}
        for _, _, ref, srcs in self.metas:
            pairs.setdefault(ref, srcs)
        cams = []
        for ref, srcs in sorted(pairs.items()):
            view_ids = [ref] + list(srcs)
            proj = np.zeros((len(view_ids), 2, 4, 4), np.float32)
            depth_values = None
            for i, vid in enumerate(view_ids):
                cam = read_cam_file(self.datapath / "Cameras" / "train" /
                                    f"{vid:08d}_cam.txt")
                proj[i, 0] = cam.extrinsics
                proj[i, 1, :3, :3] = cam.intrinsics
                if i == 0:
                    interval = cam.depth_interval * self.interval_scale
                    depth_values = np.arange(
                        cam.depth_min,
                        cam.depth_min + interval * self.ndepths,
                        interval, dtype=np.float32)[: self.ndepths]
            stage2 = proj.copy()
            stage2[:, 1, :2, :] *= 2
            stage3 = proj.copy()
            stage3[:, 1, :2, :] *= 4
            cams.append({"proj_matrices": {"stage1": proj, "stage2": stage2,
                                           "stage3": stage3},
                         "depth_values": depth_values,
                         "hw": (512, 640)})
        return cams

    def _read_image(self, scan, vid, light):
        from ..core.io import read_image
        return read_image(self.datapath / "Rectified" / f"{scan}_train" /
                          f"rect_{vid + 1:03d}_{light}_r5000.png")

    def _read_depth_full(self, path):
        """High-res GT depth → 512×640 via ½ nearest + crop
        (read_depth_all, dtu_train.py:196-206)."""
        import cv2
        depth = np.asarray(read_pfm(path)[0], np.float32)
        depth = cv2.resize(depth, None, fx=0.5, fy=0.5,
                           interpolation=cv2.INTER_NEAREST)
        return depth[44:556, 80:720]

    def __getitem__(self, idx):
        scan, light, ref_view, src_views = self.metas[idx]
        if self.random_view:
            picks = self.rs.permutation(len(src_views))[: self.nviews - 1]
            view_ids = [ref_view] + [src_views[i] for i in picks]
        else:
            view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, imgs_aug, center_imgs = [], [], []
        proj_matrices, depths_h = [], []
        w2cs, c2ws, intrinsics_nerf, near_fars = [], [], [], []
        depth_ms = mask_ms = depth_values = None

        for i, vid in enumerate(view_ids):
            raw = self._read_image(scan, vid, light)  # [H,W,3] in [0,1]
            imgs.append(T.normalize_imagenet(raw))
            aug = T.random_gamma(self.rs, T.color_jitter(self.rs, raw))
            imgs_aug.append(T.normalize_imagenet(aug))
            center_imgs.append(T.center_image(raw * 255.0))

            cam = read_cam_file(
                self.datapath / "Cameras" / "train" / f"{vid:08d}_cam.txt")
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = cam.extrinsics
            proj[1, :3, :3] = cam.intrinsics
            proj_matrices.append(proj)

            intr4, extr, c2w, near_far = self.cam_table[vid]
            intrinsics_nerf.append(intr4)
            w2cs.append(extr)
            c2ws.append(c2w)
            near_fars.append(near_far)

            depth_path = (self.datapath / "Depths_raw" / scan /
                          f"depth_map_{vid:04d}.pfm")
            if depth_path.exists():
                depths_h.append(self._read_depth_full(depth_path))
            else:
                depths_h.append(np.zeros((1, 1), np.float32))

            if i == 0:
                interval = cam.depth_interval * self.interval_scale
                depth_values = np.arange(
                    cam.depth_min, cam.depth_min + interval * self.ndepths,
                    interval, dtype=np.float32)[: self.ndepths]
                import cv2
                from PIL import Image
                mask_img = np.asarray(Image.open(
                    self.datapath / "Depths_raw" / scan /
                    f"depth_visual_{vid:04d}.png"), np.float32)
                mask = T.prepare_img((mask_img > 10).astype(np.float32))
                mask_ms = T.stage_pyramid(mask)
                depth = T.prepare_img(
                    np.asarray(read_pfm(depth_path)[0], np.float32))
                depth_ms = T.stage_pyramid(depth)

        proj_matrices = np.stack(proj_matrices)
        stage2 = proj_matrices.copy()
        stage2[:, 1, :2, :] *= 2
        stage3 = proj_matrices.copy()
        stage3[:, 1, :2, :] *= 4

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "imgs_aug": np.stack(imgs_aug).astype(np.float32),
            "center_imgs": np.stack(center_imgs).astype(np.float32),
            "proj_matrices": {"stage1": proj_matrices, "stage2": stage2,
                              "stage3": stage3},
            "depth": depth_ms, "mask": mask_ms,
            "depth_values": depth_values,
            "depths_h": np.stack(depths_h).astype(np.float32),
            "w2cs": np.stack(w2cs).astype(np.float32),
            "c2ws": np.stack(c2ws).astype(np.float32),
            "intrinsics": np.stack(intrinsics_nerf).astype(np.float32),
            "near_fars": np.stack(near_fars).astype(np.float32),
        }
