"""Depth-map filtering and point-cloud fusion (photometric + geometric
consistency), CPU/numpy.

Parity targets in the reference's eval_rcmvsnet_dtu.py:
  * reproject_with_depth        — :281-318 (ref→src project, bilinear
    sample src depth, project back)
  * check_geometric_consistency — :321-336 (px dist < thresh AND relative
    depth diff < thresh)
  * filter_depth                — :339-454 (confidence > prob_thresh,
    ≥ num_consistent geometric votes, depth averaged over consistent views,
    unproject masked pixels to a colored world point cloud)
  * per-scan pixel thresholds   — :473-496
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

DTU_IMG_DIST_THRESHOLDS = {
    1: 0.5, 4: 0.5, 9: 0.5, 10: 0.25, 11: 0.75, 12: 0.25, 13: 0.75,
    15: 0.5, 23: 0.5, 24: 0.5, 29: 0.5, 32: 0.5, 33: 0.5, 34: 0.25,
    48: 0.75, 49: 0.5, 62: 0.5, 75: 0.25, 77: 0.25, 110: 0.25, 114: 0.5,
    118: 0.75,
}


def _bilinear_map(img, x, y):
    """cv2.remap(INTER_LINEAR)-equivalent bilinear sampling with border
    clamp; out-of-range coords produce 0 like cv2's default border."""
    import cv2
    return cv2.remap(img, x.astype(np.float32), y.astype(np.float32),
                     interpolation=cv2.INTER_LINEAR)


def reproject_with_depth(depth_ref, intr_ref, extr_ref,
                         depth_src, intr_src, extr_src):
    """Project ref depth into src, sample src depth, project back.

    Returns (depth_reprojected, x2d_reprojected, y2d_reprojected,
    x2d_src, y2d_src), all [H, W].
    """
    height, width = depth_ref.shape
    x_ref, y_ref = np.meshgrid(np.arange(width), np.arange(height))
    x_ref, y_ref = x_ref.reshape(-1), y_ref.reshape(-1)

    xyz_ref = np.linalg.inv(intr_ref) @ (
        np.vstack((x_ref, y_ref, np.ones_like(x_ref))) * depth_ref.reshape(-1))
    xyz_src = (extr_src @ np.linalg.inv(extr_ref) @
               np.vstack((xyz_ref, np.ones_like(x_ref))))[:3]
    k_xyz_src = intr_src @ xyz_src
    xy_src = k_xyz_src[:2] / k_xyz_src[2:3]

    x_src = xy_src[0].reshape(height, width).astype(np.float32)
    y_src = xy_src[1].reshape(height, width).astype(np.float32)
    sampled_depth_src = _bilinear_map(depth_src, x_src, y_src)

    xyz_src2 = np.linalg.inv(intr_src) @ (
        np.vstack((xy_src, np.ones_like(x_ref))) * sampled_depth_src.reshape(-1))
    xyz_reproj = (extr_ref @ np.linalg.inv(extr_src) @
                  np.vstack((xyz_src2, np.ones_like(x_ref))))[:3]
    depth_reproj = xyz_reproj[2].reshape(height, width).astype(np.float32)
    k_xyz_reproj = intr_ref @ xyz_reproj
    with np.errstate(divide="ignore", invalid="ignore"):
        xy_reproj = k_xyz_reproj[:2] / k_xyz_reproj[2:3]
    x_reproj = xy_reproj[0].reshape(height, width).astype(np.float32)
    y_reproj = xy_reproj[1].reshape(height, width).astype(np.float32)
    return depth_reproj, x_reproj, y_reproj, x_src, y_src


def check_geometric_consistency(depth_ref, intr_ref, extr_ref, depth_src,
                                intr_src, extr_src, img_dist_thresh,
                                depth_thresh):
    """mask where reprojection < img_dist_thresh px AND |Δd|/d < depth_thresh."""
    height, width = depth_ref.shape
    x_ref, y_ref = np.meshgrid(np.arange(width), np.arange(height))
    depth_reproj, x2d, y2d, x2d_src, y2d_src = reproject_with_depth(
        depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src)
    dist = np.sqrt((x2d - x_ref) ** 2 + (y2d - y_ref) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        relative = np.abs(depth_reproj - depth_ref) / depth_ref
    mask = np.logical_and(dist < img_dist_thresh, relative < depth_thresh)
    depth_reproj = depth_reproj.copy()
    depth_reproj[~mask] = 0
    return mask, depth_reproj, x2d_src, y2d_src


def filter_depth_views(ref_depth, ref_conf, ref_img, ref_intr, ref_extr,
                       src_depths, src_intrs, src_extrs,
                       prob_threshold=0.8, num_consistent=3,
                       img_dist_thresh=0.5, depth_thresh=0.01):
    """Fuse one reference view against its sources.

    Returns (xyz_world [N,3], colors [N,3] float in [0,1], final_mask,
    photo_mask, geo_mask).
    """
    photo_mask = ref_conf > prob_threshold
    geo_mask_sum = 0
    depth_sum = 0
    for depth_src, intr_src, extr_src in zip(src_depths, src_intrs, src_extrs):
        geo_mask, depth_reproj, _, _ = check_geometric_consistency(
            ref_depth, ref_intr, ref_extr, depth_src, intr_src, extr_src,
            img_dist_thresh, depth_thresh)
        geo_mask_sum = geo_mask_sum + geo_mask.astype(np.int32)
        depth_sum = depth_sum + depth_reproj
    depth_avg = (depth_sum + ref_depth) / (geo_mask_sum + 1)
    geo_mask = geo_mask_sum >= num_consistent
    final_mask = np.logical_and(photo_mask, geo_mask)

    height, width = ref_depth.shape
    x, y = np.meshgrid(np.arange(width), np.arange(height))
    xs, ys, ds = x[final_mask], y[final_mask], depth_avg[final_mask]
    colors = ref_img[final_mask]
    xyz_ref = np.linalg.inv(ref_intr) @ (np.vstack((xs, ys, np.ones_like(xs))) * ds)
    xyz_world = (np.linalg.inv(ref_extr) @
                 np.vstack((xyz_ref, np.ones_like(xs))))[:3].T
    return xyz_world.astype(np.float32), colors, final_mask, photo_mask, geo_mask


def fuse_scan(scan_dir, pair_file, ply_out, prob_threshold=0.8,
              num_consistent=3, img_dist_thresh=0.5, depth_thresh=0.01,
              save_masks=True):
    """Fuse all reference views of a scan directory produced by eval
    (depth_est/, confidence/, cams/, images/) into one colored .ply.

    Matches filter_depth at the reference's eval_rcmvsnet_dtu.py:339-454.
    """
    from ..core.io import read_cam_file, read_image, read_pair_file, read_pfm, save_ply
    scan_dir = Path(scan_dir)
    pair_data = read_pair_file(pair_file)

    vertices, colors = [], []
    for ref_view, src_views in pair_data:
        cam = read_cam_file(scan_dir / "cams" / f"{ref_view:08d}_cam.txt")
        ref_depth = read_pfm(scan_dir / "depth_est" / f"{ref_view:08d}.pfm")[0]
        ref_conf = read_pfm(scan_dir / "confidence" / f"{ref_view:08d}.pfm")[0]
        ref_img = read_image(scan_dir / "images" / f"{ref_view:08d}.jpg")

        src_depths, src_intrs, src_extrs = [], [], []
        for sv in src_views:
            scam = read_cam_file(scan_dir / "cams" / f"{sv:08d}_cam.txt")
            src_depths.append(read_pfm(scan_dir / "depth_est" / f"{sv:08d}.pfm")[0])
            src_intrs.append(scam.intrinsics)
            src_extrs.append(scam.extrinsics)

        xyz, col, final_mask, photo_mask, geo_mask = filter_depth_views(
            ref_depth, ref_conf, ref_img, cam.intrinsics, cam.extrinsics,
            src_depths, src_intrs, src_extrs, prob_threshold, num_consistent,
            img_dist_thresh, depth_thresh)
        vertices.append(xyz)
        colors.append((col * 255).astype(np.uint8))

        if save_masks:
            import cv2
            from PIL import Image
            mask_dir = scan_dir / "mask"
            mask_dir.mkdir(exist_ok=True)
            for name, m in [("photo", photo_mask), ("geo", geo_mask),
                            ("final", final_mask)]:
                Image.fromarray((m.astype(np.uint8)) * 255).save(
                    mask_dir / f"{ref_view:08d}_{name}.png")
            # filtered-depth visualization (eval_rcmvsnet_dtu.py:399-401)
            fd_dir = scan_dir / "filtered_depth"
            fd_dir.mkdir(exist_ok=True)
            fd = ref_depth * final_mask.astype(np.float32)
            rng = max(fd.max() - fd.min(), 1e-8)
            cv2.imwrite(str(fd_dir / f"{ref_view:08d}.jpg"),
                        cv2.applyColorMap(
                            ((fd - fd.min()) / rng * 255).astype(np.uint8),
                            cv2.COLORMAP_JET))

    xyz = np.concatenate(vertices, axis=0)
    rgb = np.concatenate(colors, axis=0)
    save_ply(ply_out, xyz, rgb)
    return xyz.shape[0]
