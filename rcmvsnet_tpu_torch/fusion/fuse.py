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


# The reference samples with cv2.remap(img, x, y, INTER_LINEAR) on float32
# maps (constant border 0). `_bilinear_map` is that call in numpy, equal in
# every bit to OpenCV 5.0's x86-64 build with AVX2 (its `remap` runs each
# map row in vector steps of _VEC output pixels, two AVX2 registers of
# _VEC // 2 lanes, then one pixel at a time for the rest of the row):
#   * ix = floor(x) as int32 (INT_MIN for NaN, ±inf and |x| ≥ 2^31), the
#     weight a = x − float32(ix); likewise iy and b;
#   * taps outside the image read 0, one by one; the blend is
#     v0 = fma(a, p01 − p00, p00), v1 = fma(a, p11 − p10, p10),
#     out = fma(b, v1 − v0, v0), each FMA rounded once;
#   * a pixel whose 2×2 block misses the image (ix ∉ [−1, w − 1] or
#     iy ∉ [−1, h − 1]) gives 0 in the per-pixel tail; a vector step gives
#     0 only where none of its pixels touches the image, and otherwise
#     blends every lane, so a NaN or ±inf coordinate gives NaN there: x's
#     NaN (quieted) or, for ±inf, x86's default NaN, else y's; where both
#     are NaN, a 1-channel image's upper register takes y's.
_VEC = 16
_QUIET = np.uint32(0x00400000)
_DEFAULT_NAN = np.uint32(0xFFC00000)
_INT_MIN = -2 ** 31


def _fma(a, b, c):
    """float32 a·b + c rounded once, computed in float64: the product is
    exact there, and a sum that lands on a float32 midpoint is moved to the
    side of its exact float64 error (TwoSum) before rounding."""
    a, b, c = (np.asarray(t, np.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.where(s > r, np.nextafter(r, np.float32(np.inf)),
                     np.nextafter(r, np.float32(-np.inf)))
    tie = (s == (r.astype(np.float64) + other) * 0.5) & (err != 0)
    return np.where(tie & ((other > r) == (err > 0)), other, r)


def _floor_i32(c):
    with np.errstate(invalid="ignore"):   # signaling NaNs
        f = np.floor(c.astype(np.float64))
        ok = (f >= _INT_MIN) & (f < 2 ** 31)
    return np.where(ok, f, _INT_MIN).astype(np.int64)


def _nan_bits(c):
    """The NaN a non-finite coordinate gives: its own, quieted, or for ±inf
    the default NaN (inf·0)."""
    return np.where(np.isnan(c), c.view(np.uint32) | _QUIET, _DEFAULT_NAN)


def _bilinear_map(img, x, y):
    """cv2.remap(img, x, y, INTER_LINEAR) with the default constant border
    0, in numpy (see the rules above): img float32 [h, w] or [h, w, ch],
    x and y float32 maps [H, W] of source pixel coordinates."""
    img = np.asarray(img)
    if img.dtype != np.float32:
        raise TypeError(f"_bilinear_map samples float32 images, not "
                        f"{img.dtype}")
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    h, w = img.shape[:2]
    ix, iy = _floor_i32(x), _floor_i32(y)
    finite = np.isfinite(x) & np.isfinite(y)
    with np.errstate(invalid="ignore"):
        a = np.where(finite, x - ix.astype(np.float32), np.float32(0))
        b = np.where(finite, y - iy.astype(np.float32), np.float32(0))
    chans = img[..., None] if img.ndim == 2 else img

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = chans[np.where(inside, yy, 0), np.where(inside, xx, 0)]
        return np.where(inside[..., None], v, np.float32(0))

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    a, b = a[..., None], b[..., None]
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    out = _fma(b, v1 - v0, v0)

    upper = (np.arange(x.shape[1]) % _VEC >= _VEC // 2) & (img.ndim == 2)
    nan = np.where(np.isfinite(x) | (np.isnan(y) & upper), _nan_bits(y),
                   _nan_bits(x))
    out = np.where(finite[..., None], out, nan.view(np.float32)[..., None])

    touch = (ix >= -1) & (ix < w) & (iy >= -1) & (iy < h)
    n_vec = x.shape[1] // _VEC * _VEC
    steps = touch[:, :n_vec].reshape(len(x), -1, _VEC).any(-1)
    keep = np.concatenate([np.repeat(steps, _VEC, axis=1),
                           touch[:, n_vec:]], axis=1)
    out = np.where(keep[..., None], out, np.float32(0))
    return out[..., 0] if img.ndim == 2 else out


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
