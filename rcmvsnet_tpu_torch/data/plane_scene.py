"""An in-memory textured-plane scene and the eval samples of its views.

The geometry of `data/synthetic.make_synthetic_views` with a scipy cubic
texture, so it builds where there is no cv2 (`chip_smoke.py` and the
profiling tools run on such hosts). Samples follow each test loader's own
depth-range convention:
  * `dtu_samples`: `data/dtu_test.py` (cam line 11 = min and interval,
    scaled by `interval_scale`);
  * `tanks_samples`: `data/tanks.py` (line 11 = min and *max*, ndepth − 1
    intervals).
`plane_items` makes in-memory train or val datasets of such scenes, keyed
as `data/dtu_train.py` / `data/dtu_val.py` items, for `cli/train.fit`.
"""
from __future__ import annotations

import numpy as np

from .transforms import IMAGENET_MEAN, IMAGENET_STD


def plane_scene(H, W, V, seed, depth0=600.0, baseline=8.0, tilt=0.08):
    """V views of the tilted textured plane z = depth0 + tilt·x_world seen
    by cameras translated along x. Returns images [V, H, W, 3] in [0, 1],
    intrinsics, extrinsics [V, 4, 4], depths [V, H, W], depth_min,
    depth_max."""
    from scipy import ndimage
    rs = np.random.RandomState(seed)
    f = 1.2 * max(H, W)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float64)
    n = np.array([-tilt, 0.0, 1.0])
    n /= np.linalg.norm(n)
    d = depth0 * n[2]
    th, tw = 4 * H, 4 * W
    small = rs.rand(th // 8 + 2, tw // 8 + 2, 3)
    tex = np.stack([ndimage.zoom(small[..., c], (th / small.shape[0],
                                                 tw / small.shape[1]),
                                 order=3) for c in range(3)], -1)
    tex = tex[:th, :tw].clip(0, 1).astype(np.float32)

    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    images, extr, depths = [], [], []
    for v in range(V):
        E = np.eye(4)
        E[0, 3] = -v * baseline
        c = np.array([v * baseline, 0.0, 0.0])
        t = (d - c @ n) / (rays @ n)
        pts = c + t[..., None] * rays
        u = (pts[..., 0] / depth0 * f * 0.25 + 2 * W).clip(0, tw - 1)
        w_ = (pts[..., 1] / depth0 * f * 0.25 + 2 * H).clip(0, th - 1)
        x0 = np.floor(u).astype(int)
        y0 = np.floor(w_).astype(int)
        x1 = np.minimum(x0 + 1, tw - 1)
        y1 = np.minimum(y0 + 1, th - 1)
        ax = (u - x0)[..., None]
        ay = (w_ - y0)[..., None]
        img = (tex[y0, x0] * (1 - ax) * (1 - ay) + tex[y0, x1] * ax * (1 - ay)
               + tex[y1, x0] * (1 - ax) * ay + tex[y1, x1] * ax * ay)
        images.append(img.astype(np.float32))
        extr.append(E.astype(np.float32))
        depths.append(pts[..., 2].astype(np.float32))   # world z = cam z
    return {"images": np.stack(images), "intrinsics": K.astype(np.float32),
            "extrinsics": np.stack(extr), "depths": np.stack(depths),
            "depth_min": depth0 * 0.8, "depth_max": depth0 * 1.25}


def _samples(scene, dvals):
    """One sample per reference view (ref first, then the others in
    order): stage-1 intrinsics at 1/4, stage 2/3 at 1/2 and 1."""
    nv = len(scene["images"])
    samples = []
    for ref in range(nv):
        views = [ref] + [v for v in range(nv) if v != ref]
        proj = np.zeros((nv, 2, 4, 4), np.float32)
        for i, v in enumerate(views):
            proj[i, 0] = scene["extrinsics"][v]
            proj[i, 1, :3, :3] = scene["intrinsics"]
            proj[i, 1, :2] /= 4.0
        pm = {"stage1": proj, "stage2": proj.copy(), "stage3": proj.copy()}
        pm["stage2"][:, 1, :2] *= 2
        pm["stage3"][:, 1, :2] *= 4
        samples.append({
            "imgs": ((scene["images"][views] - IMAGENET_MEAN)
                     / IMAGENET_STD).astype(np.float32),
            "proj_matrices": pm, "depth_values": dvals})
    return samples


def dtu_samples(scene, ndepth, interval_scale=1.06):
    """Samples as the DTU test loader builds them: depth_values from the
    cam file's min and interval ((max − min) / ndepth here)."""
    near = scene["depth_min"]
    interval = (scene["depth_max"] - near) / ndepth * interval_scale
    return _samples(scene, np.arange(near, interval * (ndepth - 0.5) + near,
                                     interval, dtype=np.float32))


def tanks_samples(scene, ndepth):
    """Samples as the Tanks & Temples loader builds them: ndepth values
    from min to max, interval (max − min) / (ndepth − 1)."""
    near, far = scene["depth_min"], scene["depth_max"]
    interval = (far - near) / (ndepth - 1)
    return _samples(scene, np.arange(near, interval * (ndepth - 0.5) + near,
                                     interval, dtype=np.float32))


def plane_items(n, H, W, V, ndepth, seed, val=False):
    """n items, one plane scene each (seeds seed .. seed + n − 1): train
    items as `data/synthetic.batch_from_views` builds them (the DTU train
    item's keys), or with val the val item's keys (raw [0, 1] images,
    projections, depth_values, depth and mask pyramids)."""
    from .synthetic import batch_from_views
    items = []
    for i in range(n):
        scene = plane_scene(H, W, V, seed + i)
        batch = batch_from_views([scene], ndepth, seed + i)
        batch.pop("w_aug")
        item = {k: ({kk: vv[0] for kk, vv in v.items()}
                    if isinstance(v, dict) else v[0])
                for k, v in batch.items()}
        if val:
            item = {"imgs": scene["images"],
                    **{k: item[k] for k in ("proj_matrices", "depth_values",
                                            "depth", "mask")}}
        items.append(item)
    return items
