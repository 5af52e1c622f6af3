"""Synthetic multi-view data: a textured fronto-parallel plane observed by
laterally-translated pinhole cameras. Geometrically exact, so it exercises
the full pipeline (warping, cost volumes, losses, fusion) without DTU on
disk. This backs the test pyramid the reference lacks (SURVEY.md §4).
"""
from __future__ import annotations

import numpy as np

from .transforms import IMAGENET_MEAN, IMAGENET_STD


def _smooth_texture(rs, h, w, upscale=8):
    import cv2
    small = rs.rand(h // upscale + 2, w // upscale + 2, 3).astype(np.float32)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)[..., :3].clip(0, 1)


def _bilinear(img, x, y):
    h, w = img.shape[:2]
    x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    wx = np.clip(x - x0, 0, 1)[..., None]
    wy = np.clip(y - y0, 0, 1)[..., None]
    return (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
            + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)


def make_synthetic_views(H=64, W=64, V=3, depth0=600.0, seed=0,
                         baseline=6.0, tilt=0.08, tex_upscale=8):
    """Views of a tilted textured plane. Returns dict of numpy arrays:
    images [V,H,W,3] in [0,1], intrinsics [3,3], extrinsics [V,4,4]
    (world == ref cam frame), ref depth [H,W], near/far.
    The plane is z = depth0 + tilt·(x_world): slightly slanted so depth
    varies and soft-argmax has signal. tex_upscale sets texture smoothness
    (smaller = sharper; photometric self-supervision needs ~2 to
    discriminate sub-pixel disparity — see scripts/train_synth_golden.py).
    """
    rs = np.random.RandomState(seed)
    f = 1.2 * max(H, W)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K)

    # plane: n·X = d with n = (-tilt, 0, 1)/norm ⇒ z = depth0 + tilt·x
    n = np.array([-tilt, 0.0, 1.0])
    n /= np.linalg.norm(n)
    d = depth0 * n[2]

    tex_scale = 4  # texture lives on the plane, indexed by world (x, y)
    tex = _smooth_texture(rs, 4 * H, 4 * W, upscale=tex_upscale)

    def plane_hit(origins, dirs):
        """Ray-plane intersection. origins [3], dirs [...,3] → pts, z_cam."""
        denom = dirs @ n
        tval = (d - origins @ n) / denom
        return origins + tval[..., None] * dirs

    def tex_lookup(pts):
        """World xy → texture pixels (wrapping via clipping)."""
        u = (pts[..., 0] / depth0 * f * 0.25 + 2 * W)
        v = (pts[..., 1] / depth0 * f * 0.25 + 2 * H)
        return _bilinear(tex, np.clip(u, 0, 4 * W - 1), np.clip(v, 0, 4 * H - 1))

    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pix = np.stack([xs, ys, np.ones_like(xs)], -1)  # [H, W, 3]

    images, extrinsics, depths = [], [], []
    for v in range(V):
        # camera v: world→cam translation by v·baseline along x
        E = np.eye(4, dtype=np.float32)
        E[0, 3] = -v * baseline  # cam center at x = +v·baseline
        extrinsics.append(E)
        R_c2w = E[:3, :3].T
        c = -R_c2w @ E[:3, 3]  # camera center in world
        dirs = (pix @ Kinv.T) @ R_c2w.T
        pts = plane_hit(c, dirs)
        images.append(tex_lookup(pts).astype(np.float32))
        # depth in cam frame = z of (E·pts)
        z = (pts @ E[:3, :3].T + E[:3, 3])[..., 2]
        depths.append(z.astype(np.float32))

    return {"images": np.stack(images), "intrinsics": K,
            "extrinsics": np.stack(extrinsics),
            "depths": np.stack(depths).astype(np.float32),
            "depth_min": depth0 * 0.8, "depth_max": depth0 * 1.25}


def write_synthetic_scan(root, H=128, W=160, V=5, seed=5, depth0=600.0,
                         baseline=8.0, scan="scan1", cam_steps=192.0,
                         tex_upscale=8):
    """Materialize a synthetic scene as a DTU-layout scan directory
    ({scan}/{images,cams,pair.txt}) consumable by DTUTestDataset — the
    shared recipe behind the e2e eval tests, the verify skill, and the
    golden-quality checkpoint (scripts/train_synth_golden.py).

    Returns (scan_dir, scene dict from make_synthetic_views)."""
    import cv2
    from pathlib import Path
    from ..core.io import write_cam_file, write_pair_file
    root = Path(root)
    scan_dir = root / scan
    (scan_dir / "images").mkdir(parents=True, exist_ok=True)
    (scan_dir / "cams").mkdir(exist_ok=True)
    s = make_synthetic_views(H=H, W=W, V=V, depth0=depth0, seed=seed,
                             baseline=baseline, tex_upscale=tex_upscale)
    for v in range(V):
        img = (s["images"][v].clip(0, 1) * 255).astype(np.uint8)
        cv2.imwrite(str(scan_dir / "images" / f"{v:08d}.jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        write_cam_file(
            scan_dir / "cams" / f"{v:08d}_cam.txt",
            s["extrinsics"][v], s["intrinsics"],
            [s["depth_min"], (s["depth_max"] - s["depth_min"]) / cam_steps,
             cam_steps, s["depth_max"]])
    write_pair_file(scan_dir / "pair.txt",
                    [(v, [u for u in range(V) if u != v]) for v in range(V)])
    return scan_dir, s


def make_synthetic_batch(B=1, V=3, H=64, W=64, ndepth=32, seed=0):
    """Full train-batch pytree in the shape make_train_step expects."""
    scenes = [make_synthetic_views(H, W, V, seed=seed + b) for b in range(B)]
    return batch_from_views(scenes, ndepth, seed)


def batch_from_views(scenes, ndepth, seed):
    """The train batch of B = len(scenes) scenes, each a dict with the keys
    of make_synthetic_views: ImageNet-normalized views, a gamma-jittered
    copy (gamma drawn from `seed`), per-image-normalized center images,
    stage projections (intrinsics at 1/4, 1/2, 1), the full sweep, the
    ref depth per stage, and the render branch's cameras."""
    B, V = len(scenes), len(scenes[0]["images"])

    def stack(fn):
        return np.stack([fn(s) for s in scenes])

    imgs_raw = stack(lambda s: s["images"])                 # [B,V,H,W,3]
    imgs = (imgs_raw - IMAGENET_MEAN) / IMAGENET_STD
    rs = np.random.RandomState(seed + 999)
    gamma = rs.uniform(0.7, 1.4)
    imgs_aug = ((imgs_raw ** gamma) - IMAGENET_MEAN) / IMAGENET_STD
    mean = imgs_raw.mean(axis=(2, 3), keepdims=True)
    var = imgs_raw.var(axis=(2, 3), keepdims=True)
    center_imgs = (imgs_raw - mean) / (np.sqrt(var) + 1e-8)

    proj = np.zeros((B, V, 2, 4, 4), np.float32)
    for b, s in enumerate(scenes):
        for v in range(V):
            proj[b, v, 0] = s["extrinsics"][v]
            proj[b, v, 1, :3, :3] = s["intrinsics"]
            proj[b, v, 1, :2] /= 4.0  # stage-1 intrinsics (quarter res)
    stage2 = proj.copy()
    stage2[:, :, 1, :2] *= 2
    stage3 = proj.copy()
    stage3[:, :, 1, :2] *= 4

    depth_values = np.stack([
        np.linspace(s["depth_min"], s["depth_max"], ndepth, dtype=np.float32)
        for s in scenes])

    depth_ms, mask_ms = {}, {}
    for i, sc in enumerate([4, 2, 1]):
        d = stack(lambda s: s["depths"][0][::sc, ::sc])
        depth_ms[f"stage{i+1}"] = d
        mask_ms[f"stage{i+1}"] = np.ones_like(d)

    w2cs = stack(lambda s: s["extrinsics"])
    c2ws = np.linalg.inv(w2cs).astype(np.float32)
    intrinsics = np.broadcast_to(
        stack(lambda s: s["intrinsics"])[:, None], (B, V, 3, 3)).copy()
    near_fars = np.broadcast_to(
        np.stack([[s["depth_min"], s["depth_max"]] for s in scenes],
                 axis=0)[:, None], (B, V, 2)).astype(np.float32).copy()

    return {
        "imgs": imgs.astype(np.float32),
        "imgs_aug": imgs_aug.astype(np.float32),
        "center_imgs": center_imgs.astype(np.float32),
        "proj_matrices": {"stage1": proj, "stage2": stage2, "stage3": stage3},
        "depth_values": depth_values,
        "depth": depth_ms, "mask": mask_ms,
        "depths_h": stack(lambda s: s["depths"]),
        "w2cs": w2cs.astype(np.float32), "c2ws": c2ws,
        "intrinsics": intrinsics.astype(np.float32),
        "near_fars": near_fars,
        "w_aug": np.asarray(0.01, np.float32),
    }
