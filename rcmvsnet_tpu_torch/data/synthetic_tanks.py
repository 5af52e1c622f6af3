"""A synthetic scene on disk in the Tanks & Temples test layout, for
`cli/eval_tanks.py` without the benchmark's data:

    <root>/intermediate/Family/images/%08d.jpg
    <root>/intermediate/Family/cams_1/%08d_cam.txt   (line 11: depth min, max)
    <root>/intermediate/Family/pair.txt              (every other view a source)

The views are `data/synthetic.make_synthetic_views`' textured plane.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.io import write_cam_file, write_pair_file
from .synthetic import make_synthetic_views


def write_tanks_scan(root, H=128, W=160, V=4) -> dict:
    """Write V views of the plane under root/intermediate/Family; returns
    the `make_synthetic_views` dict (depth_min / depth_max included)."""
    import cv2
    scan_dir = Path(root) / "intermediate" / "Family"
    (scan_dir / "images").mkdir(parents=True)
    (scan_dir / "cams_1").mkdir()
    s = make_synthetic_views(H=H, W=W, V=V, depth0=600.0, seed=7,
                             baseline=8.0)
    for v in range(V):
        img = (s["images"][v].clip(0, 1) * 255).astype(np.uint8)
        cv2.imwrite(str(scan_dir / "images" / f"{v:08d}.jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        write_cam_file(scan_dir / "cams_1" / f"{v:08d}_cam.txt",
                       s["extrinsics"][v], s["intrinsics"],
                       [s["depth_min"], s["depth_max"]])
    write_pair_file(scan_dir / "pair.txt",
                    [(v, [u for u in range(V) if u != v]) for v in range(V)])
    return s
