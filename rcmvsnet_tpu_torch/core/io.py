"""Pure-numpy file I/O: PFM depth maps, MVSNet camera files, view-pair
lists, and PLY point clouds.

Behavioral parity targets in the reference implementation:
  * PFM read/write        — the reference's datasets/data_io.py:8-77
  * camera file parsing   — the reference's datasets/dtu_train.py:116-128,
                            the reference's datasets/dtu_test.py:85-105
  * pair.txt parsing      — the reference's eval_rcmvsnet_dtu.py:126-136
  * camera file writing   — the reference's eval_rcmvsnet_dtu.py:138-155
  * PLY writing           — the reference's eval_rcmvsnet_dtu.py:441-454
                            (reference uses the `plyfile` package; we write
                            binary-little-endian PLY directly)
"""
from __future__ import annotations

import re
import sys
from dataclasses import dataclass

import numpy as np


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------

def read_pfm(filename):
    """Read a PFM file. Returns (data, scale) with data flipped to row-0-top.

    Matches the reference's datasets/data_io.py:8-43 (header 'PF'/'Pf',
    sign-of-scale endianness, flipud).
    """
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")

        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.flipud(data.reshape(shape))
    return data, scale


def save_pfm(filename, image, scale=1.0):
    """Write a float32 PFM (flips vertically; little-endian scale sign).

    Matches the reference's datasets/data_io.py:46-77.
    """
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("Image must be HxWx3, HxWx1 or HxW.")

    image = np.flipud(image)
    if sys.byteorder == "little":
        scale = -scale
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{scale}\n".encode())
        image.tofile(f)


# ---------------------------------------------------------------------------
# MVSNet camera files
# ---------------------------------------------------------------------------

@dataclass
class CameraFile:
    """Parsed MVSNet-format camera file.

    extrinsics: (4,4) world→camera; intrinsics: (3,3); depth line fields.
    """
    intrinsics: np.ndarray
    extrinsics: np.ndarray
    depth_min: float
    depth_interval: float
    num_depth: float | None = None
    depth_max: float | None = None


def read_cam_file(filename) -> CameraFile:
    """Parse the 'extrinsic / intrinsic / depth-range' text format.

    Line layout per the reference's datasets/dtu_train.py:116-128:
      line 0: 'extrinsic', lines 1-4: 4x4, line 6: 'intrinsic',
      lines 7-9: 3x3, line 11: 'depth_min depth_interval [num_depth depth_max]'.
    """
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    fields = lines[11].split()
    depth_min = float(fields[0])
    depth_interval = float(fields[1])
    num_depth = float(fields[2]) if len(fields) >= 3 else None
    depth_max = float(fields[3]) if len(fields) >= 4 else None
    return CameraFile(intrinsics, extrinsics, depth_min, depth_interval, num_depth, depth_max)


def write_cam_file(filename, extrinsics, intrinsics, depth_fields):
    """Write a camera file in the layout save_scene_depth emits.

    Matches the reference's eval_rcmvsnet_dtu.py:138-155 — the 'cam' there is
    a (2,4,4) stack; row [1,3,:] carries the 4 depth fields.
    """
    with open(filename, "w") as f:
        f.write("extrinsic\n")
        for i in range(4):
            f.write(" ".join(str(extrinsics[i][j]) for j in range(4)) + " \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(" ".join(str(intrinsics[i][j]) for j in range(3)) + " \n")
        f.write("\n" + " ".join(str(v) for v in depth_fields) + "\n")


# ---------------------------------------------------------------------------
# pair.txt
# ---------------------------------------------------------------------------

def read_pair_file(filename):
    """Read (ref_view, [src views]) tuples.

    Matches the reference's eval_rcmvsnet_dtu.py:126-136: src line is
    'count id score id score ...' — ids are at odd positions.
    """
    data = []
    with open(filename) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            src_views = [int(x) for x in f.readline().rstrip().split()[1::2]]
            if len(src_views) > 0:
                data.append((ref_view, src_views))
    return data


def write_pair_file(filename, pairs):
    """Inverse of read_pair_file (scores written as 1.0)."""
    with open(filename, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref, srcs in pairs:
            f.write(f"{ref}\n")
            f.write(f"{len(srcs)} " + " ".join(f"{s} 1.0" for s in srcs) + "\n")


# ---------------------------------------------------------------------------
# PLY point clouds (binary little-endian, xyz float32 + rgb uint8)
# ---------------------------------------------------------------------------

def save_ply(filename, xyz, rgb=None):
    """Write a binary_little_endian PLY with float x/y/z (+ uchar r/g/b).

    Replaces the reference's plyfile usage
    (the reference's eval_rcmvsnet_dtu.py:441-454).
    """
    xyz = np.asarray(xyz, dtype="<f4")
    n = xyz.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if rgb is not None:
        rgb = np.asarray(rgb, dtype=np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        rec = np.empty(n, dtype=dt)
        rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    else:
        dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        rec = np.empty(n, dtype=dt)
        rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    header.append("end_header")
    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def load_ply(filename):
    """Read ascii or binary_little_endian PLY. Returns (xyz f32, rgb u8|None).

    Covers what the DTU benchmark needs from MATLAB plyread
    (the reference's matlab_eval/plyread.m).
    """
    with open(filename, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        n = 0
        props = []  # (name, dtype-char) of the vertex element
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element"):
                _, name, cnt = line.split()
                in_vertex = name == b"vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith(b"property") and in_vertex:
                toks = line.split()
                props.append((toks[-1].decode(), toks[1].decode()))
            elif line == b"end_header":
                break

        type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                    "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
                    "short": "<i2", "ushort": "<u2"}
        dt = np.dtype([(name, type_map[t]) for name, t in props])
        if fmt == b"binary_little_endian":
            rec = np.fromfile(f, dtype=dt, count=n)
        elif fmt == b"ascii":
            rows = [f.readline().split() for _ in range(n)]
            arr = np.array(rows, dtype=np.float64)
            rec = np.zeros(n, dtype=dt)
            for i, (name, _) in enumerate(props):
                rec[name] = arr[:, i]
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    rgb = None
    if "red" in dt.names:
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1).astype(np.uint8)
    return xyz, rgb


def read_image(filename):
    """Read an image to float32 RGB in [0,1] (HWC)."""
    import cv2
    img = cv2.imread(str(filename), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(filename)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
