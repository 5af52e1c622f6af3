"""ctypes bindings for the native (C++) geometry kernels, with automatic
on-demand compilation (g++ -O3 -shared) and graceful scipy fallback.
The library is built into the package's `.ext_build/` directory (listed in
`.gitignore`), beside the CUDA kernels' builds.

Capabilities (see mvs_native.cpp):
  * mesh_supersample(verts, tris, thresh) — DTU mesh-method protocol
  * nn_distances(query, ref, max_dist)    — benchmark distance pass
  * reduce_points(pts, dst, seed)         — 0.2 mm stochastic thinning
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "mvs_native.cpp"
_LIB = Path(__file__).resolve().parent.parent / ".ext_build" / "libmvs_native.so"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    try:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             str(_SRC), "-o", str(_LIB)],
            check=True, capture_output=True, timeout=300)
        return True
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB.exists() and not _build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        if not _build():
            _load_failed = True
            return None
        lib = ctypes.CDLL(str(_LIB))
    c_d = ctypes.POINTER(ctypes.c_double)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    c_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.nn_distances.argtypes = [c_d, ctypes.c_int64, c_d, ctypes.c_int64,
                                 ctypes.c_double, c_d, ctypes.c_int]
    lib.reduce_points.argtypes = [c_d, ctypes.c_int64, c_i32,
                                  ctypes.c_double, c_u8]
    lib.mesh_supersample_count.argtypes = [c_d, ctypes.c_int64, c_i32,
                                           ctypes.c_int64, ctypes.c_double]
    lib.mesh_supersample_count.restype = ctypes.c_int64
    lib.mesh_supersample_fill.argtypes = [c_d, ctypes.c_int64, c_i32,
                                          ctypes.c_int64, ctypes.c_double, c_d]
    _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def nn_distances(query: np.ndarray, ref: np.ndarray, max_dist: float = 60.0,
                 n_threads: int = 0) -> np.ndarray:
    """Per-query nearest-neighbor distance to ref, capped at max_dist."""
    lib = load()
    query = np.ascontiguousarray(query, np.float64)
    ref = np.ascontiguousarray(ref, np.float64)
    if lib is None:
        from ..fusion.dtu_eval import nn_distances as scipy_nn
        return scipy_nn(query, ref, max_dist).astype(np.float64)
    if n_threads <= 0:
        import os
        n_threads = os.cpu_count() or 1
    out = np.empty(len(query), np.float64)
    lib.nn_distances(_ptr(query, ctypes.c_double), len(query),
                     _ptr(ref, ctypes.c_double), len(ref),
                     max_dist, _ptr(out, ctypes.c_double), n_threads)
    return out


def reduce_points(pts: np.ndarray, dst: float = 0.2,
                  seed: Optional[int] = 0) -> np.ndarray:
    """Stochastic thinning (reducePts_haa.m): returns the kept subset.

    seed defaults to 0 (like fusion/dtu_eval.reduce_points) so published
    acc/comp numbers are reproducible; seed=None for the MATLAB original's
    unseeded randperm behavior."""
    lib = load()
    pts = np.ascontiguousarray(pts, np.float64)
    if lib is None:
        from ..fusion.dtu_eval import reduce_points as scipy_reduce
        return scipy_reduce(pts, dst, seed)
    order = (np.random.RandomState(seed).permutation(len(pts))
             if seed is not None else np.random.permutation(len(pts)))
    order = np.ascontiguousarray(order, np.int32)
    keep = np.empty(len(pts), np.uint8)
    lib.reduce_points(_ptr(pts, ctypes.c_double), len(pts),
                      _ptr(order, ctypes.c_int32), dst,
                      _ptr(keep, ctypes.c_uint8))
    return pts[keep.astype(bool)]


def mesh_supersample(verts: np.ndarray, tris: np.ndarray,
                     thresh: float) -> np.ndarray:
    """Vertices + barycentric-grid interior points of every triangle.

    verts: [N, 3] float; tris: [M, 3] int (0-based). Falls back to a
    pure-numpy per-triangle loop when the native library can't build —
    correct but orders of magnitude slower on real DTU meshes."""
    lib = load()
    verts = np.ascontiguousarray(verts, np.float64)
    tris = np.ascontiguousarray(tris, np.int32)
    if lib is None:
        return _mesh_supersample_numpy(verts, tris, thresh)
    count = lib.mesh_supersample_count(
        _ptr(verts, ctypes.c_double), len(verts),
        _ptr(tris, ctypes.c_int32), len(tris), thresh)
    out = np.empty((count, 3), np.float64)
    lib.mesh_supersample_fill(
        _ptr(verts, ctypes.c_double), len(verts),
        _ptr(tris, ctypes.c_int32), len(tris), thresh,
        _ptr(out, ctypes.c_double))
    return out


def _mesh_supersample_numpy(verts, tris, thresh):
    """Vectorized fallback (same math, per-triangle loop in numpy)."""
    pieces = [verts]
    for t in tris:
        q0, q1, q2 = verts[t[0]], verts[t[1]], verts[t[2]]
        v1, v2 = q1 - q0, q2 - q0
        l1, l2 = np.linalg.norm(v1), np.linalg.norm(v2)
        area2 = np.linalg.norm(np.cross(v1, v2))
        if area2 <= 0:
            continue
        thr = thresh * np.sqrt(l1 * l2 / area2)
        n1, n2 = np.floor(l1 / thr), np.floor(l2 / thr)
        c1 = (np.arange(n1 + 1) + 0.5) / n1 if n1 > 0 else np.array([np.inf])
        c2 = (np.arange(n2 + 1) + 0.5) / n2 if n2 > 0 else np.array([np.inf])
        k1, k2 = np.meshgrid(c1, c2, indexing="ij")
        sel = (k1 + k2) < 1.0
        if sel.any():
            pieces.append(q0 + k1[sel][:, None] * v1 + k2[sel][:, None] * v2)
    return np.concatenate(pieces, axis=0)
