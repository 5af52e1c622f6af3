"""DTU accuracy/completeness benchmark — Python port of the official MATLAB
suite so the full acc/comp metric runs without MATLAB.

Parity targets (the reference's matlab_eval/):
  * reducePts_haa.m        — stochastic 0.2 mm thinning via KD-tree
  * MaxDistCP.m            — nearest-neighbor distances capped at 60 mm
  * PointCompareMain.m     — ObsMask (data) + ground-plane (stl) filtering
  * ComputeStat_web_pt.m   — per-scan mean/var/median with a 20 mm
                             outlier cut (MATLAB var == ddof=1)
  * compute_mean.m         — acc = mean(MeanData) [data→stl],
                             comp = mean(MeanStl) [stl→data],
                             overall = (acc + comp)/2
  * compute_var_median.m   — cross-scan var/median summary tables
                             (summarize_scan_stats)
  * BaseEval2Obj_web.m     — colored .obj export of both distance-annotated
                             clouds (base_eval_to_obj)
  * GetUsedSets.m          — the 22 evaluation scans

The KD-tree is scipy's cKDTree by default; the optional C++ extension
(the package's native/) provides the same queries with multithreading.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

DTU_EVAL_SETS = [1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48,
                 49, 62, 75, 77, 110, 114, 118]


def reduce_points(pts: np.ndarray, dst: float = 0.2,
                  seed: Optional[int] = 0) -> np.ndarray:
    """Stochastic thinning: visit points in random order; keep a point iff
    it hasn't been suppressed, then suppress all neighbors within dst.
    pts: [N, 3]. Matches reducePts_haa.m.

    seed defaults to 0 so published acc/comp numbers are reproducible
    run-to-run (the MATLAB original uses an unseeded randperm; pass
    seed=None to reproduce that wobble deliberately).

    Uses the multithreaded C++ KD-tree (native/mvs_native.cpp) when it
    builds; the scipy path below is the always-available fallback.
    """
    native = _native_lib()
    if native is not None:
        from ..native import reduce_points as native_reduce
        return native_reduce(np.ascontiguousarray(pts, np.float64), dst,
                             seed).astype(pts.dtype)
    from scipy.spatial import cKDTree
    n = pts.shape[0]
    keep = np.ones(n, bool)
    order = (np.random.RandomState(seed).permutation(n) if seed is not None
             else np.random.permutation(n))
    tree = cKDTree(pts)
    # chunked like reducePts_haa.m's 4e6-point rangesearch loop: one
    # query_ball_point over a full 20-80M-point fused cloud materializes
    # an object array of tens of millions of Python lists (many GB)
    chunk = 4_000_000
    for c0 in range(0, n, chunk):
        sel = order[c0:c0 + chunk]
        neighbors = tree.query_ball_point(pts[sel], dst, workers=-1)
        for i, idx in enumerate(neighbors):
            pid = sel[i]
            if keep[pid]:
                keep[idx] = False
                keep[pid] = True
    return pts[keep]


def _native_lib():
    """The optional C++ acceleration (lazy: native imports this module as
    ITS fallback, so the import must not happen at module scope)."""
    try:
        from ..native import load
        return load()
    except Exception:
        return None


def nn_distances(query: np.ndarray, ref: np.ndarray,
                 max_dist: float = 60.0) -> np.ndarray:
    """Distance from each query point to its nearest ref point, capped at
    max_dist (MaxDistCP.m semantics: out-of-range → max_dist). Runs the
    multithreaded C++ KD-tree when available, scipy otherwise."""
    native = _native_lib()
    if native is not None:
        from ..native import nn_distances as native_nn
        return native_nn(np.ascontiguousarray(query, np.float64),
                         np.ascontiguousarray(ref, np.float64),
                         max_dist).astype(np.float32)
    from scipy.spatial import cKDTree
    tree = cKDTree(ref)
    d, _ = tree.query(query, k=1, distance_upper_bound=max_dist, workers=-1)
    d[~np.isfinite(d)] = max_dist
    return d.astype(np.float32)


def dtu_point_compare(data_pts: np.ndarray, stl_pts: np.ndarray,
                      obs_mask: Optional[np.ndarray] = None,
                      bb: Optional[np.ndarray] = None,
                      res: float = 1.0,
                      ground_plane: Optional[np.ndarray] = None,
                      dst: float = 0.2, max_dist: float = 60.0,
                      outlier_dist: float = 20.0, seed: int = 0,
                      return_detail: bool = False) -> dict:
    """Single-scan acc/comp following PointCompareMain + ComputeStat.

    data_pts: [N, 3] reconstructed cloud; stl_pts: [M, 3] GT (assumed
    pre-thinned like the official stl files). obs_mask/bb/res/ground_plane
    come from the DTU ObsMask*.mat / Plane*.mat files (pass None to skip
    the corresponding filtering — useful for synthetic tests).

    return_detail adds the per-point arrays the MATLAB suite stores in its
    BaseEval .mat (thinned clouds, distances, mask/plane flags) under
    "detail" — the input of base_eval_to_obj (BaseEval2Obj_web.m).
    """
    data_pts = reduce_points(np.asarray(data_pts, np.float64), dst, seed)
    stl_pts = np.asarray(stl_pts, np.float64)

    d_data = nn_distances(data_pts, stl_pts, max_dist)   # data→stl (acc)
    d_stl = nn_distances(stl_pts, data_pts, max_dist)    # stl→data (comp)

    if obs_mask is not None and bb is not None:
        qv = np.round((data_pts - bb[0][None]) / res + 1).astype(int)
        in_range = ((qv > 0) & (qv <= np.array(obs_mask.shape)[None])).all(1)
        data_in_mask = np.zeros(len(data_pts), bool)
        sel = qv[in_range] - 1
        data_in_mask[in_range] = obs_mask[sel[:, 0], sel[:, 1], sel[:, 2]] > 0
    else:
        data_in_mask = np.ones(len(data_pts), bool)

    if ground_plane is not None:
        hom = np.concatenate([stl_pts, np.ones((len(stl_pts), 1))], axis=1)
        stl_above = (hom @ np.asarray(ground_plane).reshape(4)) > 0
    else:
        stl_above = np.ones(len(stl_pts), bool)

    d_data_sel = d_data[data_in_mask]
    d_data_sel = d_data_sel[d_data_sel < outlier_dist]
    d_stl_sel = d_stl[stl_above]
    d_stl_sel = d_stl_sel[d_stl_sel < outlier_dist]

    # MATLAB var is the ddof=1 sample variance; var of one sample is 0
    # (ComputeStat_web_pt.m:57-58)
    _var = lambda x: float(np.var(x, ddof=1)) if len(x) > 1 else (
        0.0 if len(x) else float("nan"))
    out = {
        "acc_mean": float(np.mean(d_data_sel)) if len(d_data_sel) else float("nan"),
        "acc_median": float(np.median(d_data_sel)) if len(d_data_sel) else float("nan"),
        "acc_var": _var(d_data_sel),
        "comp_mean": float(np.mean(d_stl_sel)) if len(d_stl_sel) else float("nan"),
        "comp_median": float(np.median(d_stl_sel)) if len(d_stl_sel) else float("nan"),
        "comp_var": _var(d_stl_sel),
        "n_data": int(len(d_data_sel)), "n_stl": int(len(d_stl_sel)),
    }
    if return_detail:
        out["detail"] = {
            "data_pts": data_pts, "d_data": d_data,
            "data_in_mask": data_in_mask,
            "stl_pts": stl_pts, "d_stl": d_stl, "stl_above": stl_above,
        }
    return out


def summarize_scan_stats(per_scan: dict) -> dict:
    """Cross-scan summary tables: mean/var/median rows of compute_mean.m
    and compute_var_median.m (each summary value is the mean of the
    per-scan statistic; *_overall = (acc + comp)/2)."""
    rows = list(per_scan.values())
    mean_of = lambda k: float(np.mean([s[k] for s in rows]))
    acc, comp = mean_of("acc_mean"), mean_of("comp_mean")
    var_acc, var_comp = mean_of("acc_var"), mean_of("comp_var")
    med_acc, med_comp = mean_of("acc_median"), mean_of("comp_median")
    return {
        "acc": acc, "comp": comp, "overall": (acc + comp) / 2,
        "var_acc": var_acc, "var_comp": var_comp,
        "var_overall": (var_acc + var_comp) / 2,
        "med_acc": med_acc, "med_comp": med_comp,
        "med_overall": (med_acc + med_comp) / 2,
    }


def base_eval_to_obj(detail: dict, method: str, cset: int, outdir):
    """Colored .obj export of the distance-annotated clouds
    (BaseEval2Obj_web.m): alpha = min(d, 10)/10; in-mask (or above-plane)
    points ramp red→white with distance, excluded points green→blue.
    Writes {method}2Stl_{set}.obj (data cloud) and Stl2{method}_{set}.obj
    (GT cloud); returns both paths. (The MATLAB original embeds a stray
    space in the first filename — not reproduced.)"""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    def write(path, pts, dists, included):
        alpha = np.minimum(np.asarray(dists, np.float64), 10.0) / 10.0
        inc = np.asarray(included, bool)
        rgb = np.empty((len(pts), 3))
        # included: C = [1 0 0]*a + [1 1 1]*(1-a); excluded: [0 1 0]*a + [0 0 1]*(1-a)
        rgb[inc] = (np.array([1.0, 0.0, 0.0]) * alpha[inc, None]
                    + np.array([1.0, 1.0, 1.0]) * (1 - alpha[inc, None]))
        rgb[~inc] = (np.array([0.0, 1.0, 0.0]) * alpha[~inc, None]
                     + np.array([0.0, 0.0, 1.0]) * (1 - alpha[~inc, None]))
        with open(path, "w") as f:
            for p, c in zip(np.asarray(pts, np.float64), rgb):
                f.write(f"v {p[0]:f} {p[1]:f} {p[2]:f} "
                        f"{c[0]:f} {c[1]:f} {c[2]:f}\n")
        return path

    data_obj = write(outdir / f"{method}2Stl_{cset}.obj",
                     detail["data_pts"], detail["d_data"],
                     detail["data_in_mask"])
    stl_obj = write(outdir / f"Stl2{method}_{cset}.obj",
                    detail["stl_pts"], detail["d_stl"],
                    detail["stl_above"])
    return data_obj, stl_obj


def load_obs_mask(mat_path):
    """Load ObsMask{set}_10.mat → (obs_mask, bb, res); Plane{set}.mat → P."""
    from scipy.io import loadmat
    m = loadmat(str(mat_path))
    return m["ObsMask"], m["BB"], float(np.asarray(m["Res"]).reshape(-1)[0])


def dtu_eval_scans(ply_dir, gt_dir, sets=None, method="mvsnet",
                   light="l3") -> dict:
    """Full-protocol evaluation over the 22 DTU test scans.

    ply_dir holds {method}{set:03d}_{light}.ply files (our fusion output);
    gt_dir is the official SampleSet/MVS_Data directory (Points/stl +
    ObsMask). Returns per-scan stats + acc/comp/overall summary.
    """
    from scipy.io import loadmat
    from ..core.io import load_ply
    sets = list(sets) if sets is not None else DTU_EVAL_SETS
    ply_dir, gt_dir = Path(ply_dir), Path(gt_dir)
    per_scan = {}
    for cset in sets:
        data_pts, _ = load_ply(ply_dir / f"{method}{cset:03d}_{light}.ply")
        stl_pts, _ = load_ply(gt_dir / "Points" / "stl" /
                              f"stl{cset:03d}_total.ply")
        obs_mask, bb, res = load_obs_mask(
            gt_dir / "ObsMask" / f"ObsMask{cset}_10.mat")
        plane = loadmat(str(gt_dir / "ObsMask" / f"Plane{cset}.mat"))["P"]
        per_scan[cset] = dtu_point_compare(
            data_pts, stl_pts, obs_mask, np.asarray(bb), res, plane)
    return {"per_scan": per_scan, **summarize_scan_stats(per_scan)}
