"""The port's quality path on the CPU: depth → fusion → the DTU metric on
both committed quality goldens, with nothing of cv2 in the port.

  * `fusion/fuse._bilinear_map` equals cv2.remap(INTER_LINEAR) in every bit
    (NaN payloads included) on random maps, multiples of 1/64 (every
    multiple and half-multiple of 1/32), every border row and column inside
    and just outside, coordinates beyond ±32767 and int32, NaN and ±inf,
    on 1- and 3-channel images; its FMA rounds once;
  * the port's `filter_depth_views` equals the JAX package's (which samples
    with cv2) in every bit on both goldens' depth maps;
  * the assets equal what they were made from: `backbone_synth_unsup.npz`
    the weight bridge's conversion of the msgpack, `golden_scenes.npz` the
    scans `write_synthetic_scan` writes, read back through this host's
    JPEG decoder, and its samples the JAX package's `DTUTestDataset` items;
  * `tools.quality --device cpu` at each golden meets the bounds and pins
    of its JAX test (tests/test_e2e_quality.py,
    tests/test_e2e_quality_unsup.py), and `quality.check` fails each kind
    of gate.

`python tests/test_torch_quality.py` rewrites the two assets."""
import contextlib
import io
import json
import sys
from fractions import Fraction
from pathlib import Path

import cv2
import flax.serialization
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.core.io import read_cam_file, read_pair_file
from rcmvsnet_tpu.fusion.fuse import filter_depth_views as jax_filter
from rcmvsnet_tpu_torch.data.golden_scene import (SCENE_ASSET, GoldenScan,
                                                  load_scene)
from rcmvsnet_tpu_torch.fusion.fuse import (_bilinear_map, _fma,
                                            filter_depth_views)
from rcmvsnet_tpu_torch.tools import quality
from rcmvsnet_tpu_torch.weights import (UNSUP_ASSET, load_state_dict,
                                        state_dict_from_jax)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "tests" / "golden"
sys.path.insert(0, str(REPO / "scripts"))
import train_synth_golden as tsg  # noqa: E402


# --- the assets, made from the JAX package's scans --------------------

def write_scans(root) -> dict:
    """Each golden's scan as its JAX test writes it: {golden: (the JAX
    package's DTUTestDataset, scene, scan directory)}."""
    root = Path(root)
    out = {}
    for golden, build in (("sup", tsg.build_samples),
                          ("unsup", tsg.build_samples_unsup)):
        ds, scene = build(str(root / golden))
        out[golden] = (ds, scene, root / golden / "scan1")
    return out


def scene_arrays(scene: dict, scan_dir: Path) -> dict:
    """What `data/golden_scene.py` stores of one written scan."""
    V = len(scene["depths"])
    cams = [read_cam_file(scan_dir / "cams" / f"{v:08d}_cam.txt")
            for v in range(V)]
    images = [cv2.cvtColor(cv2.imread(str(scan_dir / "images"
                                          / f"{v:08d}.jpg")),
                           cv2.COLOR_BGR2RGB) for v in range(V)]
    return {
        "images": np.stack(images),
        "cam_intrinsics": np.stack([c.intrinsics for c in cams]),
        "cam_extrinsics": np.stack([c.extrinsics for c in cams]),
        "cam_depth": np.array([[c.depth_min, c.depth_interval, c.num_depth,
                                c.depth_max] for c in cams], np.float64),
        "pairs": np.array([[r] + s for r, s in
                           read_pair_file(scan_dir / "pair.txt")]),
        "depths": scene["depths"], "intrinsics": scene["intrinsics"],
        "extrinsics": scene["extrinsics"]}


def unsup_state_dict():
    blob = flax.serialization.msgpack_restore(
        (GOLDEN_DIR / "backbone_synth_unsup.msgpack").read_bytes())
    return state_dict_from_jax(blob["params"], blob["batch_stats"])


def write_assets(root):
    scans = write_scans(root)
    np.savez_compressed(SCENE_ASSET, **{
        f"{g}.{k}": v for g, (_, scene, d) in scans.items()
        for k, v in scene_arrays(scene, d).items()})
    np.savez(UNSUP_ASSET, **{k: v.numpy()
                             for k, v in unsup_state_dict().items()})


# --- the sampler ----------------------------------------------------------

def _specials(rs, shape, values, share):
    pick = rs.rand(*shape) < share
    return pick, rs.choice(np.asarray(values, np.float32), pick.sum())


def _maps(case, rs, h, w):
    """(x, y) float32 maps, 60x77: 77 columns = four vector steps of 16
    and a per-pixel tail of 13."""
    shape = (60, 77)
    x = (rs.rand(*shape) * (w + 4) - 2).astype(np.float32)
    y = (rs.rand(*shape) * (h + 4) - 2).astype(np.float32)
    if case == "sixty_fourths":
        x = (np.round(rs.rand(*shape) * (w + 2) * 64) / 64 - 1.5)
        y = (np.round(rs.rand(*shape) * (h + 2) * 64) / 64 - 1.5)
    elif case == "borders":
        near = lambda n: np.array([-1 - 2 ** -6, -1.0, -1 + 2 ** -20, -0.5,
                                   -2 ** -20, 0.0, 0.5, n - 1.5, n - 1.0,
                                   n - 1 + 2 ** -20, n - 0.5, n - 2 ** -6,
                                   float(n), n + 2 ** -6])
        along = lambda n: np.arange(-1.25, n + 1, 0.25)
        xa = np.concatenate([np.repeat(near(w), len(along(h))),
                             np.tile(along(w), len(near(h)))])
        ya = np.concatenate([np.tile(along(h), len(near(w))),
                             np.repeat(near(h), len(along(w)))])
        n = len(xa) // 16 * 16 + 5
        x, y = np.resize(xa, n)[None], np.resize(ya, n)[None]
    elif case == "far":
        far = [32767.5, -32767.5, 32768.25, -32768.25, 40000.3, -40000.7,
               1e6 + 0.5, 2.0 ** 31, -2.0 ** 31 - 512, 1e10, -1e10, 3e38,
               -3e38]
        for c in (x, y):
            pick, v = _specials(rs, shape, far, 0.3)
            c[pick] = v
    elif case == "nonfinite":
        nans = np.array([0x7FC00000, 0xFFC00000, 0x7FC12345, 0x7F812345],
                        np.uint32).view(np.float32)
        for c in (x, y):
            pick, v = _specials(rs, shape, [*nans, np.inf, -np.inf], 0.3)
            c[pick] = v
        x[:30][rs.rand(30, 77) < 0.97] = np.nan   # steps that miss
    return np.asarray(x, np.float32), np.asarray(y, np.float32)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("case", ["random", "sixty_fourths", "borders",
                                  "far", "nonfinite"])
def test_bilinear_map_matches_cv2(case, channels):
    rs = np.random.RandomState(len(case) * 10 + channels)
    h, w = 37, 53
    img = (rs.randn(h, w, channels) * 300).astype(np.float32)
    if channels == 1:
        img = img[..., 0]
    x, y = _maps(case, rs, h, w)
    want = cv2.remap(img, x, y, interpolation=cv2.INTER_LINEAR)
    got = _bilinear_map(img, x, y)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _fma_exact(a, b, c) -> np.float32:
    """float32(a·b + c) from exact rationals, ties to even."""
    q = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(q))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - q) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda v: int(v.view(np.uint32)) & 1)


def test_fma_rounds_once():
    # 1 + 2^-23 + (2^-24 - 2^-70): float64 lands on the float32 midpoint
    # 1 + 3·2^-24 and rounds it to even (1 + 2^-22); the exact sum lies
    # below it
    a = np.float32(1 + 2 ** -23)
    b = np.float32(2 ** -24 * (1 - 2 ** -23))
    for s in (1, -1):
        c = np.float32(s * (1 + 2 ** -23))
        assert np.float32(np.float64(a) * (s * np.float64(b))
                          + np.float64(c)) == np.float32(s * (1 + 2 ** -22))
        assert _fma(a, np.float32(s * b), c) == c
    rs = np.random.RandomState(0)
    a, b, c = (rs.randn(3, 3000) * 10.0 ** rs.randint(-8, 8, (3, 3000))
               ).astype(np.float32)
    got = _fma(a, b, c)
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# --- the goldens ----------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """`tools.quality --device cpu` at each golden: (its printed line, its
    run)."""
    out = {}
    for golden in ("sup", "unsup"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = quality.main(["--golden", golden, "--device", "cpu"])
        out[golden] = (json.loads(buf.getvalue().splitlines()[-1]), res)
    return out


@pytest.fixture(scope="module")
def pinned():
    return {g: json.loads((GOLDEN_DIR / f).read_text()) for g, f in (
        ("sup", "e2e_quality.json"), ("unsup", "e2e_quality_unsup.json"))}


def _pins(metrics, golden):
    np.testing.assert_allclose(metrics["acc_mean"], golden["acc_mean"],
                               rtol=0.15, atol=0.02)
    np.testing.assert_allclose(metrics["comp_mean"], golden["comp_mean"],
                               rtol=0.15, atol=0.05)
    np.testing.assert_allclose(metrics["acc_median"], golden["acc_median"],
                               rtol=0.15, atol=0.02)
    assert abs(metrics["n_data"] - golden["n_data"]) < 0.05 * golden["n_data"]


def test_quality_unsup_meets_its_jax_test(runs, pinned):
    """The port's counterpart of tests/test_e2e_quality_unsup.py:53-72."""
    line, res = runs["unsup"]
    metrics = res["metrics"]
    assert line == metrics and set(metrics) == set(pinned["unsup"])
    assert metrics["n_fused_raw"] > 50_000
    assert metrics["acc_mean"] < 3.0, metrics
    assert metrics["comp_mean"] < 4.5, metrics
    assert metrics["acc_median"] < 3.1, metrics
    sup = pinned["sup"]
    assert metrics["acc_mean"] < 12.0 * sup["acc_mean"], (metrics, sup)
    assert metrics["comp_mean"] < 8.0 * sup["comp_mean"], (metrics, sup)
    _pins(metrics, pinned["unsup"])
    assert quality.check("unsup", metrics, pinned["unsup"], sup) == []


def test_quality_sup_meets_its_jax_test(runs, pinned):
    """tests/test_e2e_quality.py:42-54 on the port's tool."""
    line, res = runs["sup"]
    metrics = res["metrics"]
    assert line == metrics and set(metrics) == set(pinned["sup"])
    assert metrics["n_fused_raw"] > 50_000
    assert metrics["acc_mean"] < 1.0, metrics
    assert metrics["comp_mean"] < 2.0, metrics
    _pins(metrics, pinned["sup"])
    assert quality.check("sup", metrics, pinned["sup"]) == []


def test_check_fails_each_gate(pinned):
    sup, unsup = pinned["sup"], pinned["unsup"]
    assert quality.check("sup", sup, sup) == []
    assert quality.check("unsup", unsup, unsup, sup) == []
    for golden, key, value, words in (
            ("sup", "n_fused_raw", 50_000, "n_fused_raw 50000 not > 50000"),
            ("sup", "comp_mean", 2.0, "comp_mean 2.0 not < 2.0"),
            ("unsup", "acc_median", 3.1, "acc_median 3.1 not < 3.1"),
            ("sup", "acc_mean", 0.23341120779514313 * 1.15 + 0.021,
             "not within rtol 0.15 atol 0.02"),
            ("sup", "n_data", int(sup["n_data"] * 1.05) + 1,
             "n_data"),
            ("unsup", "comp_mean", 2.87, None)):
        metrics = dict(pinned[golden], **{key: value})
        got = quality.check(golden, metrics, pinned[golden], sup)
        if words is None:
            assert got == [], got
        else:
            assert any(words in m for m in got), got
    got = quality.check("unsup", unsup, unsup, dict(sup, acc_mean=0.2))
    assert got == ["acc_mean 2.433195114135742 not < 12.0 x the supervised "
                   "golden's 0.2"]


@pytest.mark.parametrize("golden", ["sup", "unsup"])
def test_filter_depth_views_matches_jax(runs, golden):
    """Every reference view of the golden's maps, at the protocol's
    thresholds and the defaults: the five outputs equal in every bit."""
    res = runs[golden][1]
    maps = res["maps"]
    scan = GoldenScan(load_scene(golden))
    cams = [(s["proj_matrices"]["stage3"][0, 1][:3, :3],
             s["proj_matrices"]["stage3"][0, 0])
            for s in (scan[i] for i in range(len(scan)))]
    rs = np.random.RandomState(3)
    img = rs.rand(*maps[0][0].shape, 3).astype(np.float32)
    for ref, (depth, conf) in enumerate(maps):
        srcs = [v for v in range(len(maps)) if v != ref]
        args = (depth, conf, img, *cams[ref], [maps[v][0] for v in srcs],
                [cams[v][0] for v in srcs], [cams[v][1] for v in srcs])
        for kw in (dict(prob_threshold=0.5, num_consistent=3), {}):
            got, want = filter_depth_views(*args, **kw), jax_filter(*args,
                                                                   **kw)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
                if g.dtype == np.float32:
                    np.testing.assert_array_equal(g.view(np.uint32),
                                                  w.view(np.uint32))
        assert np.array_equal(res["masks"][ref], jax_filter(
            *args, prob_threshold=0.5, num_consistent=3)[2])


# --- the assets -----------------------------------------------------------

@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    return write_scans(tmp_path_factory.mktemp("golden_scans"))


def test_assets_match_the_bridge_and_the_jpeg_round_trip(scans):
    want = unsup_state_dict()
    got = load_state_dict(UNSUP_ASSET)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    with np.load(SCENE_ASSET) as z:
        assert set(z.files) == {f"{g}.{k}" for g in scans for k in (
            "images", "cam_intrinsics", "cam_extrinsics", "cam_depth",
            "pairs", "depths", "intrinsics", "extrinsics")}
    for golden, (_, scene, scan_dir) in scans.items():
        stored = load_scene(golden)
        for k, v in scene_arrays(scene, scan_dir).items():
            assert stored[k].dtype == v.dtype, (golden, k)
            np.testing.assert_array_equal(stored[k], v, err_msg=k)


@pytest.mark.parametrize("golden", ["sup", "unsup"])
def test_golden_scan_items_match_dtu_test_dataset(scans, golden):
    ds = scans[golden][0]
    scan = GoldenScan(load_scene(golden))
    assert len(scan) == len(ds) == 5
    for i in range(len(ds)):
        got, want = scan[i], ds[i]
        assert got["filename"] == want["filename"]
        for k in ("imgs", "depth_values"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        for stage, pm in want["proj_matrices"].items():
            np.testing.assert_array_equal(got["proj_matrices"][stage], pm)
        cams = scan.sample_cams(i)
        np.testing.assert_array_equal(cams["depth_values"],
                                      want["depth_values"])
        assert cams["hw"] == (128, 160)


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        write_assets(tmp)
