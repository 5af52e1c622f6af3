"""The port's own copies of the framework-free modules (core/io, data/*
including the Tanks & Temples loader,
fusion/*, native/) behave as the JAX package's originals: the same numpy
inputs give equal outputs, and files one side writes the other reads back
equal. The native geometry library builds into the port's `.ext_build/`.
The DTU train / val datasets, the data loader and the dataset registry are
copies too: their code, docstrings aside, is the originals' (the registry
names the port's modules where the original names the JAX package's);
tests/test_torch_dtu_data.py holds their items and batches equal."""
import ast
from pathlib import Path

import numpy as np
import pytest

from rcmvsnet_tpu.core import io as jio
from rcmvsnet_tpu.data import dtu_test as jdtu
from rcmvsnet_tpu.data import synthetic as jsyn
from rcmvsnet_tpu.data import tanks as jtanks
from rcmvsnet_tpu.data import transforms as jtr
from rcmvsnet_tpu.fusion import dtu_eval as jeval
from rcmvsnet_tpu_torch import native
from rcmvsnet_tpu_torch.core import io as tio
from rcmvsnet_tpu_torch.data import dtu_test as tdtu
from rcmvsnet_tpu_torch.data import synthetic as tsyn
from rcmvsnet_tpu_torch.data import tanks as ttanks
from rcmvsnet_tpu_torch.data import transforms as ttr
from rcmvsnet_tpu_torch.data.synthetic_dataset import SyntheticDataset
from rcmvsnet_tpu_torch.data.synthetic_tanks import write_tanks_scan
from rcmvsnet_tpu_torch.fusion import dtu_eval as teval

REPO = Path(__file__).resolve().parent.parent


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_synthetic_data_matches_jax():
    _equal_trees(tsyn.make_synthetic_batch(B=1, V=3, H=32, W=32, seed=4),
                 jsyn.make_synthetic_batch(B=1, V=3, H=32, W=32, seed=4))
    item = SyntheticDataset(n_samples=2, nviews=3, height=32, width=32)[1]
    assert item["imgs"].shape == (3, 32, 32, 3)


def test_io_round_trips_across_packages(tmp_path):
    rs = np.random.RandomState(0)
    img = rs.rand(5, 7).astype(np.float32)
    tio.save_pfm(tmp_path / "a.pfm", img)
    np.testing.assert_array_equal(jio.read_pfm(tmp_path / "a.pfm")[0], img)
    E, K = np.eye(4, dtype=np.float32), np.eye(3, dtype=np.float32) * 2
    jio.write_cam_file(tmp_path / "c.txt", E, K, [425.0, 2.5, 192, 900.0])
    a, b = tio.read_cam_file(tmp_path / "c.txt"), jio.read_cam_file(
        tmp_path / "c.txt")
    for f in ("extrinsics", "intrinsics"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    pairs = [(0, [1, 2]), (1, [0, 2])]
    tio.write_pair_file(tmp_path / "p.txt", pairs)
    assert jio.read_pair_file(tmp_path / "p.txt") == tio.read_pair_file(
        tmp_path / "p.txt")
    xyz = rs.rand(20, 3).astype(np.float32)
    tio.save_ply(tmp_path / "x.ply", xyz)
    np.testing.assert_allclose(jio.load_ply(tmp_path / "x.ply")[0], xyz,
                               rtol=1e-6)


def test_transforms_and_dtu_dataset_match_jax(tmp_path):
    rs = np.random.RandomState(1)
    img = rs.rand(40, 48, 3).astype(np.float32)
    np.testing.assert_array_equal(ttr.normalize_imagenet(img),
                                  jtr.normalize_imagenet(img))
    np.testing.assert_array_equal(ttr.center_image(img),
                                  jtr.center_image(img))
    assert ttr.scaled_mvs_dims(1200, 1600, 1152, 864) == \
        jtr.scaled_mvs_dims(1200, 1600, 1152, 864)
    tsyn.write_synthetic_scan(tmp_path, H=64, W=96, V=3)
    kw = dict(nviews=3, ndepths=64, max_h=64, max_w=96)
    a = tdtu.DTUTestDataset(tmp_path, ["scan1"], **kw)
    b = jdtu.DTUTestDataset(tmp_path, ["scan1"], **kw)
    assert len(a) == len(b) == 3
    ia, ib = a[2], b[2]
    assert set(ia) == set(ib)
    _equal_trees({k: v for k, v in ia.items() if k != "filename"},
                 {k: v for k, v in ib.items() if k != "filename"})


def test_dtu_eval_matches_jax():
    rs = np.random.RandomState(2)
    q = rs.rand(300, 3) * 10
    r = rs.rand(400, 3) * 10
    np.testing.assert_allclose(teval.nn_distances(q, r, 2.0),
                               jeval.nn_distances(q, r, 2.0), rtol=1e-6)
    np.testing.assert_array_equal(teval.reduce_points(q, 1.0),
                                  jeval.reduce_points(q, 1.0))
    assert native._LIB.parent.name == ".ext_build"


def test_tanks_dataset_matches_jax(tmp_path, monkeypatch):
    """The T&T loader on a scene in its layout (cams_1 line 11 = min and
    max): equal samples, equal image-free cams, equal scan lists."""
    assert ttanks.INTERMEDIATE_SCANS == jtanks.INTERMEDIATE_SCANS
    assert ttanks.ADVANCED_SCANS == jtanks.ADVANCED_SCANS
    for mod in (ttanks, jtanks):
        monkeypatch.setattr(mod, "INTERMEDIATE_SCANS", ["Family"])
    write_tanks_scan(tmp_path, H=48, W=64, V=3)
    kw = dict(nviews=3, img_wh=(64, 48), ndepths=16)
    a = ttanks.TanksDataset(tmp_path, "intermediate", **kw)
    b = jtanks.TanksDataset(tmp_path, "intermediate", **kw)
    assert len(a) == len(b) == 3
    for i in range(3):
        _equal_trees(a[i], b[i])
        _equal_trees(a.sample_cams(i), b.sample_cams(i))
    dv = a[0]["depth_values"]
    assert len(dv) == 16 and dv[-1] > dv[0]


def _code(path) -> str:
    """The module's AST without its docstrings, dumped."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["loader", "dtu_train", "dtu_val",
                                  "registry"])
def test_data_copies_are_the_originals(name):
    port = REPO / "rcmvsnet_tpu_torch" / "data" / f"{name}.py"
    orig = REPO / "rcmvsnet_tpu" / "data" / f"{name}.py"
    got, want = _code(port), _code(orig)
    if name == "registry":
        from rcmvsnet_tpu_torch.data.registry import _ALIASES
        assert all(m.startswith("rcmvsnet_tpu_torch.data.")
                   for m, _ in _ALIASES.values()), _ALIASES
        assert "'rcmvsnet_tpu.data." not in got
        got = got.replace("'rcmvsnet_tpu_torch.data.", "'rcmvsnet_tpu.data.")
    assert got == want
