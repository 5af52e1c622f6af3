"""The port's Tanks & Temples CLI (rcmvsnet_tpu_torch.cli.eval_tanks) and
rm_color against the JAX package's, on a synthetic scene in T&T layout
(128×160, V=4, 32 planes; cams_1 line 11 = depth min and *max*), with the
golden backbone on both sides and --device cpu on the port's: the same
output tree, every PFM within rtol = atol = 1e-4 (as tests/test_torch_cli.py
holds eval_dtu), the same fused ply, the same colourless ply from rm_color;
the per-scene tables equal the JAX CLI's; a CUDA device that is absent is
refused."""
from pathlib import Path

import numpy as np
import pytest
import torch

from rcmvsnet_tpu.cli import eval_tanks as jax_cli
from rcmvsnet_tpu.cli import rm_color as jax_rm_color
from rcmvsnet_tpu.core.io import load_ply, read_pfm
from rcmvsnet_tpu.data import tanks as jax_tanks
from rcmvsnet_tpu_torch.cli import eval_tanks as port_cli
from rcmvsnet_tpu_torch.cli import rm_color as port_rm_color
from rcmvsnet_tpu_torch.data import tanks as port_tanks
from rcmvsnet_tpu_torch.data.synthetic_tanks import write_tanks_scan
from rcmvsnet_tpu_torch.weights import ASSET

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
GOLDEN_CKPT = REPO / "tests" / "golden" / "backbone_synth.msgpack"
V, H, W = 4, 128, 160


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.fixture
def family_only(monkeypatch):
    for mod in (jax_tanks, jax_cli, port_tanks):
        monkeypatch.setattr(mod, "INTERMEDIATE_SCANS", ["Family"])
    # the scene has 3 source views: fuse with Family's thresholds but ask
    # for 2 consistent views, so both clouds hold points
    for mod in (jax_cli, port_cli):
        monkeypatch.setitem(mod.GEO_MASK_THRESHOLD, "Family", 2)


def test_tables_equal_jax_cli():
    for name in ("PHOTO_THRESHOLD", "GEO_MASK_THRESHOLD",
                 "GEO_PIXEL_THRESHOLD", "GEO_DEPTH_THRESHOLD",
                 "IMAGE_SIZES"):
        assert getattr(port_cli, name) == getattr(jax_cli, name), name
    assert port_tanks.INTERMEDIATE_SCANS == jax_tanks.INTERMEDIATE_SCANS
    assert port_tanks.ADVANCED_SCANS == jax_tanks.ADVANCED_SCANS


def test_cli_matches_jax_cli(tmp_path, family_only):
    scene = write_tanks_scan(tmp_path / "data", H, W, V)
    common = ["--testpath", str(tmp_path / "data"), "--split",
              "intermediate", "--num_view", str(V), "--numdepth", "32",
              "--img_wh", f"{W},{H}"]
    jax_cli.main(common + ["--loadckpt", str(GOLDEN_CKPT), "--n_devices",
                           "1", "--outdir", str(tmp_path / "jax")])
    port_cli.main(common + ["--loadckpt", str(ASSET), "--device", "cpu",
                            "--outdir", str(tmp_path / "port")])
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax")
    assert "Family.ply" in tree
    pfms = [p for p in tree if p.endswith(".pfm")]
    assert len(pfms) == 2 * V
    for p in pfms:
        got, _ = read_pfm(tmp_path / "port" / p)
        want, _ = read_pfm(tmp_path / "jax" / p)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=p)
        if "depth_est" in p:
            assert got.min() >= scene["depth_min"] - 1e-3
            assert got.max() <= scene["depth_max"] + 1e-3
    xyz_p, rgb_p = load_ply(tmp_path / "port" / "Family.ply")
    xyz_j, rgb_j = load_ply(tmp_path / "jax" / "Family.ply")
    assert len(xyz_p) > 0 and len(xyz_p) == len(xyz_j)
    np.testing.assert_allclose(xyz_p, xyz_j, rtol=1e-4, atol=1e-3)

    for pkg, cli in (("jax", jax_rm_color), ("port", port_rm_color)):
        cli.main(["--input_dir", str(tmp_path / "port"), "--output_dir",
                  str(tmp_path / f"nocolor_{pkg}")])
    a = (tmp_path / "nocolor_port" / "Family.ply").read_bytes()
    assert a == (tmp_path / "nocolor_jax" / "Family.ply").read_bytes()
    xyz, rgb = load_ply(tmp_path / "nocolor_port" / "Family.ply")
    np.testing.assert_array_equal(xyz, xyz_p)
    assert rgb is None


def test_cli_refuses_missing_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_cli.main(["--testpath", str(tmp_path), "--loadckpt",
                       str(ASSET), "--no_filter"])
