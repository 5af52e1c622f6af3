"""The port's DTU eval CLI (rcmvsnet_tpu_torch.cli.eval_dtu) on a synthetic
DTU-layout scan with --device cpu: it writes the same output tree as the
JAX CLI (depth/confidence PFMs, cams, images, visualizations, fused ply),
with the same depths, and refuses a CUDA device that is absent."""
from pathlib import Path

import numpy as np
import pytest
import torch

from rcmvsnet_tpu.cli import eval_dtu as jax_cli
from rcmvsnet_tpu.core.io import read_pfm
from rcmvsnet_tpu.data.synthetic import write_synthetic_scan
from rcmvsnet_tpu_torch.cli import eval_dtu as port_cli
from rcmvsnet_tpu_torch.weights import ASSET

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
GOLDEN_CKPT = REPO / "tests" / "golden" / "backbone_synth.msgpack"


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_cli_output_tree_matches_jax_cli(tmp_path):
    write_synthetic_scan(tmp_path / "data", H=64, W=96, V=3)
    common = ["--testpath", str(tmp_path / "data"), "--testlist", "scan1",
              "--num_view", "3", "--numdepth", "64", "--max_h", "64",
              "--max_w", "96", "--prob_thres", "0.0",
              "--num_consistency", "1", "--num_worker", "1"]
    jax_cli.main(common + ["--loadckpt", str(GOLDEN_CKPT),
                           "--outdir", str(tmp_path / "jax")])
    port_cli.main(common + ["--loadckpt", str(ASSET), "--device", "cpu",
                            "--outdir", str(tmp_path / "port")])
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax")
    assert "mvsnet001_l3.ply" in tree
    pfms = [p for p in tree if p.endswith(".pfm")]
    assert len(pfms) == 6
    for p in pfms:
        got, _ = read_pfm(tmp_path / "port" / p)
        want, _ = read_pfm(tmp_path / "jax" / p)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=p)


def test_cli_refuses_missing_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_cli.main(["--testpath", str(tmp_path), "--testlist", "scan1",
                       "--loadckpt", str(ASSET), "--no_filter"])


def test_cli_bf16_eval_within_the_fused_path_budget(tmp_path):
    """`--eval_dtype bfloat16 --no_pallas --device cpu`: the bf16 eval path
    (its plain versions) writes depth maps that differ from the float32
    run's, with at most 0.1 % of pixels beyond the fusion's 0.01 relative
    gate (the fused TPU path's budget, tests/test_parity_budget.py)."""
    write_synthetic_scan(tmp_path / "data", H=64, W=96, V=3)
    common = ["--testpath", str(tmp_path / "data"), "--testlist", "scan1",
              "--num_view", "3", "--numdepth", "64", "--max_h", "64",
              "--max_w", "96", "--num_worker", "1", "--loadckpt", str(ASSET),
              "--device", "cpu", "--no_pallas", "--no_filter"]
    port_cli.main(common + ["--outdir", str(tmp_path / "f32")])
    port_cli.main(common + ["--outdir", str(tmp_path / "bf16"),
                            "--eval_dtype", "bfloat16"])
    pfms = sorted((tmp_path / "f32" / "scan1" / "depth_est").glob("*.pfm"))
    assert len(pfms) == 3
    differ, above, n = False, 0, 0
    for p in pfms:
        f32, _ = read_pfm(p)
        bf16, _ = read_pfm(tmp_path / "bf16" / "scan1" / "depth_est" / p.name)
        rel = np.abs(bf16 - f32) / np.abs(f32)
        differ |= bool((bf16 != f32).any())
        above += int((rel > 0.01).sum())
        n += rel.size
    assert differ and above <= 1e-3 * n, (differ, above, n)
