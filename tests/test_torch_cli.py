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


def test_train_cli_bf16_step_on_cpu_and_refuses_bad_dtype(tmp_path,
                                                          monkeypatch):
    """`--train_dtype bfloat16` on the CPU: the backbone's train dtype and
    the render U-Net's (which follows it) are bf16, one step of the loop runs through the bf16 plain versions with
    finite losses, and a dtype other than float32 / bfloat16 is refused."""
    import json

    import sys
    from rcmvsnet_tpu_torch.cli import train as train_cli
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    args = ["--trainpath", "synthetic", "--max_steps", "1", "--epochs", "1",
            "--device", "cpu", "--num_view", "2", "--numdepth", "16",
            "--n_rays", "64", "--n_samples", "16", "--summary_freq", "1",
            "--logdir", str(tmp_path)]
    config = train_cli.config_from_args(train_cli.parse_args(
        args + ["--train_dtype", "bfloat16"]))
    from rcmvsnet_tpu_torch.train.state import make_models
    assert config.backbone.train_dtype == "bfloat16"
    assert make_models(config, 3)[1].train_dtype == torch.bfloat16
    assert train_cli.config_from_args(train_cli.parse_args(
        args)).backbone.train_dtype == "float32"
    train_cli.main(args + ["--train_dtype", "bfloat16"])
    recs = [json.loads(line) for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    train = [r for r in recs if r["mode"] == "train"]
    assert len(train) == 1 and np.isfinite(train[0]["loss"])
    with pytest.raises(SystemExit):
        train_cli.parse_args(args + ["--train_dtype", "float16"])


def test_train_cli_no_remat_sets_run_config(tmp_path, monkeypatch):
    """`--no_remat`: the train CLI's RunConfig.remat follows the flag (JAX
    `cli/train.py:91-95,126`): absent, both levels of remat, as the JAX
    defaults; given, none. The models' flag follows (`make_models`), and
    the data-parallel workers build their config from the same args."""
    from rcmvsnet_tpu_torch.cli import train as train_cli
    from rcmvsnet_tpu_torch.train.state import make_models
    args = ["--trainpath", "synthetic", "--device", "cpu", "--num_view", "2",
            "--logdir", str(tmp_path)]
    seen = []
    monkeypatch.setattr(train_cli, "fit",
                        lambda config, *a, **kw: seen.append(config))
    for extra, want in (([], True), (["--no_remat"], False)):
        run = train_cli.config_from_args(
            train_cli.parse_args(args + extra)).run
        assert (run.remat, run.remat_modules) == (want, True)
        cascade, render = make_models(train_cli.config_from_args(
            train_cli.parse_args(args + extra)), 3)
        assert cascade.remat is render.remat is want
        train_cli.main(args + extra)
        train_cli._train_rank(0, 1, torch.device("cpu"),
                              train_cli.parse_args(args + extra))
        assert [c.run.remat for c in seen[-2:]] == [want, want]
