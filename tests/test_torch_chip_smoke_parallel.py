"""chip_smoke.py's phases 10 and 11 and its rows past the repaired widths,
here on the CPU at a tiny size (where every wrapper returns its plain
version):
  * the "wide" rows of phases 3 and 5 (K4 at D 96 and 192, K8 dw at 128
    output channels in s1 and s2) run and agree exactly, and leave the
    main paths' sums (phase "eval") alone;
  * phase 10's eval at --ndepths 96,32,8 refuses a run that launched no
    kernel; its train step at --cr_base_chs 16,16,16, with the launch
    counts set as a card would set them, passes its checks;
  * phase 11 runs end to end: (a) a one-rank Gloo group gives the
    single-device step's metrics in every bit, (b) two spawned CPU ranks
    (FileStore, killed at TIMEOUT seconds) meet the B=2 step's gates with
    equal parameters, (c) two ranks' sharded eval passes phase 4's gate;
    only then does it refuse the run for the kernels it never launched."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from rcmvsnet_tpu_torch.config import Config, RenderConfig  # noqa: E402
from rcmvsnet_tpu_torch.data.synthetic import batch_from_views  # noqa: E402
from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict  # noqa: E402

torch.set_num_threads(2)
TIMEOUT = 240
CFG = Config(render=RenderConfig(n_rays=16, n_samples=8, num_planes=16))
CPU = torch.device("cpu")


def test_wide_kernel_rows_run_on_cpu():
    ledger = chip_smoke.Ledger(timer=lambda fn: 0.0)
    with torch.no_grad():
        chip_smoke.phase_wide_kernels(
            ledger, CPU, (("D96", 96, 6, 8), ("D192", 192, 5, 7)),
            (("s2 64>128", 16, 128, (4, 6, 8), "s2"),
             ("s1 128>128", 16, 128, (2, 3, 4), "s1")))
    assert ledger.summary("depth_tail", "wide")["calls"] == 2
    assert ledger.summary("conv3d_dw", "wide")["calls"] == 2
    assert all(r["phase"] == "wide" for r in ledger.rows)
    assert all(r["max_abs_err"] == 0.0 and r["bound_ms"] > 0
               for r in ledger.rows)
    assert [r["shape"] for r in ledger.rows if r["kernel"] ==
            "conv3d_dw"] == [[128, 16, 3, 3, 3]] * 2


def _batch(n):
    scenes = [chip_smoke.plane_scene(64, 64, 3, chip_smoke.SEED + i)
              for i in range(n)]
    return batch_from_views(scenes, 64, chip_smoke.SEED)


def test_wide_paths_demand_launches(monkeypatch):
    scene = chip_smoke.plane_scene(64, 96, 3, chip_smoke.SEED)
    samples = chip_smoke.dtu_samples(scene, 96)
    from rcmvsnet_tpu_torch.train.step import batch_to
    batch = batch_to(_batch(1), CPU)
    with pytest.raises(AssertionError, match="wide_eval_path never"):
        chip_smoke.phase_wide_paths(samples[:1], scene, batch, "cpu", CPU,
                                    CFG)
    with pytest.raises(AssertionError, match="wide train path never"):
        chip_smoke.wide_train_step(batch, "cpu", CPU, CFG)
    real = chip_smoke.zero_launches

    def counted():                      # every kernel "launched" once
        wrappers = real()
        for fn in wrappers.values():
            fn.launches = 1
        return wrappers

    monkeypatch.setattr(chip_smoke, "zero_launches", counted)
    r = chip_smoke.wide_train_step(batch, "cpu", CPU, CFG)
    real()
    assert np.isfinite(r["step1_metrics"]["loss"])


def test_parallel_phase_runs_on_cpu(tmp_path, monkeypatch):
    from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet, infer_views
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import (batch_to, draw_step,
                                               make_train_step)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sd = load_state_dict(ASSET)
    batch1 = batch_to(_batch(1), CPU)
    draws1 = draw_step(torch.Generator().manual_seed(1), CFG, 1, 64, 64)
    state = create_train_state(CFG, 3, 1000, CPU, seed=chip_smoke.SEED,
                               state_dicts=(sd, None))
    phase6 = {"step1_metrics_kernel": {
        k: float(v) for k, v in make_train_step(CFG)(
            state, batch1, draws1).items()}}
    del state
    shape, ndepth = (64, 96, 3), 96
    model = CascadeMVSNet()
    model.load_state_dict(sd, strict=True)
    eval_out = infer_views(model.eval(), chip_smoke.dtu_samples(
        chip_smoke.plane_scene(*shape, chip_smoke.SEED), ndepth), CPU)
    batch2 = _batch(2)
    draws2 = draw_step(torch.Generator().manual_seed(2), CFG, 2, 64, 64)
    with pytest.raises(AssertionError,
                       match="parallel ranks never launched") as e:
        chip_smoke.phase_parallel(batch1, draws1, batch2, draws2, sd,
                                  phase6, eval_out, "cpu", CPU, tmp_path,
                                  CFG, shape, ndepth, timed=1,
                                  timeout=TIMEOUT)
    # every rank and both phases reported their launches (none, here)
    assert "(1, 'conv3d_dw')" in str(e.value)
    assert {p.name for p in tmp_path.iterdir()} == {
        "dp_step0.pt", "dp_step1.pt", "dp_eval0.pt", "dp_eval1.pt"}
