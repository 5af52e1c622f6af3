"""chip_smoke.py's own control flow, here on the CPU.

  * without a CUDA device it exits non-zero and prints no "ok" line;
  * in a directory holding only chip_smoke.py it fails even when a device
    is reported (nothing of the port to import);
  * its kernel phases (eval, train, bf16 and bf16 train) run end to end
    at a tiny size on CPU tensors (where every wrapper returns its plain version, so kernel
    and plain agree exactly; K4's rows carry the split of its time, with
    no device time on the CPU), and its main-path phases (eval and train)
    refuse a run in which no kernel was launched;
  * the Tanks & Temples path and the profiling tools run at a tiny size on
    the CPU and refuse a run that launched no kernel; the tools' K9 and
    K10 checks hold each call against its plain version;
  * the train-CLI phase (`cli.train.fit`: train, validate, save, restore,
    resume, render v1 and v2) refuses a run that launched no kernel and,
    with the launch counts set as a card would set them, runs through
    every one of its other checks at a tiny size;
  * the quality phase (16) holds the supervised golden's plain path to
    its JAX test and fails it on a corrupted depth map."""
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet  # noqa: E402
from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict  # noqa: E402

torch.set_num_threads(2)


def test_exits_nonzero_without_cuda():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "rcmvsnet_tpu_torch" in r.stderr
    assert '"ok"' not in r.stdout


SASS = """
        Function : _ZN12_GLOBAL__N_17conv3d_tcILi0ELi1ELi1EffEEvPKT2_PKvPKfPKT3_PS8_iiiiiiiiiiiiii
        /*0a40*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        Function : _ZN12_GLOBAL__N_117conv3d_bf16_tcILi0ELi1ELi1ELi16E13__nv_bfloat16EEvPKS1_PKjPKfPKT3_PS8_iiiiiiiiiiiiii
        /*0b40*/  %s R24, gdesc[UR4], R24 ;
        Function : _ZN12_GLOBAL__N_117prep_weights_bf16EPK13__nv_bfloat16Pjiiiiix
        /*0100*/  STG.E [R2.64], R5 ;
"""


@pytest.mark.parametrize("mma,missing", [
    ("HGMMA.64x8x16.F32.BF16", []), ("HMMA.16816.F32.BF16", []),
    ("FFMA", ["conv3d_bf16_tc"]), ("HMMA.1688.F32.TF32", ["conv3d_bf16_tc"])])
def test_sass_check_sees_wgmma_and_mma(mma, missing):
    """Phase 2's rule on SASS text: a bf16 tensor-core kernel passes with
    wgmma's HGMMA or mma.sync's HMMA on bf16 operands, fails with
    neither (or with TF32 ones); the float32 kernel has its TF32 HMMA;
    a kernel without "_tc" in its name is not held to it."""
    counts = chip_smoke.count_mma(SASS % mma)
    assert len(counts["kernels"]) == 3
    got = chip_smoke.missing_mma({"lib": counts})
    assert [k for k in missing if not any(k in g for g in got)] == []
    assert len(got) == len(missing)
    bad = chip_smoke.count_mma(SASS.replace("TF32", "BF16") % mma)
    assert any("conv3d_tcILi0" in k for k in chip_smoke.missing_mma(
        {"lib": bad}))


WARP_SASS = """
        Function : _ZN12_GLOBAL__N_125warp_variance_bf16_kernelILi%dELi3EEEvPK13__nv_bfloat16
        /*0a40*/  LDG.E.128.CONSTANT R4, desc[UR6][R2.64] ;
        /*0a50*/  @P0 LDG.E.LTC128B.128.CONSTANT R8, desc[UR6][R6.64] ;
        Function : _ZN12_GLOBAL__N_129warp_variance_bwd_bf16_kernelILi%dELi3EEEvPK13__nv_bfloat16
        /*0b40*/  LDG.E.64.CONSTANT R4, desc[UR6][R2.64] ;
        /*0b50*/  LDG.E.U16 R9, desc[UR6][R10.64] ;
        /*0b60*/  LDG.E.CONSTANT R11, desc[UR6][R12.64] ;
"""
F32_SASS = """
        Function : _ZN12_GLOBAL__N_120warp_variance_kernelILi32ELi3EEEvPKfS2_S2_S2_Pfiiiiii
        /*0a40*/  LDG.E.128.CONSTANT R4, desc[UR6][R2.64] ;
"""
VOLUME_SASS = """
        Function : _ZN12_GLOBAL__N_123warp_volume_bf16_kernelILi%dELi3ELb1EEEvPK13__nv_bfloat16S3_PKfS5_S5_PS1_S7_iiiiib
        /*0a40*/  LDG.E.128.CONSTANT R4, desc[UR6][R2.64] ;
        /*0a50*/  @P1 LDG.E.64.CONSTANT R8, desc[UR6][R6.64] ;
        Function : _ZN12_GLOBAL__N_127warp_volume_bwd_bf16_kernelILi%dELi3ELb1EEEvPK13__nv_bfloat16
        /*0b40*/  LDG.E.64.CONSTANT R4, desc[UR6][R2.64] ;
"""
VOLUME_F32_SASS = """
        Function : _ZN12_GLOBAL__N_122warp_volume_bwd_kernelILi32ELi3EEEvPKfS2_
        /*0a40*/  LDG.E.CONSTANT R4, desc[UR6][R2.64] ;
        Function : _ZN12_GLOBAL__N_118warp_volume_kernelILi32ELi3EEEvPKfS2_S2_S2_S2_PfS3_iiiiii
        /*0a40*/  LDG.E.128.CONSTANT R4, desc[UR6][R2.64] ;
"""
VOLUME_BF16_BWD_LEFT = """
        Function : _ZN12_GLOBAL__N_122warp_volume_bwd_kernelILi32ELi3E13__nv_bfloat16EEvPKT1_
        /*0a40*/  LDG.E.U16 R4, desc[UR6][R2.64] ;
"""
# the bf16 instance of the float32 template's forward, as the source held
# it before K7-bf16's own design
VOLUME_BF16_FWD_LEFT = """
        Function : _ZN12_GLOBAL__N_118warp_volume_kernelILi32ELi3E13__nv_bfloat16EEvPKT1_
        /*0a40*/  LDG.E.64.CONSTANT R4, desc[UR6][R2.64] ;
"""


def test_sass_check_sees_the_bf16_warp_loads():
    """Phase 2's rule on the bf16 warp kernels: each global load counted
    by its width whatever its other modifiers; every C present, K1-bf16
    and K7-bf16 with 16-byte gathers, K6-bf16 and K7bwd-bf16 with 8-byte
    ones, the float32 libraries without a bf16 function, and each breach
    reported: a narrow gather, a missing instance, a bf16 kernel left in
    a float32 library."""
    new = "".join(WARP_SASS % (c, c) for c in (8, 16, 32))
    vol = "".join(VOLUME_SASS % (c, c) for c in (8, 16, 32))
    loads = {"warp_variance_bf16": chip_smoke.sass_loads(new),
             "warp_variance": chip_smoke.sass_loads(F32_SASS),
             "warp_volume_bf16": chip_smoke.sass_loads(vol),
             "warp_volume": chip_smoke.sass_loads(VOLUME_F32_SASS)}
    k1 = [k for k in loads["warp_variance_bf16"] if "5warp" in k]
    assert len(loads["warp_variance_bf16"]) == 6 and len(k1) == 3
    assert loads["warp_variance_bf16"][k1[0]] == {"128": 2, "64": 0,
                                                  "32": 0, "16": 0}
    k6 = [k for k in loads["warp_variance_bf16"] if "bwd" in k][0]
    assert loads["warp_variance_bf16"][k6] == {"128": 0, "64": 1, "32": 1,
                                               "16": 1}
    assert chip_smoke.warp_bf16_faults(loads) == []
    narrow = {**loads, "warp_variance_bf16": chip_smoke.sass_loads(
        new.replace("LDG.E.64.", "LDG.E."))}
    assert len(chip_smoke.warp_bf16_faults(narrow)) == 3
    missing = {**loads, "warp_variance_bf16": chip_smoke.sass_loads(
        "".join(WARP_SASS % (c, c) for c in (8, 32)))}
    assert len(chip_smoke.warp_bf16_faults(missing)) == 2
    left = {**loads, "warp_variance": chip_smoke.sass_loads(
        F32_SASS + WARP_SASS % (8, 8))}
    assert len(chip_smoke.warp_bf16_faults(left)) == 2
    narrow = {**loads, "warp_volume_bf16": chip_smoke.sass_loads(
        vol.replace("LDG.E.64.", "LDG.E."))}
    assert len(chip_smoke.warp_bf16_faults(narrow)) == 3
    left = {**loads, "warp_volume": chip_smoke.sass_loads(
        VOLUME_F32_SASS + VOLUME_BF16_BWD_LEFT)}
    assert len(chip_smoke.warp_bf16_faults(left)) == 1
    k7 = [k for k in loads["warp_volume_bf16"] if "volume_bf16_kernel" in k]
    assert len(k7) == 3 and loads["warp_volume_bf16"][k7[0]] == {
        "128": 1, "64": 1, "32": 0, "16": 0}
    # K7-bf16 gathering 8 bytes a tap, without its C = 16 instance, or its
    # bf16 forward left in the float32 library
    narrow = {**loads, "warp_volume_bf16": chip_smoke.sass_loads(
        vol.replace("LDG.E.128.", "LDG.E.64."))}
    assert chip_smoke.warp_bf16_faults(narrow) == [
        f"warp_volume_bf16_kernel C={c}: {[k]}"
        for c, k in zip((8, 16, 32), k7)]
    missing = {**loads, "warp_volume_bf16": chip_smoke.sass_loads(
        VOLUME_SASS % (8, 8) + VOLUME_SASS % (32, 32))}
    assert len(chip_smoke.warp_bf16_faults(missing)) == 2
    left = {**loads, "warp_volume": chip_smoke.sass_loads(
        VOLUME_F32_SASS + VOLUME_BF16_FWD_LEFT)}
    assert chip_smoke.warp_bf16_faults(left) == [
        "_ZN12_GLOBAL__N_118warp_volume_kernelILi32ELi3E13__nv_bfloat16EEv"
        "PKT1_"]


K5_SASS = """
        Function : _ZN12_GLOBAL__N_114conv2d_bf16_tcILi3ELi1ELi4ELi1ELi8EEEvPK13__nv_bfloat16PKjPKfS7_S4_PS2_iiiiiiiiiiii
        /*0a40*/  LDS R4, [R2+0x10] ;
        /*0a50*/  HMMA.1688.F32.BF16 R8, R4, R12, R8 ;
        Function : _ZN12_GLOBAL__N_114conv2d_bf16_tcILi3ELi1ELi1ELi4ELi16EEEvPK13__nv_bfloat16PKjPKfS7_S4_PS2_iiiiiiiiiiii
        /*0a40*/  LDS.64 R4, [R2+0x10] ;
        /*0a50*/  HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0a60*/  LDS.128 R20, [R3] ;
        Function : _ZN12_GLOBAL__N_122lateral_conv2d_bf16_tcILi4EEEvPK13__nv_bfloat16S3_S3_PKfPKjPS1_iiiiiiiiiiii
        /*0a40*/  LDS.64 R4, [R2+0x10] ;
        /*0a50*/  HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        Function : _ZN12_GLOBAL__N_118conv2d_bf16_directILi1ELi1ELi8ELb1EEEvPK13__nv_bfloat16
        /*0a40*/  LDS.U16 R4, [R2] ;
"""
K5_F32_SASS = """
        Function : _ZN12_GLOBAL__N_19conv2d_tcILi3ELi1ELi4ELi1EEEvPKfPKvS2_S2_S2_Pfiiiiiiiiiii
        /*0a50*/  HMMA.1688.F32.TF32 R8, R4, R12, R8 ;
"""


def test_sass_check_sees_the_k5_bf16_fragment_path():
    """Phase 2's rule on K5-bf16: each shared load counted by width (a
    32-bit LDS has no width modifier, ldmatrix is not an LDS); every
    tensor-core kernel with a bf16 HMMA of either shape, both shapes
    built, no 16-bit shared load in a tensor-core kernel (the direct
    kernel is not held to it), no bf16 function left in `conv2d.cu`."""
    lds = chip_smoke.sass_loads(K5_SASS + "        /*0a70*/  LDSM.16.M88.4 "
                                "R4, [R2] ;\n", "LDS")
    tc = [k for k in lds if "conv2d_bf16_tc" in k]
    assert len(tc) == 3
    assert lds[tc[0]] == {"128": 0, "64": 0, "32": 1, "16": 0}
    assert lds[tc[1]] == {"128": 1, "64": 1, "32": 0, "16": 0}
    assert chip_smoke.k5_bf16_faults(K5_SASS, K5_F32_SASS) == []
    narrow = K5_SASS.replace("LDS.64 R4", "LDS.U16 R4")
    assert len(chip_smoke.k5_bf16_faults(narrow, K5_F32_SASS)) == 2
    no_k8 = K5_SASS.replace("HMMA.1688.F32.BF16", "FFMA")
    assert len(chip_smoke.k5_bf16_faults(no_k8, K5_F32_SASS)) == 2
    assert len(chip_smoke.k5_bf16_faults(K5_SASS,
                                         K5_F32_SASS + K5_SASS)) == 4


def test_phases_run_on_cpu_and_main_path_demands_launches():
    scene = chip_smoke.plane_scene(64, 96, 3, chip_smoke.SEED)
    samples = chip_smoke.dtu_samples(scene, 96)
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model.eval()

    def cpu_ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    dev = torch.device("cpu")
    ledger = chip_smoke.Ledger(
        timer=cpu_ms, split=lambda fn: chip_smoke.split_times(fn, dev))
    with torch.no_grad():
        chip_smoke.phase_kernels(model, samples, scene, ledger, dev)
    calls = {k: ledger.summary(k)["calls"]
             for k in ("conv2d", "warp_variance", "conv3d", "depth_tail")}
    assert calls == {"conv2d": 12, "warp_variance": 3, "conv3d": 33,
                     "depth_tail": 3}
    assert all(r["max_abs_err"] == 0.0 for r in ledger.rows)
    k5 = [r for r in ledger.rows if r["kernel"] == "conv2d"]
    assert [r["route"] for r in k5] == ["direct"] + ["tc"] * 7 + [
        "direct", "direct", "tc", "lateral"]
    assert all(r["bound_tc_ms"] > 0 for r in k5)
    assert k5[-1]["library_ms"] is None and k5[-1]["library_unfused_ms"] > 0
    # K4's rows split its time; on the CPU no device time is measured
    for r in ledger.rows:
        split = r["kernel"] == "depth_tail"
        assert ("device_ms" in r) == split
        if split:
            assert r["device_ms"] is None and r["device_kernels"] == []
            assert r["host_ms"] > 0
    s4 = ledger.summary("depth_tail")
    assert s4["device_ms"] is None and s4["host_ms"] > 0
    s5 = ledger.summary("conv2d")
    assert s5["library_ms"] is None
    assert s5["library_unfused_ms"] == pytest.approx(
        sum(r["library_ms"] for r in k5[:-1]) + k5[-1]["library_unfused_ms"])
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_main(model, samples[:1], scene, dev)


def test_bf16_phases_run_on_cpu_and_demand_launches():
    """Phase 12 at a tiny size on the CPU: every bf16 call of K5, K1 and K2
    against its plain version (here the same function, so no element is
    beyond its ulp gate), bounds at the bf16 tensor cores' rate; the end
    to end part refuses a run that launched no bf16 instance."""
    scene = chip_smoke.plane_scene(64, 96, 3, chip_smoke.SEED)
    samples = chip_smoke.dtu_samples(scene, 96)
    model = _golden_model()
    dev = torch.device("cpu")
    ledger = chip_smoke.Ledger(timer=lambda fn: 1.0)
    ledger.phase = "bf16"
    with torch.no_grad():
        chip_smoke.phase_kernels(model, samples, scene, ledger, dev,
                                 torch.bfloat16)
    calls = {k: ledger.summary(k, "bf16")["calls"]
             for k in chip_smoke.BF16_KERNELS}
    assert calls == {"conv2d_bf16": 12, "warp_variance_bf16": 3,
                     "conv3d_bf16": 33}
    assert all(r["elements_over_tol"] == 0 and r["max_abs_err"] == 0.0
               for r in ledger.rows)
    dtypes = {r["dtype"] for r in ledger.rows}
    assert dtypes == {"torch.bfloat16", "torch.float32"}   # + the prob head
    for r in ledger.rows:
        if r["kernel"] != "warp_variance_bf16":
            assert r["bound_tc_ms"] == r["bound_ms"] > 0
    with pytest.raises(AssertionError, match="bf16_dtu_path never launched"):
        chip_smoke.phase_bf16(model, samples[:1], scene, [], [], ({}, {}),
                              "cpu", dev)


def test_train_phases_run_on_cpu_and_demand_launches():
    from rcmvsnet_tpu_torch.config import Config, RenderConfig
    from rcmvsnet_tpu_torch.data.synthetic import batch_from_views
    from rcmvsnet_tpu_torch.train.state import make_models
    from rcmvsnet_tpu_torch.train.step import batch_to
    scene = chip_smoke.plane_scene(64, 64, 3, chip_smoke.SEED)
    batch = batch_to(batch_from_views([scene], 64, chip_smoke.SEED), "cpu")
    cfg = Config(render=RenderConfig(n_rays=16, n_samples=8, num_planes=16))
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model.eval()
    render = make_models(cfg, 3)[1]
    ledger = chip_smoke.Ledger(timer=lambda fn: 0.0)
    with torch.no_grad():
        chip_smoke.phase_train_kernels(model, render, batch, scene, ledger,
                                       torch.device("cpu"))
    calls = {k: ledger.summary(k, "train")["calls"]
             for k in ("warp_variance", "warp_variance_bwd", "warp_volume",
                       "warp_volume_bwd", "conv3d", "conv3d_dw")}
    assert calls == {"warp_variance": 3, "warp_variance_bwd": 3,
                     "warp_volume": 1, "warp_volume_bwd": 1,
                     "conv3d": 2 * 43, "conv3d_dw": 43}
    assert all(r["max_abs_err"] == 0.0 for r in ledger.rows)
    assert all(r["bound_ms"] > 0 for r in ledger.rows)
    scatter = [r for r in ledger.rows if r["kernel"] in ("warp_variance_bwd",
                                                          "warp_volume_bwd")]
    assert all(r["repeat"]["differing"] == 0 and r["merge_factor"] >= 1
               and r["int_adds"] > 0 for r in scatter)
    assert ledger.summary("warp_volume_bwd", "train")["repeats_bit_for_bit"]
    with pytest.raises(AssertionError, match="train path never launched"):
        chip_smoke.phase_train(batch, load_state_dict(ASSET), "cpu",
                               torch.device("cpu"), cfg, warmup=1, timed=1)


def test_bf16_train_phases_run_on_cpu_and_demand_launches():
    """Phase 14 at a tiny size: (a) every train kernel's bf16 instance
    against its bf16 plain version (on the CPU both are the plain
    version: no error), rows "<kernel>_bf16" of phase "bf16_train" with
    bf16 outputs (the prob head's forward and dw float32); (b) the bf16
    step refuses a run that launched none of its instances."""
    from rcmvsnet_tpu_torch.config import Config, RenderConfig
    from rcmvsnet_tpu_torch.data.synthetic import batch_from_views
    from rcmvsnet_tpu_torch.train.state import make_models
    from rcmvsnet_tpu_torch.train.step import batch_to
    scene = chip_smoke.plane_scene(64, 64, 3, chip_smoke.SEED)
    batch = batch_to(batch_from_views([scene], 64, chip_smoke.SEED), "cpu")
    cfg = Config(render=RenderConfig(n_rays=16, n_samples=8, num_planes=16))
    render = make_models(cfg, 3)[1]
    ledger = chip_smoke.Ledger(timer=lambda fn: 0.0)
    with torch.no_grad():
        chip_smoke.phase_train_kernels(_golden_model(), render, batch, scene,
                                       ledger, torch.device("cpu"),
                                       torch.bfloat16)
    calls = {k: ledger.summary(k, "bf16_train")["calls"]
             for k in chip_smoke.BF16_TRAIN_KERNELS}
    assert calls == {"warp_variance_bf16": 3, "warp_variance_bwd_bf16": 3,
                     "warp_volume_bf16": 1, "warp_volume_bwd_bf16": 1,
                     "conv3d_bf16": 2 * 43, "conv3d_dw_bf16": 43}
    assert all(r["max_abs_err"] == 0.0 and r["bound_ms"] > 0
               for r in ledger.rows)
    f32 = [r["label"] for r in ledger.rows if r["dtype"] == "torch.float32"]
    assert len(f32) == 43 + 3 and all(
        "prob" in lab or "fwd" not in lab for lab in f32)
    assert ledger.summary("warp_volume_bwd_bf16",
                          "bf16_train")["repeats_bit_for_bit"]
    with pytest.raises(AssertionError,
                       match="bf16 train path never launched"):
        chip_smoke.phase_bf16_train(batch, load_state_dict(ASSET), {},
                                    "cpu", torch.device("cpu"), cfg,
                                    warmup=1, timed=1)


def _golden_model():
    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    return model.eval()


def test_tanks_phase_runs_on_cpu_and_demands_launches():
    with pytest.raises(AssertionError, match="tanks_path never launched"):
        chip_smoke.phase_tanks(_golden_model(), torch.device("cpu"), "cpu",
                               shape=(64, 96, 3))


def test_tools_phases_run_on_cpu_and_demand_launches():
    from rcmvsnet_tpu_torch.tools import profile_conv3d as PC
    scene = chip_smoke.plane_scene(64, 96, 3, chip_smoke.SEED)
    sample = chip_smoke.dtu_samples(scene, 96)[0]
    model = _golden_model()
    dev = torch.device("cpu")
    cases = [(label, D, H // 32, W // 32, ci, co, mode)
             for label, D, H, W, ci, co, mode in PC.CASES]
    with torch.no_grad():
        with pytest.raises(AssertionError,
                           match="tools path never launched"):
            chip_smoke.phase_tools(model, sample, dev, cases)
        ledger = chip_smoke.Ledger(timer=lambda fn: 0.0)
        chip_smoke.phase_tools_kernels(model, sample, ledger, dev, cases)
    calls = {k: ledger.summary(k, "tools")["calls"]
             for k in ("warp_view", "warp_view_route", "conv3d_lanewise")}
    assert calls == {"warp_view": 3 * 2, "warp_view_route": 3,
                     "conv3d_lanewise": 8 + 3}
    assert all(r["max_abs_err"] <= r["tol"] for r in ledger.rows)
    assert all(r["bound_ms"] > 0 for r in ledger.rows)


def test_train_cli_phase_runs_on_cpu_and_demands_launches(tmp_path,
                                                          monkeypatch):
    from rcmvsnet_tpu_torch.config import Config, RenderConfig
    # the logger's TensorBoard mirror (importing TensorFlow) is not under
    # test here
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scene = chip_smoke.plane_scene(64, 96, 3, chip_smoke.SEED)
    sample = chip_smoke.dtu_samples(scene, 96)[0]
    dev = torch.device("cpu")
    kw = dict(shape=(64, 64, 3), ndepth=64, steps=2, cfg=Config(
        render=RenderConfig(n_rays=16, n_samples=8, num_planes=16)))
    with pytest.raises(AssertionError, match="train CLI never launched"):
        chip_smoke.phase_train_cli(sample, "cpu", dev, tmp_path / "a", **kw)

    real = chip_smoke.zero_launches

    def counted():                      # every kernel "launched" once
        wrappers = real()
        for fn in wrappers.values():
            fn.launches = 1
        return wrappers

    monkeypatch.setattr(chip_smoke, "zero_launches", counted)
    r = chip_smoke.phase_train_cli(sample, "cpu", dev, tmp_path / "b", **kw)
    real()
    assert r["val_depth_max_rel_delta_vs_plain"] == 0.0
    assert r["ckpt_depth_max_rel_delta_vs_plain"] == 0.0
    assert len(r["losses"]) == 2 * 2 and len(r["save_s"]) == 2
    assert r["steps_per_s_with_loading"] > 0 and r["val_batches_per_s"] > 0
    assert r["steps_per_s_without_summaries"] >= r["steps_per_s_with_loading"]
    assert set(r["render_variants"]) == {"v1", "v2"}
    names = {p.name for p in (tmp_path / "b").iterdir()}
    assert {f"model_00000{e}_{k}.ckpt" for e in range(3)
            for k in ("cas", "nerf")} <= names


def test_remat_phase_runs_on_cpu_and_demands_recompute(capsys):
    """Phase 15 at a tiny size in float32: the steps with pass-level remat
    and with both levels equal the step without remat in every bit, and
    so do the two more runs without remat (the CPU step repeats); the
    phase then refuses the run, whose recomputed kernels read no more
    launches than without remat (none, here)."""
    import json

    from rcmvsnet_tpu_torch.config import Config, RenderConfig
    from rcmvsnet_tpu_torch.data.synthetic import batch_from_views
    from rcmvsnet_tpu_torch.train.step import batch_to
    scene = chip_smoke.plane_scene(32, 32, 3, chip_smoke.SEED)
    batch = batch_to(batch_from_views([scene], 32, chip_smoke.SEED), "cpu")
    cfg = Config(render=RenderConfig(n_rays=16, n_samples=8, num_planes=16))
    with pytest.raises(AssertionError, match="float32 both: recomputed "
                                             "kernels not above"):
        chip_smoke.phase_remat(batch, load_state_dict(ASSET), "cpu",
                               torch.device("cpu"), cfg,
                               dtypes=("float32",), timed=1)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"remat"')]
    res = json.loads(line[0])["remat"]["float32"]
    assert list(res["settings"]) == ["none", "pass", "both"]
    assert list(res["compared_to_none"]) == ["pass", "both", "none2",
                                             "none3"]
    for c in res["compared_to_none"].values():
        assert not (c["step1_metrics_differing"]
                    or c["step1_buffers_differing"]
                    or c["num_batches_tracked_differing"])
        for part in ("step1_grads", "step2_grads", "step2_running_stats"):
            assert all(v == [0.0, 0] for v in c[part].values()), part
        assert set(c["step2_loss_rel"].values()) == {0.0}
    assert all(res["step1_grads_repeat_without_remat"].values())
    for name, setting in res["settings"].items():
        assert setting["steps_per_s"] > 0 and setting["peak_bytes"] is None
        assert len(setting["step_losses"]) == 2
        assert set(setting["launches_per_step"]) == set(
            chip_smoke.RECOMPUTED_KERNELS + chip_smoke.BACKWARD_KERNELS)


def test_quality_phase_runs_on_cpu_and_fails_a_corrupted_depth(
        capsys, monkeypatch):
    """Phase 16 at the supervised golden through the plain path: the
    JAX test's bounds and pins hold, nothing launched, no flip against
    itself. Then every depth map scaled by 1.02 (the same maps, so no second
    forward) must fail the gates, after the result line is printed."""
    import json

    from rcmvsnet_tpu_torch.tools import quality
    maps = []
    real = quality.infer_views

    def infer(*args, **kwargs):
        if not maps:
            maps.extend(real(*args, **kwargs))
            return maps
        return [(d * 1.02, c) for d, c in maps]

    monkeypatch.setattr(quality, "infer_views", infer)
    paths = (("float32_plain", "float32", True),)
    dev = torch.device("cpu")
    res = chip_smoke.phase_quality("cpu", dev, ("sup",), paths)
    row = res["sup"]["float32_plain"]
    m = row["metrics"]
    assert m["n_fused_raw"] > 50_000 and m["acc_mean"] < 1.0
    assert m["comp_mean"] < 2.0 and row["launches"] == {}
    assert row["vs_float32_plain"] == {
        "final_mask_flip_rate": 0.0, "acc_delta": 0.0, "comp_delta": 0.0,
        "overall_rel_delta": 0.0}
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert printed["quality"]["sup"]["float32_plain"]["metrics"] == m
    with pytest.raises(AssertionError, match="quality: sup float32_plain"):
        chip_smoke.phase_quality("cpu", dev, ("sup",), paths)
    assert '"quality"' in capsys.readouterr().out
