"""The port's profiling entry points (rcmvsnet_tpu_torch.tools) on the
CPU, through the plain versions, at a tiny shape (the module's shape
constants patched): each prints its host-clock lines under a CPU label,
times every component it names, and refuses a CUDA device that is
absent (as do the kernel A/B tools, which run on the card only, and the
quality tool, tests/test_torch_quality.py). The
warp-backward repeat tool reports every call's two runs, which the plain
versions give equal. The K5 A/B tool imports a tree's package under an
alias and lists FeatureNet's 13 calls and the eval path's forms of them,
each of which equals its plain version, and the bf16 eval path's 12
calls, whose heads equal the bf16 `forward_folded`. The K4 A/B tool runs its turns
on the CPU through the plain version, with the device time "not
measured"; the forward-warp A/B tool lists K1's six calls and K7's,
reads each build's K7 and K7-bf16 interfaces from its sources, and serves
a build's bf16 entries from whichever source holds them. The K10 A/B tool runs
its turns on the CPU through the plain version at a tiny DTU shape, with
each stage's and the total's times beside the bound, F.grid_sample's and
a fill of the output. The train-step profiler times its seven calls
(each pass's forward and gradient, and the step) at a tiny cell, remat
at both levels unless --no_remat, traces a step (no device time on the
CPU), and its trace aggregate splits a hand-made trace as the card's
would be split."""
import json
from functools import partial

import pytest
import torch

from rcmvsnet_tpu_torch.tools import (ab_conv2d, ab_conv3d, ab_depth_tail,
                                      ab_warp_bwd, ab_warp_fwd,
                                      ab_warp_view, profile_breakdown,
                                      profile_conv3d, profile_train,
                                      quality, repeat_warp_bwd)
from rcmvsnet_tpu_torch.tools.timing import make_timer

torch.set_num_threads(2)


def test_profile_breakdown_cpu(capsys, monkeypatch):
    for name, value in (("H", 64), ("W", 96), ("VIEWS", 3), ("NDEPTH", 32)):
        monkeypatch.setattr(profile_breakdown, name, value)
    monkeypatch.setattr(profile_breakdown, "make_timer",
                        partial(make_timer, reps=1, warmup=0))
    res = profile_breakdown.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("device: cpu (host clock; no device metric) | "
                      "96x64 V=3 32 planes")
    stages = [f"stage{s}_{part}" for s in (1, 2, 3)
              for part in ("warp_k1", "warp_k10", "costreg", "tail")]
    assert set(res) == {"total", "featurenet", *stages}
    assert all(v > 0 for v in res.values())
    assert json.loads(out[-1])["ms"] == res
    assert "stage1 per-view warp+var K10 route [2 views]" in "\n".join(out)


def test_profile_breakdown_bf16_cpu(capsys, monkeypatch):
    """--eval_dtype bfloat16 times the bf16 eval path's components (the
    plain versions here): the same components, the dtype in the header
    and the JSON line."""
    for name, value in (("H", 64), ("W", 96), ("VIEWS", 3), ("NDEPTH", 32)):
        monkeypatch.setattr(profile_breakdown, name, value)
    monkeypatch.setattr(profile_breakdown, "make_timer",
                        partial(make_timer, reps=1, warmup=0))
    res = profile_breakdown.main(["--device", "cpu", "--eval_dtype",
                                  "bfloat16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("96x64 V=3 32 planes bfloat16")
    assert len(res) == 14 and all(v > 0 for v in res.values())
    assert json.loads(out[-1])["eval_dtype"] == "bfloat16"


def test_profile_conv3d_cpu(capsys, monkeypatch):
    tiny = tuple((label, D, H // 32, W // 32, ci, co, mode) for
                 label, D, H, W, ci, co, mode in profile_conv3d.CASES)
    monkeypatch.setattr(profile_conv3d, "CASES", tiny)
    monkeypatch.setattr(profile_conv3d, "make_timer",
                        partial(make_timer, reps=1, warmup=0))
    rows = profile_conv3d.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu (host clock")
    assert [r["label"] for r in rows] == [c[0] for c in tiny]
    assert all(r["ms"] > 0 and r["gflop"] > 0 for r in rows)
    assert rows[3]["shape"] == [16, 6, 9, 16, 8] and rows[3]["mode"] == "t2"
    assert json.loads(out[-1])["cases"] == rows


def test_repeat_warp_bwd_cpu(capsys):
    rows = repeat_warp_bwd.run(torch.device("cpu"), shape=(64, 80, 3))
    out = capsys.readouterr().out.splitlines()
    f32 = ["warp_variance_bwd stage1 V3 16x20 C32 D48",
           "warp_volume_bwd stage1 V3 16x20 C32 D48",
           "warp_variance_bwd stage2 V3 32x40 C16 D32",
           "warp_variance_bwd stage3 V3 64x80 C8 D8"]
    assert [r["call"] for r in rows] == f32 + [f"bf16 {c}" for c in f32]
    assert all(r["differing"] == 0 and r["max_abs"] > 0 for r in rows)
    assert rows[1]["elements"] == 3 * 16 * 20 * (32 + 3)
    assert [json.loads(line) for line in out] == rows


def test_ab_conv2d_lists_the_calls_of_a_tree_cpu():
    """A tree loaded under an alias: FeatureNet's 13 calls, the
    warp-layout heads, the lateral head and forward_folded; on the CPU
    each form is its plain version."""
    from rcmvsnet_tpu_torch.nn.featurenet import FeatureNet
    tree = ab_conv2d.load_tree(ab_conv2d.ROOT, "_ab_tree_test")
    torch.manual_seed(0)
    net = FeatureNet(8).eval()
    x = torch.randn(2, 3, 16, 24)
    with torch.no_grad():
        calls, lateral = ab_conv2d.featurenet_calls(net, x)
        forms = ab_conv2d.tree_calls(tree, calls, lateral, net)
        base = [c[0] for c in calls]
        assert base == ["conv0.0", "conv0.1", "conv1.0", "conv1.1",
                        "conv1.2", "conv2.0", "conv2.1", "conv2.2", "out1",
                        "inner1+up", "out2", "inner2+up", "out3"]
        want = []
        for b in base:
            want += [b] + ([f"{b} warp"] if b in ("out1", "out2", "out3")
                           else [])
        assert list(forms) == want + ["out3 lateral warp", "forward_folded"]
        for label, (fk, fp) in forms.items():
            assert ab_conv2d._err(fk(), fp()) <= 1e-6, label
        folded = forms["forward_folded"][0]()
        assert folded["stage3"].shape == (2, 16, 24, 8)


def test_ab_conv2d_lists_the_bf16_eval_calls_cpu():
    """The bf16 rows are the bf16 eval path's 12 calls: their heads equal
    `forward_folded(dtype=bfloat16, out_layout="warp")` in every bit."""
    from rcmvsnet_tpu_torch.nn.featurenet import FeatureNet
    tree = ab_conv2d.load_tree(ab_conv2d.ROOT, "_ab_tree_test_bf16")
    torch.manual_seed(0)
    net = FeatureNet(8).eval()
    x = torch.randn(2, 3, 16, 24)
    with torch.no_grad():
        calls, lateral = ab_conv2d.featurenet_calls_bf16(net, x)
        forms = ab_conv2d.tree_calls_bf16(tree, calls, lateral)
        assert list(forms) == [
            "bf16 conv0.0", "bf16 conv0.1", "bf16 conv1.0", "bf16 conv1.1",
            "bf16 conv1.2", "bf16 conv2.0", "bf16 conv2.1", "bf16 conv2.2",
            "bf16 out1 warp", "bf16 inner1+up", "bf16 out2 warp",
            "bf16 out3 lateral warp"]
        got = {label: fk() for label, (fk, _) in forms.items()}
        assert all(t.dtype == torch.bfloat16 for t in got.values())
        assert all(ab_conv2d._within(got[k], forms[k][1]()) for k in got)
        want = net.forward_folded(x, plain=True, out_layout="warp",
                                  dtype=torch.bfloat16)
    for stage, label in (("stage1", "bf16 out1 warp"),
                         ("stage2", "bf16 out2 warp"),
                         ("stage3", "bf16 out3 lateral warp")):
        assert torch.equal(got[label], want[stage]), stage


def test_ab_depth_tail_cpu(capsys):
    shapes = (("stage1", 48, 6, 8), ("stage2", 32, 12, 16),
              ("stage3", 8, 24, 32))
    res = ab_depth_tail.run(torch.device("cpu"), [ab_depth_tail.ROOT] * 2,
                            rounds=2, shapes=shapes)
    out = capsys.readouterr().out
    labels = ["stage1 D48 6x8", "stage2 D32 12x16", "stage3 D8 24x32"]
    assert list(res["ms"]) == labels
    for label in labels:
        for tree in res["ms"][label]:
            assert len(tree["event"]) == len(tree["host"]) == 2
            assert tree["device"] == [None, None]
            assert all(t > 0 for t in tree["event"] + tree["host"])
        assert all(e == {"depth_max_rel": 0.0, "conf_share_above_tol": 0.0}
                   for e in res["errors"][label])
    assert all(t["device"] is None and t["host"] > 0
               for t in res["per_map"])
    assert out.count("not measured") == 2 * 3 + 2 * 2


def test_ab_warp_fwd_lists_k1_and_k7_calls_cpu(tmp_path):
    from rcmvsnet_tpu_torch.ops import _build
    gen = torch.Generator().manual_seed(0)
    calls, (label, args) = ab_warp_fwd.k1_inputs(
        torch.device("cpu"), gen, dtu=(64, 96, 3), train=(64, 80, 3))
    assert [c[0] for c in calls] == [
        "eval stage1 V3 16x24 C32 D48", "eval stage2 V3 32x48 C16 D32",
        "eval stage3 V3 64x96 C8 D8", "train stage1 V3 16x20 C32 D48",
        "train stage2 V3 32x40 C16 D32", "train stage3 V3 64x80 C8 D8"]
    assert label == "K7 train stage1 V3 16x20 C32 D48"
    f, im, projs, lo, step, nd = args
    assert tuple(im.shape) == (3, 16, 20, 3)
    assert ab_warp_fwd.entry_pointers(_build.CSRC, "warp_volume_f32") == 7
    (tmp_path / "warp_volume.cu").write_text(
        'extern "C" int warp_volume_f32(const float* feats, const float* '
        'imgs,\n    const float* rel, const float* lo, const float* step,\n'
        '    float* var, float* var_nr, float* wimg, int V, int H, int W,\n'
        '    int C, int D, void* stream) {\n')
    assert ab_warp_fwd.entry_pointers(tmp_path, "warp_volume_f32") == 8


# a build from before K7-bf16's own design: the bf16 forward declared in
# warp_volume.cu, warp_volume_bf16.cu holding the backward alone
OLD_K7_BF16 = (
    'extern "C" int warp_volume_bf16(const __nv_bfloat16* feats,\n'
    '    const __nv_bfloat16* imgs, const float* rel, const float* lo,\n'
    '    const float* step, __nv_bfloat16* var, __nv_bfloat16* vol, int V,\n'
    '    int H, int W, int C, int D, void* stream) {\n')
OLD_K7BWD_BF16 = (
    'extern "C" int warp_volume_bwd_bf16(const bf16* feats, const float* '
    'rel) {\n')


def test_ab_warp_fwd_reads_k7_bf16_from_either_source(tmp_path,
                                                      monkeypatch):
    """K7-bf16's C entry is found in warp_volume_bf16.cu (its own design,
    taking the [V, h, w, 4] image copy) or in warp_volume.cu (a build from
    before it, taking the images as they are), and `load_builds` serves a
    build's bf16 entries from warp_volume.cu where its warp_volume_bf16.cu
    lacks them, or where it has no such source."""
    from types import SimpleNamespace

    from rcmvsnet_tpu_torch.ops import _build
    assert ab_warp_fwd.entry_pointers(_build.CSRC, "warp_volume_bf16") == 7
    assert ab_warp_fwd.takes_imgs4(_build.CSRC)
    old, older = tmp_path / "old", tmp_path / "older"
    for d in (old, older):
        d.mkdir()
        (d / "warp_variance.cu").write_text("")
        (d / "warp_volume.cu").write_text(OLD_K7_BF16)
    (old / "warp_volume_bf16.cu").write_text(OLD_K7BWD_BF16)
    assert ab_warp_fwd.entry_pointers(old, "warp_volume_bf16") == 7
    assert not ab_warp_fwd.takes_imgs4(old)
    with pytest.raises(ValueError, match="declares warp_volume_f32"):
        ab_warp_fwd.entry_params(old, "warp_volume_f32")

    def load_from(src, names):
        libs = {"warp_variance": SimpleNamespace(),
                "warp_volume": SimpleNamespace(
                    warp_volume_bf16=f"fwd {src.name}",
                    warp_volume_bwd_bf16=f"old bwd {src.name}",
                    warp_volume_bwd_scratch_bytes="old scratch")}
        if "warp_volume_bf16" in names:
            libs["warp_volume_bf16"] = SimpleNamespace(
                warp_volume_bwd_bf16="own bwd",
                warp_volume_bf16_bwd_scratch_bytes="own scratch")
        assert set(names) == set(libs)
        return libs
    monkeypatch.setattr(_build, "load_from", load_from)
    got = [b["warp_volume_bf16"] for b in ab_warp_fwd.load_builds(
        [old, older])]
    assert vars(got[0]) == {"warp_volume_bf16": "fwd old",
                            "warp_volume_bwd_bf16": "own bwd",
                            "warp_volume_bf16_bwd_scratch_bytes":
                                "own scratch"}
    assert vars(got[1]) == {"warp_volume_bf16": "fwd older",
                            "warp_volume_bwd_bf16": "old bwd older",
                            "warp_volume_bf16_bwd_scratch_bytes":
                                "old scratch"}


def test_ab_warp_view_cpu(capsys):
    from rcmvsnet_tpu_torch.ops import _build
    res = ab_warp_view.run(torch.device("cpu"), [_build.CSRC] * 2,
                           rounds=2, dtu=(64, 96, 3))
    out = capsys.readouterr().out.splitlines()
    labels = ["stage1 view1 16x24 C32 D48", "stage1 view2 16x24 C32 D48",
              "stage2 view1 32x48 C16 D32", "stage2 view2 32x48 C16 D32",
              "stage3 view1 64x96 C8 D8", "stage3 view2 64x96 C8 D8"]
    assert list(res["ms"]) == labels
    for label in labels:
        assert all(len(t) == 2 and min(t) > 0
                   for t in res["turns_ms"][label])
        assert res["errors"][label] == [0.0, 0.0]
        assert res["bit_equal"][label] == [True, True]
    assert list(res["sums"]) == ["stage1", "stage2", "stage3", "total"]
    tot = res["sums"]["total"]
    assert tot["ms"] == [sum(res["ms"][lab][i] for lab in labels)
                         for i in range(2)]
    # per view: the map once, px, py and 32 channels a sample once each
    want = 1e3 * 4 * (16 * 24 * 32 + 48 * 16 * 24 * (2 + 32)) / 3.35e12
    assert res["sums"]["stage1"]["bound_ms"] == pytest.approx(2 * want)
    assert tot["library_ms"] > 0 and tot["fill_ms"] > 0
    assert out[-1].startswith("total ms (least)")


@pytest.mark.parametrize("tool", [profile_breakdown, profile_conv3d,
                                  ab_conv3d, ab_warp_bwd, repeat_warp_bwd,
                                  ab_warp_fwd, ab_conv2d, ab_depth_tail,
                                  ab_warp_view, profile_train, quality])
def test_tools_refuse_missing_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])


def _tiny_train_cell(monkeypatch):
    from rcmvsnet_tpu_torch.config import RenderConfig
    for name, value in (("H", 32), ("W", 32), ("VIEWS", 3), ("NDEPTH", 32)):
        monkeypatch.setattr(profile_train, name, value)
    monkeypatch.setattr(profile_train, "RENDER", RenderConfig(
        n_rays=16, n_samples=8, num_planes=16))
    monkeypatch.setattr(profile_train, "make_timer",
                        partial(make_timer, reps=1, warmup=0))


def test_profile_train_cpu(capsys, monkeypatch, tmp_path):
    _tiny_train_cell(monkeypatch)
    res = profile_train.main(["--device", "cpu", "--trace", str(tmp_path),
                              "--trace_steps", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("device: cpu (host clock; no device metric) | 32x32 "
                      "B=1 V=3 32 planes 48/32/8, 16 rays x 8 samples, 16 "
                      "planes | float32 | remat both levels")
    assert list(res["ms"]) == list(profile_train.KEYS)
    assert all(v > 0 for v in res["ms"].values())
    for key in profile_train.KEYS:
        assert any(line.startswith(f"{key} ") for line in out), key
    assert res["step_peak_bytes"] is None
    assert (tmp_path / "profile" / "trace.json").is_file()
    trace = res["trace"]
    assert trace["train_step_spans"] == 1 and trace["idle_share"] is None
    assert "device time not measured" in "\n".join(out)
    assert json.loads(out[-1])["ms"] == res["ms"]

    seen = []
    monkeypatch.setattr(profile_train, "run",
                        lambda cfg, *a: seen.append(cfg) or {})
    profile_train.main(["--device", "cpu", "--no_remat", "--train_dtype",
                        "bfloat16"])
    assert not seen[0].run.remat
    assert seen[0].backbone.train_dtype == "bfloat16"
    assert capsys.readouterr().out.splitlines()[0].endswith(
        "| bfloat16 | remat none")


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::conv3d_bf16_tc<0, 4, 1, 16, "
     "__nv_bfloat16>(__nv_bfloat16 const*)", "K2 conv3d bf16"),
    ("(anonymous namespace)::prep_weights_bf16(__nv_bfloat16 const*)",
     "K2 conv3d bf16"),
    ("void (anonymous namespace)::conv3d_dw_bf16_tc<0, 14, 1>(CUtensorMap_st)",
     "K8 dw conv3d_dw bf16"),
    ("(anonymous namespace)::sum_chunks_bf16(float const*, float*, int)",
     "K8 dw conv3d_dw bf16"),
    ("(anonymous namespace)::sum_chunks(float const*, float*, int)",
     "K8 dw conv3d_dw"),
    ("void (anonymous namespace)::conv3d_tc<float, 0>(float const*)",
     "K2 conv3d"),
    ("void (anonymous namespace)::warp_variance_bf16_kernel<32, 3>"
     "(__nv_bfloat16 const*, float const*)", "K1 warp_variance bf16"),
    ("void (anonymous namespace)::warp_variance_bwd_bf16_kernel<8, 3, "
     "true>(__nv_bfloat16 const*)", "K6 warp_variance_bwd bf16"),
    ("void (anonymous namespace)::warp_variance_kernel<32, 3, float>"
     "(float const*)", "K1 warp_variance"),
    ("void (anonymous namespace)::warp_variance_bwd_kernel<16, 7, float>"
     "(float const*)", "K6 warp_variance_bwd"),
    ("void (anonymous namespace)::warp_volume_bwd_bf16_kernel<32, 3, true>"
     "(__nv_bfloat16 const*, float const*)", "K7 warp_volume_bwd bf16"),
    ("void (anonymous namespace)::warp_volume_bwd_kernel<32, 3>"
     "(float const*, float const*)", "K7 warp_volume_bwd"),
    ("void (anonymous namespace)::conv2d_bf16_tc<3, 1, 4, 1, 8>"
     "(__nv_bfloat16 const*, unsigned int const*)", "K5 conv2d bf16"),
    ("void (anonymous namespace)::lateral_conv2d_bf16_tc<4>"
     "(__nv_bfloat16 const*)", "K5 conv2d bf16"),
    ("void (anonymous namespace)::conv2d_bf16_direct<3, 1, 8, false>"
     "(__nv_bfloat16 const*)", "K5 conv2d bf16"),
    ("(anonymous namespace)::conv2d_bf16_prep(__nv_bfloat16 const*, "
     "unsigned int*)", "K5 conv2d bf16"),
    ("void (anonymous namespace)::conv2d_tc<3, 1, 4, 1>(float const*)",
     "K5 conv2d"),
    ("void (anonymous namespace)::warp_volume_bf16_kernel<32, 3, true>"
     "(__nv_bfloat16 const*, __nv_bfloat16 const*)", "K7 warp_volume bf16"),
    ("void (anonymous namespace)::warp_volume_kernel<32, 3>(float const*)",
     "K7 warp_volume")])
def test_profile_train_classifies_the_conv_kernels(name, label):
    """The bf16 3-D and 2-D conv kernels and the bf16 warp kernels, which
    have sources and names of their own, count as port kernels K2, K8 dw,
    K5, K1, K6, K7 and K7's backward under their bf16 labels."""
    assert profile_train.classify(name) == label


def test_profile_train_aggregates_a_trace():
    """Two steps of a hand-made trace: the port kernels by their CUDA
    names (a bf16 instance apart), the rest by class, copies by category,
    overlapping kernels counted once in the busy time, the window from
    the first span to the last device event."""
    X = lambda name, ts, dur, cat="kernel": {"ph": "X", "cat": cat,
                                             "name": name, "ts": ts,
                                             "dur": dur}
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {}},
        X("train_step", 0, 1000, "user_annotation"),
        X("train_step", 1000, 1000, "user_annotation"),
        X("aten::conv3d", 10, 50, "cpu_op"),
        X("void warp_variance_kernel<float, 32>(float const*, int)", 100,
          200),
        X("void conv3d_tc<__nv_bfloat16, 1>(__nv_bfloat16 const*)", 250,
          100),
        X("void warp_variance_bwd_kernel<float>(float const*)", 400, 50),
        X("void cudnn::bn_bw_1C11_kernel_new<float, float, float2, 512, "
          "true, 1>(float const*)", 500, 100),
        X("void foo_kernel<int>(int)", 1100, 50),
        X("sm90_xmma_fprop_implicit_gemm_f32f32", 1200, 300),
        X("Memcpy HtoD (Pageable -> Device)", 1600, 100, "gpu_memcpy"),
        X("void at::native::vectorized_elementwise_kernel<4, "
          "at::native::CUDAFunctor_add<float> >(int, float)", 1800, 150),
        X("void at::native::(anonymous namespace)::multi_tensor_apply_"
          "kernel<FusedAdamMathFunctor<float> >(int)", 1950, 100),
    ]
    agg = profile_train.aggregate(events, steps=2, top=3)
    assert agg["device_events"] == 9 and agg["train_step_spans"] == 2
    assert agg["window_ms_per_step"] == pytest.approx(2.05 / 2)
    busy = (250 + 50 + 100 + 50 + 300 + 100 + 250) / 1e3 / 2
    assert agg["busy_ms_per_step"] == pytest.approx(busy)
    assert agg["idle_share"] == pytest.approx(1 - 1100 / 2050)
    assert agg["by_class"] == pytest.approx({
        "K1 warp_variance": 0.1, "K2 conv3d bf16": 0.05,
        "K6 warp_variance_bwd": 0.025, "cuDNN convs, cuBLAS GEMMs": 0.15,
        "copies / fills": 0.05, "elementwise": 0.075,
        "Adam / foreach (multi_tensor_apply)": 0.05,
        "BatchNorm (cuDNN, ATen)": 0.05, "other": 0.025})
    assert agg["port_ms_per_step"] == pytest.approx(0.175)
    assert agg["other_ms_per_step"] == pytest.approx(0.4)
    assert agg["unclassified"] == [{"name": "foo_kernel<int>",
                                    "ms_per_step": pytest.approx(0.025)}]
    assert [r["name"] for r in agg["by_name"]] == [
        "sm90_xmma_fprop_implicit_gemm_f32f32",
        "warp_variance_kernel<float, 32>",
        "at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float> >"]
    assert agg["by_name"][0]["share_of_step"] == pytest.approx(300 / 2050)
    empty = profile_train.aggregate(events[:4], steps=2)
    assert empty["idle_share"] is None and empty["by_class"] == {}
