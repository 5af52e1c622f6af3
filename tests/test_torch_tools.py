"""The port's profiling entry points (rcmvsnet_tpu_torch.tools) on the
CPU, through the plain versions, at a tiny shape (the module's shape
constants patched): each prints its host-clock lines under a CPU label,
times every component it names, and refuses a CUDA device that is
absent (as do the kernel A/B tools, which run on the card only). The
warp-backward repeat tool reports every call's two runs, which the plain
versions give equal. The K5 A/B tool imports a tree's package under an
alias and lists FeatureNet's 13 calls and the eval path's forms of them,
each of which equals its plain version. The K4 A/B tool runs its turns
on the CPU through the plain version, with the device time "not
measured"; the forward-warp A/B tool lists K1's six calls and K7's, and
reads each build's K7 interface from its source. The K10 A/B tool runs
its turns on the CPU through the plain version at a tiny DTU shape, with
each stage's and the total's times beside the bound, F.grid_sample's and
a fill of the output."""
import json
from functools import partial

import pytest
import torch

from rcmvsnet_tpu_torch.tools import (ab_conv2d, ab_conv3d, ab_depth_tail,
                                      ab_warp_bwd, ab_warp_fwd,
                                      ab_warp_view, profile_breakdown,
                                      profile_conv3d, repeat_warp_bwd)
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
    assert [r["call"] for r in rows] == [
        "warp_variance_bwd stage1 V3 16x20 C32 D48",
        "warp_volume_bwd stage1 V3 16x20 C32 D48",
        "warp_variance_bwd stage2 V3 32x40 C16 D32",
        "warp_variance_bwd stage3 V3 64x80 C8 D8"]
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
                                  ab_warp_view])
def test_tools_refuse_missing_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])
