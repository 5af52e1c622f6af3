"""The port's profiling entry points (rcmvsnet_tpu_torch.tools) on the
CPU, through the plain versions, at a tiny shape (the module's shape
constants patched): each prints its host-clock lines under a CPU label,
times every component it names, and refuses a CUDA device that is
absent (as do the kernel A/B tools, which run on the card only). The
warp-backward repeat tool reports every call's two runs, which the plain
versions give equal."""
import json
from functools import partial

import pytest
import torch

from rcmvsnet_tpu_torch.tools import (ab_conv3d, ab_warp_bwd,
                                      profile_breakdown, profile_conv3d,
                                      repeat_warp_bwd)
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


@pytest.mark.parametrize("tool", [profile_breakdown, profile_conv3d,
                                  ab_conv3d, ab_warp_bwd, repeat_warp_bwd])
def test_tools_refuse_missing_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])
