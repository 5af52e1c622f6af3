"""`--no_pallas` in the port's CLIs reaches the existing `plain=True`
switch, and only with the flag: the train CLI hands `fit` `plain=True`
with it and `plain=False` without (its call patched, as `test_train_cli_refuses_missing_cuda_and_builds_
dtu_sets` patches it), and the DTU and Tanks & Temples eval CLIs hand
`infer_views_sharded` `plain=True` (patched to record its arguments and
yield nothing, so no view runs)."""
import pytest
import torch

from rcmvsnet_tpu_torch.cli import eval_dtu, eval_tanks
from rcmvsnet_tpu_torch.cli import train as train_cli
from rcmvsnet_tpu_torch.data.synthetic import write_synthetic_scan
from rcmvsnet_tpu_torch.data.synthetic_tanks import write_tanks_scan
from rcmvsnet_tpu_torch.weights import ASSET


@pytest.mark.parametrize("flag,plain", [([], False), (["--no_pallas"], True)])
def test_train_cli_no_pallas_reaches_fit(tmp_path, monkeypatch, flag, plain):
    seen = {}
    monkeypatch.setattr(train_cli, "fit", lambda *a, **kw: seen.update(
        args=a, kw=kw))
    train_cli.main(["--trainpath", "synthetic", "--device", "cpu",
                    "--logdir", str(tmp_path)] + flag)
    assert seen["kw"]["plain"] is plain
    assert seen["args"][3] == torch.device("cpu")


def _recorder(seen):
    def infer(model, samples, device, rank=0, world=1, plain=False):
        seen.append({"n": len(samples), "rank": rank, "world": world,
                     "plain": plain, "device": device})
        return iter(())
    return infer


@pytest.mark.parametrize("no_pallas", [False, True])
def test_eval_dtu_no_pallas_reaches_infer(tmp_path, monkeypatch, no_pallas):
    write_synthetic_scan(tmp_path / "data", H=64, W=96, V=3)
    seen = []
    monkeypatch.setattr(eval_dtu, "infer_views_sharded", _recorder(seen))
    eval_dtu.main(["--testpath", str(tmp_path / "data"), "--testlist",
                   "scan1", "--loadckpt", str(ASSET), "--outdir",
                   str(tmp_path / "out"), "--num_view", "3", "--numdepth",
                   "64", "--max_h", "64", "--max_w", "96", "--no_filter",
                   "--device", "cpu"] + (["--no_pallas"] if no_pallas
                                          else []))
    assert seen == [{"n": 3, "rank": 0, "world": 1, "plain": no_pallas,
                     "device": torch.device("cpu")}]


@pytest.mark.parametrize("no_pallas", [False, True])
def test_eval_tanks_no_pallas_reaches_infer(tmp_path, monkeypatch,
                                            no_pallas):
    from rcmvsnet_tpu_torch.data import tanks
    write_tanks_scan(tmp_path / "data", H=64, W=96, V=3)
    # the scene lists name eight scenes; the written root holds one
    monkeypatch.setattr(tanks, "INTERMEDIATE_SCANS", ["Family"])
    seen = []
    monkeypatch.setattr(eval_tanks, "infer_views_sharded", _recorder(seen))
    eval_tanks.main(["--testpath", str(tmp_path / "data"), "--loadckpt",
                     str(ASSET), "--outdir", str(tmp_path / "out"),
                     "--num_view", "3", "--numdepth", "32", "--img_wh",
                     "96,64", "--no_filter", "--device", "cpu"]
                    + (["--no_pallas"] if no_pallas else []))
    assert len(seen) == 1
    assert (seen[0]["rank"], seen[0]["world"], seen[0]["plain"]) == (
        0, 1, no_pallas)
