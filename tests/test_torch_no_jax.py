"""The PyTorch port imports nothing of JAX and nothing of the JAX package:
every module of rcmvsnet_tpu_torch imports in a fresh interpreter where
`jax`, `flax` and `rcmvsnet_tpu` cannot be imported; `chip_smoke.py` and
`chip_train_probe.py` with the model, op, data and weight modules they
drive import none of them either (the card's host has no jax, flax, cv2,
PIL or msgpack); and the CLIs (eval_dtu, in float32 and in bfloat16,
eval_tanks with rm_color, train) run end to end under the same ban, on the port's own copies of the I/O,
data and fusion modules; the train CLI trains, validates, saves a
checkpoint and resumes from it. The dataset registry resolves every alias
to a class of the port. The data-parallel modules (`parallel/mesh.py`,
`parallel/sync_bn.py`) are among the modules imported, and so are the
rematerialization helper (`nn/remat.py`) and the train-step profiler
(`tools/profile_train.py`), which the card's path runs too. The quality
tool (`tools/quality.py`: a golden's depth maps, fusion and the DTU metric,
chip_smoke.py's phase 16) runs to its JSON line with cv2 and PIL banned as
well: its scene comes from `data/golden_scene.py`'s asset, its sampler is
`fusion/fuse.py`'s numpy copy of cv2.remap."""
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent

_BAN = """
import sys
for name in ("jax", "flax", "rcmvsnet_tpu"):
    sys.modules[name] = None
"""

_ALL_MODULES = _BAN + """
import pkgutil, importlib
import rcmvsnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    rcmvsnet_tpu_torch.__path__, "rcmvsnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for must in ("cli.eval_dtu", "cli.train", "core.io", "data.dtu_test",
             "fusion.fuse", "train.step", "ops.warp_volume",
             "cli.eval_tanks", "cli.rm_color", "data.tanks",
             "data.plane_scene", "data.synthetic_tanks", "ops.warp_view",
             "tools.profile_breakdown", "tools.profile_conv3d",
             "tools.timing", "tools.ab_conv3d", "tools.repeat_warp_bwd",
             "tools.ab_warp_fwd", "tools.ab_conv2d", "tools.ab_depth_tail",
             "tools.ab_warp_view", "data.loader", "data.dtu_train",
             "data.dtu_val", "data.registry", "train.checkpoint",
             "parallel.mesh", "parallel.sync_bn", "nn.remat",
             "tools.profile_train", "tools.quality", "data.golden_scene"):
    assert "rcmvsnet_tpu_torch." + must in names, names
from rcmvsnet_tpu_torch.data.registry import _ALIASES, find_dataset_def
for alias, (module, cls) in _ALIASES.items():
    assert module.startswith("rcmvsnet_tpu_torch.data."), module
    found = find_dataset_def(alias)
    assert found.__module__ == module and found.__name__ == cls, found
assert not any(m.split(".")[0] in ("jax", "flax", "rcmvsnet_tpu")
               and sys.modules[m] for m in sys.modules), "JAX package imported"
print(len(names))
"""

_CHIP_PATH = _BAN + """
import importlib
for name in ("cv2", "PIL", "msgpack"):
    sys.modules[name] = None
import chip_smoke
import chip_train_probe
for name in ("core.geometry", "data.synthetic", "data.transforms",
             "ops.sampling", "ops.warp", "ops._build",
             "ops.warp_variance", "ops.conv3d", "ops.depth_tail",
             "ops.conv2d", "ops.warp_volume", "nn.layers", "nn.featurenet",
             "nn.costreg", "models.cascade", "models.render_net",
             "train.step", "train.state", "weights", "config",
             "data.plane_scene", "ops.warp_view", "tools.profile_breakdown",
             "tools.profile_conv3d", "tools.repeat_warp_bwd",
             "tools.ab_warp_fwd", "tools.ab_conv2d",
             "tools.ab_depth_tail", "tools.ab_warp_view", "cli.train",
             "train.checkpoint",
             "data.loader", "data.dtu_train", "data.dtu_val", "nn.mlp",
             "losses.supervised", "parallel.mesh", "parallel.sync_bn",
             "nn.remat", "tools.profile_train", "tools.quality",
             "data.golden_scene", "data.dtu_test", "fusion.fuse",
             "fusion.dtu_eval", "core.io"):
    importlib.import_module("rcmvsnet_tpu_torch." + name)
print("ok")
"""

_QUALITY = _BAN + """
for name in ("cv2", "PIL", "msgpack"):
    sys.modules[name] = None
import torch
torch.set_num_threads(2)
from rcmvsnet_tpu_torch.tools import quality
quality.main(["--golden", "sup", "--device", "cpu"])
"""

_CLI = _BAN + """
from rcmvsnet_tpu_torch.cli import eval_dtu
from rcmvsnet_tpu_torch.data import synthetic
from rcmvsnet_tpu_torch.weights import ASSET
root = sys.argv[1]
synthetic.write_synthetic_scan(root + "/data", H=64, W=96, V=3)
eval_dtu.main(["--testpath", root + "/data", "--testlist", "scan1",
               "--loadckpt", str(ASSET), "--outdir", root + "/out",
               "--num_view", "3", "--numdepth", "64", "--max_h", "64",
               "--max_w", "96", "--prob_thres", "0.0",
               "--num_consistency", "1", "--num_worker", "1",
               "--device", "cpu", *sys.argv[2:]])
"""

_TANKS_CLI = _BAN + """
from rcmvsnet_tpu_torch.cli import eval_tanks, rm_color
from rcmvsnet_tpu_torch.data import tanks
from rcmvsnet_tpu_torch.data.synthetic_tanks import write_tanks_scan
from rcmvsnet_tpu_torch.weights import ASSET
from pathlib import Path
root = Path(sys.argv[1])
tanks.INTERMEDIATE_SCANS = ["Family"]
eval_tanks.GEO_MASK_THRESHOLD["Family"] = 2
write_tanks_scan(root / "data", H=64, W=96, V=3)
eval_tanks.main(["--testpath", str(root / "data"), "--loadckpt", str(ASSET),
                 "--outdir", str(root / "out"), "--num_view", "3",
                 "--numdepth", "32", "--img_wh", "96,64", "--device", "cpu"])
rm_color.main(["--input_dir", str(root / "out")])
"""

_TRAIN_CLI = _BAN + """
# the logger's TensorBoard mirror (importing TensorFlow, ~10 s) is not
# under test: it falls back to its JSONL records and PNG images
sys.modules["torch.utils.tensorboard"] = None
import torch
torch.set_num_threads(2)
from rcmvsnet_tpu_torch.cli import train
args = ["--trainpath", "synthetic", "--max_steps", "2", "--num_view", "2",
        "--numdepth", "16", "--n_rays", "64", "--n_samples", "16",
        "--device", "cpu", "--logdir", sys.argv[1], "--summary_freq", "1",
        *sys.argv[2:]]
train.main(args + ["--epochs", "1"])
train.main(args + ["--epochs", "2", "--resume"])
"""


def _run(code, *args):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax():
    r = _run(_ALL_MODULES)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 30


def test_chip_path_imports_nothing_of_the_jax_package():
    r = _run(_CHIP_PATH)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_quality_tool_runs_without_cv2():
    """`tools.quality --device cpu` at the supervised golden on a host with
    no cv2, PIL, msgpack or JAX: its JSON line, within the bounds of
    tests/test_e2e_quality.py:42-44."""
    r = _run(_QUALITY)
    assert r.returncode == 0, r.stderr
    metrics = json.loads(r.stdout.strip().splitlines()[-1])
    golden = json.loads((REPO / "tests" / "golden" / "e2e_quality.json")
                        .read_text())
    assert set(metrics) == set(golden)
    assert metrics["n_fused_raw"] > 50_000
    assert metrics["acc_mean"] < 1.0 and metrics["comp_mean"] < 2.0


def test_cli_runs_without_jax(tmp_path):
    """Depth, fusion and the output tree on a host with no jax, flax or JAX
    package: I/O, dataset and fusion are the port's own modules."""
    r = _run(_CLI, str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out" / "mvsnet001_l3.ply").stat().st_size > 0
    assert len(list((tmp_path / "out" / "scan1" / "depth_est").glob(
        "*.pfm"))) == 3


def test_bf16_cli_runs_without_jax(tmp_path):
    """The bf16 eval path (`--eval_dtype bfloat16`) under the same ban:
    depth and fusion through K5, K1 and K2's bf16 plain versions."""
    r = _run(_CLI, str(tmp_path), "--eval_dtype", "bfloat16")
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out" / "mvsnet001_l3.ply").stat().st_size > 0
    assert len(list((tmp_path / "out" / "scan1" / "depth_est").glob(
        "*.pfm"))) == 3


def test_tanks_cli_and_rm_color_run_without_jax(tmp_path):
    """T&T depth, fusion and rm_color under the same ban."""
    r = _run(_TANKS_CLI, str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert len(list((tmp_path / "out" / "Family" / "depth_est").glob(
        "*.pfm"))) == 3
    assert (tmp_path / "out" / "no_color" / "Family.ply").stat().st_size > 0


def test_bf16_train_cli_runs_without_jax(tmp_path):
    """`--train_dtype bfloat16` under the same ban: two epochs, the second
    --resume'd from the first's float32 checkpoints, through the bf16
    plain versions of K1, K6, K7 and K8; finite records."""
    r = _run(_TRAIN_CLI, str(tmp_path), "--train_dtype", "bfloat16")
    assert r.returncode == 0, r.stderr
    assert "resumed at epoch 1" in r.stdout
    recs = [json.loads(line) for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert [rec["mode"] for rec in recs].count("train") == 4
    assert all(v == v and abs(v) != float("inf") for rec in recs
               for v in rec.values() if isinstance(v, float))
    sd = torch.load(tmp_path / "model_000001_cas.ckpt", weights_only=False)
    assert all(v.dtype == torch.float32 for v in sd["model"].values()
               if v.is_floating_point())


def test_train_cli_runs_without_jax(tmp_path):
    """The counterpart of tests/test_e2e_train.py under the same ban: the
    port's train CLI on the synthetic set, one epoch of 2 steps (finite
    train, fulltrain and fulltest records, image summaries, epoch 0's
    reference-format checkpoint pair), then --resume for a second epoch
    (it says where it resumed, continues the step count and writes epoch
    1's pair)."""
    r = _run(_TRAIN_CLI, str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "resumed at epoch 1" in r.stdout
    recs = [json.loads(line) for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert [(rec["mode"], rec["step"]) for rec in recs] == [
        ("train", 1), ("train", 2), ("fulltrain", 2), ("fulltest", 2),
        ("train", 3), ("train", 4), ("fulltrain", 4), ("fulltest", 4)]
    assert all(v == v and abs(v) != float("inf") for rec in recs
               for v in rec.values() if isinstance(v, float))
    assert {"abs_depth_error", "thres2mm_error"} <= set(recs[3])
    for epoch in (0, 1):
        for kind in ("cas", "nerf"):
            assert (tmp_path / f"model_{epoch:06d}_{kind}.ckpt").is_file()
    images = {p.name for p in (tmp_path / "images").iterdir()}
    assert {"train_depth_est_00000001.png", "train_ref_img_00000004.png",
            "train_errormap_00000002.png"} <= images
