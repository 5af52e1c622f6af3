"""The PyTorch port imports no JAX: every module of rcmvsnet_tpu_torch
imports in a fresh interpreter where `jax` and `flax` cannot be imported;
and `chip_smoke.py` with the model, op and weight modules it drives import
nothing of the JAX package at all (the card's host has no jax, flax, cv2,
PIL or msgpack); and the CLI runs end to end with jax and flax absent."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_ALL_MODULES = """
import sys, pkgutil, importlib
sys.modules["jax"] = None
sys.modules["flax"] = None
import rcmvsnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    rcmvsnet_tpu_torch.__path__, "rcmvsnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "rcmvsnet_tpu_torch.cli.eval_dtu" in names, names
assert not any(m.split(".")[0] in ("jax", "flax") and sys.modules[m]
               for m in sys.modules), "jax imported"
print(len(names))
"""

_CHIP_PATH = """
import sys, importlib
for name in ("jax", "flax", "rcmvsnet_tpu", "cv2", "PIL", "msgpack"):
    sys.modules[name] = None
import chip_smoke
for name in ("core.geometry", "ops.sampling", "ops.warp", "ops._build",
             "ops.warp_variance", "ops.conv3d", "ops.depth_tail",
             "ops.conv2d", "nn.layers", "nn.featurenet", "nn.costreg",
             "models.cascade", "weights", "config"):
    importlib.import_module("rcmvsnet_tpu_torch." + name)
print("ok")
"""


_CLI = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
from rcmvsnet_tpu_torch.cli import eval_dtu
from rcmvsnet_tpu_torch.shared import import_shared
from rcmvsnet_tpu_torch.weights import ASSET
synthetic = import_shared("rcmvsnet_tpu.data.synthetic")
root = sys.argv[1]
synthetic.write_synthetic_scan(root + "/data", H=64, W=96, V=3)
eval_dtu.main(["--testpath", root + "/data", "--testlist", "scan1",
               "--loadckpt", str(ASSET), "--outdir", root + "/out",
               "--num_view", "3", "--numdepth", "64", "--max_h", "64",
               "--max_w", "96", "--prob_thres", "0.0",
               "--num_consistency", "1", "--num_worker", "1",
               "--device", "cpu"])
"""


def _run(code, *args):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax():
    r = _run(_ALL_MODULES)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 15


def test_chip_path_imports_nothing_of_the_jax_package():
    r = _run(_CHIP_PATH)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_cli_runs_without_jax(tmp_path):
    """Depth, fusion and the output tree on a host with no jax/flax: the
    shared I/O and dataset modules load through rcmvsnet_tpu_torch.shared."""
    r = _run(_CLI, str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out" / "mvsnet001_l3.ply").stat().st_size > 0
    assert len(list((tmp_path / "out" / "scan1" / "depth_est").glob(
        "*.pfm"))) == 3
