"""The port's supervised validation step (`train/step.make_val_step`)
against the JAX package's, on the CPU: the golden backbone through the
weight bridge, one batch of a synthetic plane scene at 64×96, V=3, 192
planes, 48/32/8, with raw [0, 1] images as the val loader gives them and a
mask that leaves out part of each stage.

Tolerances: loss, depth_loss and abs_depth_error relative 1e-4 (the eval
depth agrees to 1e-4, tests/test_torch_cascade.py); the thres* shares
absolute 1e-3 (a pixel whose error sits on a threshold may flip). The step
leaves the models' BN buffers and train / eval flags as it found them."""
from pathlib import Path
from types import SimpleNamespace

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.config import Config as JConfig
from rcmvsnet_tpu.data.synthetic import make_synthetic_views
from rcmvsnet_tpu.train.state import TrainState as JTrainState
from rcmvsnet_tpu.train.step import make_val_step as jmake_val_step
from rcmvsnet_tpu_torch.config import Config
from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
from rcmvsnet_tpu_torch.train.step import batch_to, make_val_step
from rcmvsnet_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(2)
GOLDEN = Path(__file__).resolve().parent / "golden" / "backbone_synth.msgpack"


def _val_batch(H=64, W=96, V=3, ndepth=192, seed=5):
    s = make_synthetic_views(H=H, W=W, V=V, seed=seed, baseline=8.0)
    proj = np.zeros((V, 2, 4, 4), np.float32)
    for v in range(V):
        proj[v, 0] = s["extrinsics"][v]
        proj[v, 1, :3, :3] = s["intrinsics"]
        proj[v, 1, :2] /= 4.0
    pm = {"stage1": proj, "stage2": proj.copy(), "stage3": proj.copy()}
    pm["stage2"][:, 1, :2] *= 2
    pm["stage3"][:, 1, :2] *= 4
    rs = np.random.RandomState(seed)
    depth, mask = {}, {}
    for i, sc in enumerate((4, 2, 1)):
        d = s["depths"][0][::sc, ::sc]
        # the gt a little off the plane, so the metrics are not all 0
        depth[f"stage{i + 1}"] = d + rs.randn(*d.shape).astype(np.float32) * 3
        m = np.ones_like(d)
        m[:, : d.shape[1] // 4] = 0
        mask[f"stage{i + 1}"] = m
    batch = {"imgs": s["images"], "proj_matrices": pm,
             "depth_values": np.linspace(s["depth_min"], s["depth_max"],
                                         ndepth, dtype=np.float32),
             "depth": depth, "mask": mask}
    add_b = lambda v: ({k: x[None] for k, x in v.items()}
                       if isinstance(v, dict) else v[None])
    return {k: add_b(v) for k, v in batch.items()}


def test_val_step_matches_jax():
    blob = flax.serialization.msgpack_restore(GOLDEN.read_bytes())
    batch = _val_batch()
    jstate = JTrainState(step=0, params={"cascade": blob["params"]},
                         batch_stats={"cascade": blob["batch_stats"]},
                         opt_state=None)
    want = {k: float(v) for k, v in
            jax.jit(jmake_val_step(JConfig()))(jstate, batch).items()}

    cascade = CascadeMVSNet()
    cascade.load_state_dict(state_dict_from_jax(blob["params"],
                                                blob["batch_stats"]),
                            strict=True)
    cascade.train()
    cascade.feature.eval()              # a mixed state is left as it was
    modes = {n: m.training for n, m in cascade.named_modules()}
    buffers = {n: b.clone() for n, b in cascade.named_buffers()}
    state = SimpleNamespace(cascade=cascade)
    got = make_val_step(Config())(state, batch_to(batch, "cpu"))
    got = {k: float(v) for k, v in got.items()}

    assert set(got) == set(want)
    for k in ("loss", "depth_loss", "abs_depth_error"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k in ("thres2mm_error", "thres4mm_error", "thres8mm_error"):
        assert got[k] == pytest.approx(want[k], abs=1e-3), k
    assert 0 < want["thres2mm_error"] < 1 and want["depth_loss"] > 0
    assert {n: m.training for n, m in cascade.named_modules()} == modes
    for n, b in cascade.named_buffers():
        assert torch.equal(b, buffers[n]), n
    assert all(p.grad is None for p in cascade.parameters())
