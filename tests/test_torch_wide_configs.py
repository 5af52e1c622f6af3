"""Configurations the JAX package runs whose widths the port's K4 and K8 dw
kernels once refused (more than 64 depth planes in a stage; more than 64
output channels in a CostRegNet conv), on the CPU:
  * the JAX package's `fused_depth_tail` (interpret mode, as its own tests
    run it) at D = 96 and 192 against the port's `depth_tail_plain`, which
    the K4 wrapper returns on a CPU tensor and `chip_smoke.py` holds the
    kernel to: depth within 1e-5 relative, confidence beyond 1e-4 on at
    most 1e-3 of the pixels;
  * the eval cascade at `--ndepths 96,32,8` (the golden backbone, 64×96,
    V=3) against the JAX cascade at the same config, with
    `test_torch_cascade`'s gates (depth 1e-4 relative per stage,
    confidence within 1e-4 on 99.9 % of pixels);
  * `make_train_step` at `--cr_base_chs 16,16,16` (conv5 and conv6 of
    each CostRegNet 128 channels wide): one step at 64×64, V=3, finite
    losses and a gradient for every parameter.
The kernels themselves at these widths run on the card
(`tests/test_torch_kernels_gpu.py`, marker `gpu`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmvsnet_tpu_torch.config import BackboneConfig, Config, RenderConfig
from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
from rcmvsnet_tpu_torch.ops.depth_tail import MAX_DEPTH, depth_tail_plain
from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict

torch.set_num_threads(2)


@pytest.mark.parametrize("D", [96, 192])
def test_jax_fused_depth_tail_matches_plain_past_64_planes(D):
    from rcmvsnet_tpu.ops.pallas_tail import fused_depth_tail
    assert D > MAX_DEPTH
    rng = np.random.default_rng(D)
    h, w = 12, 20
    cost = (3 * rng.standard_normal((D, h, w))).astype(np.float32)
    lo = (425 + 500 * rng.random((h, w))).astype(np.float32)
    step = (2.5 + rng.random((h, w))).astype(np.float32)
    dj, cj = fused_depth_tail(jnp.asarray(cost)[None],
                              (jnp.asarray(lo)[None], jnp.asarray(step)[None]),
                              interpret=True)
    T = torch.from_numpy
    dp, cp = (t.numpy() for t in depth_tail_plain(T(cost), T(lo), T(step)))
    dj, cj = np.asarray(dj)[0], np.asarray(cj)[0]
    assert np.max(np.abs(dp - dj) / np.abs(dj)) <= 1e-5
    assert np.mean(np.abs(cp - cj) > 1e-4) <= 1e-3


def test_eval_cascade_at_96_planes_matches_jax():
    import flax.serialization

    from rcmvsnet_tpu.config import BackboneConfig as JBackboneConfig
    from rcmvsnet_tpu.config import Config as JConfig
    from rcmvsnet_tpu.train.state import make_models
    from test_torch_cascade import GOLDEN_CKPT, _sample
    nd = (96, 32, 8)
    s = _sample()
    blob = flax.serialization.msgpack_restore(GOLDEN_CKPT.read_bytes())
    cascade, _ = make_models(JConfig(backbone=JBackboneConfig(ndepths=nd)))
    want = cascade.apply(
        {"params": blob["params"], "batch_stats": blob["batch_stats"]},
        jnp.asarray(s["imgs"])[None],
        {k: jnp.asarray(v)[None] for k, v in s["proj_matrices"].items()},
        jnp.asarray(s["depth_values"])[None], train=False)
    model = CascadeMVSNet(BackboneConfig(ndepths=nd))
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    T = lambda a: torch.from_numpy(a)[None]
    with torch.no_grad():
        got = model.eval()(T(s["imgs"]),
                           {k: T(v) for k, v in s["proj_matrices"].items()},
                           T(s["depth_values"]))
    for stage in ("stage1", "stage2", "stage3"):
        dj = np.asarray(want[stage]["depth"])
        dt = got[stage]["depth"].numpy()
        assert dt.shape == dj.shape
        assert np.all(np.isfinite(dt))
        assert np.max(np.abs(dt - dj) / np.abs(dj)) <= 1e-4, stage
        cj = np.asarray(want[stage]["photometric_confidence"])
        ct = got[stage]["photometric_confidence"].numpy()
        assert np.mean(np.abs(ct - cj) <= 1e-4) >= 0.999, stage


def test_train_step_at_128_channel_unets_runs():
    from rcmvsnet_tpu_torch.data.synthetic import make_synthetic_batch
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import (batch_to, draw_step,
                                               make_train_step)
    cfg = Config(backbone=BackboneConfig(cr_base_chs=(16, 16, 16)),
                 render=RenderConfig(n_rays=16, n_samples=8, num_planes=16))
    state = create_train_state(cfg, 3, 10, "cpu", seed=0)
    for net in state.cascade.cost_regularization:
        assert net.conv6.conv.weight.shape[:2] == (128, 128)
    batch = make_synthetic_batch(B=1, V=3, H=64, W=64, ndepth=64, seed=1)
    metrics = make_train_step(cfg)(
        state, batch_to(batch, "cpu"),
        draw_step(torch.Generator().manual_seed(0), cfg, 1, 64, 64))
    assert all(np.isfinite(float(metrics[k])) for k in (
        "loss", "repr_loss", "aug_loss", "img_loss", "ray_depth_loss"))
    for name, p in state.cascade.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
