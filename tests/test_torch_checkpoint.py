"""The port's checkpoints (`train/checkpoint.py`) in the reference's torch
format, on the CPU:
  * save then restore into a fresh state: every model and optimizer tensor
    equal (`torch.equal`), the step and the next epoch restored;
  * `latest_epoch` picks the newest `*_cas.ckpt`;
  * the JAX package's `convert_cascade_checkpoint` /
    `convert_render_checkpoint` read the port's files back into exactly
    the JAX variables the port's weights came from (the golden backbone,
    the JAX init of the render branch, v0 and v1): the files are the
    reference's format;
  * `weights.load_state_dict` reads a `*_cas.ckpt` into a fresh
    CascadeMVSNet with `strict=True`."""
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.data.synthetic import make_synthetic_batch
from rcmvsnet_tpu.models.render_net import (
    RenderingConsistencyNet as JRenderNet)
from rcmvsnet_tpu.train.convert import (convert_cascade_checkpoint,
                                        convert_render_checkpoint)
from rcmvsnet_tpu_torch.config import Config, RenderConfig
from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
from rcmvsnet_tpu_torch.train.checkpoint import (checkpoint_paths,
                                                 latest_epoch,
                                                 restore_checkpoint,
                                                 save_checkpoint)
from rcmvsnet_tpu_torch.train.state import create_train_state
from rcmvsnet_tpu_torch.weights import (load_state_dict,
                                        render_state_dict_from_jax,
                                        state_dict_from_jax)

torch.set_num_threads(2)
GOLDEN = Path(__file__).resolve().parent / "golden" / "backbone_synth.msgpack"
V = 3


def _jax_render(net_type):
    batch = make_synthetic_batch(B=1, V=V, H=32, W=32, ndepth=64, seed=2)
    net = JRenderNet(n_rays=16, n_samples=8, num_planes=16,
                     net_type=net_type)
    vf = np.zeros((1, 48, 8, 8, 3 * (V - 1) + 32), np.float32)
    cams = [jnp.asarray(batch[k]) for k in ("w2cs", "c2ws", "intrinsics",
                                            "near_fars")]
    return jax.jit(lambda *a: net.init(*a, rng=jax.random.PRNGKey(5),
                                       train=False))(
        jax.random.PRNGKey(4), jnp.asarray(vf),
        jnp.asarray(batch["depth"]["stage3"]), jnp.asarray(batch["imgs"]),
        *cams)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(
            got[k], want[k]), k


def _state(net_type, seed, state_dicts=None):
    cfg = Config(render=RenderConfig(n_rays=16, n_samples=8, num_planes=16,
                                     net_type=net_type))
    return create_train_state(cfg, V, 10, "cpu", seed=seed,
                              state_dicts=state_dicts)


def _all_tensors(state):
    out = {f"c.{k}": v for k, v in state.cascade.state_dict().items()}
    out.update({f"r.{k}": v for k, v in state.render.state_dict().items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"o.{i}.{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("net_type", ["v0", "v1"])
def test_files_are_the_reference_format(tmp_path, net_type):
    blob = flax.serialization.msgpack_restore(GOLDEN.read_bytes())
    rnd = _jax_render(net_type)
    state = _state(net_type, 0, (
        state_dict_from_jax(blob["params"], blob["batch_stats"]),
        render_state_dict_from_jax(rnd["params"], rnd["batch_stats"])))
    save_checkpoint(tmp_path, state, 3)
    cas, nerf = checkpoint_paths(tmp_path, 3)
    assert (cas.name, nerf.name) == ("model_000003_cas.ckpt",
                                     "model_000003_nerf.ckpt")
    params, stats, epoch = convert_cascade_checkpoint(str(cas))
    assert epoch == 3
    _assert_same_tree(params, blob["params"])
    _assert_same_tree(stats, blob["batch_stats"])
    r_params, r_stats = convert_render_checkpoint(str(nerf))
    _assert_same_tree(r_params, rnd["params"])
    _assert_same_tree(r_stats, rnd["batch_stats"])

    model = CascadeMVSNet()
    model.load_state_dict(load_state_dict(cas), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.cascade.state_dict()[k]), k


def test_save_restore_latest(tmp_path):
    state = _state("v1", 0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):                  # Adam state, moved parameters
        for p in list(state.cascade.parameters()) + list(
                state.render.parameters()):
            p.grad = torch.randn(p.shape, generator=gen)
        state.optimizer.step()
    state.step = 7
    save_checkpoint(tmp_path, state, 4)

    fresh = _state("v1", 1)
    assert not torch.equal(fresh.render.network_fn["nerf"].pts_linears[1]
                           .weight, state.render.network_fn["nerf"]
                           .pts_linears[1].weight)
    fresh, start = restore_checkpoint(tmp_path, fresh)
    assert start == 5 and fresh.step == 7
    want, got = _all_tensors(state), _all_tensors(fresh)
    assert set(want) == set(got) and any(k.startswith("o.") for k in want)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert fresh.optimizer.state_dict()["param_groups"] == \
        state.optimizer.state_dict()["param_groups"]

    assert latest_epoch(tmp_path) == 4
    for name in ("model_000012_cas.ckpt", "model_000030_nerf.ckpt",
                 "model_000031_cas.ckpt.tmp"):
        (tmp_path / name).touch()
    assert latest_epoch(tmp_path) == 12
    assert latest_epoch(tmp_path / "missing") is None
    empty = _state("v0", 2)
    assert restore_checkpoint(tmp_path / "missing", empty) == (empty, 0)
