"""Weight bridge of the PyTorch port (rcmvsnet_tpu_torch/weights.py) against
the JAX package's checkpoint converter (rcmvsnet_tpu/train/convert.py).

The golden backbone (tests/golden/backbone_synth.msgpack) goes JAX tree →
reference-named state_dict → torch.save → convert_cascade_checkpoint and
must come back bit-exact; the committed .npz must equal the bridge's output;
a reference-named state_dict must load into the port strictly. The render
branch likewise: a JAX-initialized RenderingConsistencyNet → the port's
module (strict) → its state_dict → torch.save → convert_render_checkpoint
equals the flax render tree bit-exact."""
from pathlib import Path

import flax.serialization
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.models.render_net import (
    RenderingConsistencyNet as JRenderNet)
from rcmvsnet_tpu.train.convert import (convert_cascade_checkpoint,
                                        convert_render_checkpoint)
from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
from rcmvsnet_tpu_torch.models.render_net import RenderingConsistencyNet
from rcmvsnet_tpu_torch.weights import (ASSET, load_state_dict,
                                        render_state_dict_from_jax,
                                        state_dict_from_jax)

torch.set_num_threads(2)
GOLDEN = Path(__file__).resolve().parent / "golden" / "backbone_synth.msgpack"


@pytest.fixture(scope="module")
def blob():
    return flax.serialization.msgpack_restore(GOLDEN.read_bytes())


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


def test_round_trip_through_reference_converter(blob, tmp_path):
    sd = state_dict_from_jax(blob["params"], blob["batch_stats"])
    path = tmp_path / "model_000000_cas.ckpt"
    torch.save({"model": sd, "epoch": 3}, path)
    params, stats, epoch = convert_cascade_checkpoint(path)
    assert epoch == 3
    _assert_trees_equal(params, blob["params"])
    _assert_trees_equal(stats, blob["batch_stats"])


def test_committed_npz_matches_bridge(blob):
    want = state_dict_from_jax(blob["params"], blob["batch_stats"])
    got = load_state_dict(ASSET)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_reference_named_state_dict_loads_strict(blob, tmp_path):
    sd = state_dict_from_jax(blob["params"], blob["batch_stats"])
    model = CascadeMVSNet()
    model.load_state_dict(sd, strict=True)
    assert torch.equal(model.feature.conv0[0].conv.weight,
                       sd["feature.conv0.0.conv.weight"])
    # a DataParallel-saved reference checkpoint ('module.' prefixes) loads
    path = tmp_path / "dp_cas.ckpt"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    model.load_state_dict(load_state_dict(path), strict=True)
    # and a missing key is an error, not a silent default
    sd.pop("cost_regularization.2.prob.weight")
    with pytest.raises(RuntimeError, match="prob.weight"):
        CascadeMVSNet().load_state_dict(sd, strict=True)


def test_deconv_weights_unflipped(blob):
    """JAX keeps transposed-conv kernels as the spatially flipped forward
    kernel [3,3,3,Ci,Co]; the bridge must hand ConvTranspose3d [Ci,Co,3,3,3]
    with the flip undone."""
    k = blob["params"]["stage1"]["cost_reg"]["conv7"]["kernel"]
    sd = state_dict_from_jax(blob["params"], blob["batch_stats"])
    w = sd["cost_regularization.0.conv7.conv.weight"].numpy()
    assert w.shape == (k.shape[3], k.shape[4], 3, 3, 3)
    np.testing.assert_array_equal(w[:, :, 0, 1, 2],
                                  k[2, 1, 0].astype(np.float32))


def test_render_round_trip_through_reference_converter(tmp_path):
    import jax
    import jax.numpy as jnp
    B, V, H, W = 1, 4, 32, 32
    net = JRenderNet(n_rays=8, n_samples=4, num_planes=8)
    init = jax.jit(lambda *a: net.init(*a, rng=jax.random.PRNGKey(4),
                                       train=False))
    variables = init(
        jax.random.PRNGKey(3), jnp.zeros((B, 8, H // 4, W // 4, 41)),
        jnp.ones((B, H, W)), jnp.zeros((B, V, H, W, 3)),
        jnp.tile(jnp.eye(4), (B, V, 1, 1)), jnp.tile(jnp.eye(4), (B, V, 1, 1)),
        jnp.tile(jnp.eye(3), (B, V, 1, 1)), jnp.ones((B, V, 2)))
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables["batch_stats"])
    # non-trivial running statistics, so that their mapping is checked
    stats = jax.tree_util.tree_map(lambda a: a + 0.25, stats)
    port = RenderingConsistencyNet(41, num_planes=8)
    port.load_state_dict(render_state_dict_from_jax(params, stats),
                         strict=True)
    path = tmp_path / "model_000002_nerf.ckpt"
    torch.save({"model": port.state_dict()}, path)
    got_p, got_s = convert_render_checkpoint(path)
    _assert_trees_equal(got_p, params)
    _assert_trees_equal(got_s, stats)
