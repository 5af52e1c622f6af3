"""The render MLP variants of the port against the JAX package's, on the
CPU, with weights from the JAX init through the extended weight bridge
(`weights.nerf_state_dict_from_jax`): `MultiHeadAttention`, the v1
`AttentionNerfMLP` and the v2 additive `NerfMLP`, each within 1e-5 of the
largest value of its output; and the reference's v1 naming, whose trunk
layers 1..5 are one shared `nn.Linear` (`pts_linears.1..5` in a state_dict
name one tensor), loading with `strict=True`. The whole render branch of
each variant is held in tests/test_torch_train_ops.py."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.nn import mlp as jmlp
from rcmvsnet_tpu_torch.models.render_net import RenderingConsistencyNet
from rcmvsnet_tpu_torch.nn import mlp as tmlp
from rcmvsnet_tpu_torch.weights import nerf_state_dict_from_jax

torch.set_num_threads(2)
T = lambda a: torch.from_numpy(np.array(a))


def _close(got, want):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def _inputs(seed=0, F=20):
    rs = np.random.RandomState(seed)
    x = rs.rand(6, 5, 3).astype(np.float32) * 2 - 1
    feats = rs.rand(6, 5, F).astype(np.float32)
    views = rs.randn(6, 5, 3).astype(np.float32)
    return x, feats, views


def test_multi_head_attention_matches_jax():
    rs = np.random.RandomState(1)
    tokens = rs.randn(7, 4, 3, 12).astype(np.float32)
    att = jmlp.MultiHeadAttention()
    params = att.init(jax.random.PRNGKey(2), *[jnp.asarray(tokens)] * 3)
    out_j, attn_j = att.apply(params, *[jnp.asarray(tokens)] * 3)
    p = params["params"]
    port = tmlp.MultiHeadAttention(12)
    sd = {f"{k}.weight": T(p[k]["kernel"]).T.contiguous()
          for k in ("w_qs", "w_ks", "w_vs", "fc")}
    sd["layer_norm.weight"] = T(p["layer_norm"]["scale"])
    sd["layer_norm.bias"] = T(p["layer_norm"]["bias"])
    port.load_state_dict(sd, strict=True)
    out_t, attn_t = port(*[T(tokens)] * 3)
    _close(out_t, out_j)
    _close(attn_t, attn_j)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_mlp_variant_matches_jax(variant):
    x, feats, views = _inputs()
    enc = jmlp.positional_encoding(jnp.asarray(x), 10)
    if variant == "v1":
        mlp = jmlp.AttentionNerfMLP(6, 32, in_ch_pts=63)
        net = tmlp.AttentionNerfMLP(6, 32, in_ch_pts=63, in_ch_feat=20)
    else:
        mlp = jmlp.NerfMLP(6, 32, in_ch_pts=63, bias_mode="add")
        net = tmlp.NerfMLP(6, 32, in_ch_pts=63, in_ch_feat=20,
                           bias_mode="add")
    args = (enc, jnp.asarray(feats), jnp.asarray(views))
    params = mlp.init(jax.random.PRNGKey(3), *args)["params"]
    want = mlp.apply({"params": params}, *args)
    net.load_state_dict(nerf_state_dict_from_jax(params), strict=True)
    got = net(tmlp.positional_encoding(T(x), 10), T(feats), T(views))
    assert got.shape == want.shape == (6, 5, 10 if variant == "v1" else 4)
    _close(got, want)
    if variant == "v1":                # the color prior, twice
        torch.testing.assert_close(got[..., 4:7], got[..., 7:])


def test_v1_reference_state_dict_shares_the_trunk():
    net = RenderingConsistencyNet(38, num_planes=16, net_type="v1")
    nerf = net.network_fn["nerf"]
    sd = net.state_dict()
    keys = [f"network_fn.nerf.pts_linears.{i}.weight" for i in range(6)]
    assert all(k in sd for k in keys)
    assert len({sd[k].data_ptr() for k in keys[1:]}) == 1
    assert sd[keys[0]].data_ptr() != sd[keys[1]].data_ptr()
    assert sum(p is nerf.pts_linears[1].weight
               for p in net.parameters()) == 1
    for name in ("color_attention.w_qs.weight", "color_attention.fc.weight",
                 "color_attention.layer_norm.bias", "weight_out.bias"):
        assert f"network_fn.nerf.{name}" in sd

    # a reference-named state_dict (each key its own tensor, as a file
    # written by the reference holds them) loads strictly, through a file
    ref = {k: v.clone() + 1.0 for k, v in sd.items()}
    buf = io.BytesIO()
    torch.save({"model": ref}, buf)
    buf.seek(0)
    fresh = RenderingConsistencyNet(38, num_planes=16, net_type="v1")
    fresh.load_state_dict(torch.load(buf)["model"], strict=True)
    trunk = fresh.network_fn["nerf"].pts_linears
    assert all(trunk[i] is trunk[1] for i in range(2, 6))
    torch.testing.assert_close(trunk[5].weight, ref[keys[5]])
