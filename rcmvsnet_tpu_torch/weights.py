"""Weight bridge: the JAX package's CascadeMVSNet and render-branch
variables → reference-named torch `state_dict`s.

Inverts `rcmvsnet_tpu/train/convert.py` (`_conv`, `_deconv`, `_convbn`,
`_linear`, `convert_cascade_checkpoint`, `convert_render_checkpoint`):
  Conv{2,3}d         (*k, I, O)              → (O, I, *k)
  ConvTranspose3d    spatially flipped (*k, I, O) → (I, O, *k), unflipped
  TorchBatchNorm     scale/bias + mean/var   → weight/bias +
                                               running_mean/running_var
                                               (+ num_batches_tracked = 0)
  Dense              kernel (I, O)           → Linear weight (O, I)
Takes numpy arrays and imports no JAX, so the golden backbones convert
once and ship as `assets/backbone_synth.npz` (supervised,
tests/golden/backbone_synth.msgpack) and `assets/backbone_synth_unsup.npz`
(trained without ground truth, tests/golden/backbone_synth_unsup.msgpack);
`load_state_dict` reads them back.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

ASSET = Path(__file__).resolve().parent / "assets" / "backbone_synth.npz"
UNSUP_ASSET = ASSET.with_name("backbone_synth_unsup.npz")

FEATURE_BLOCKS = (("conv0.0", "conv0_0"), ("conv0.1", "conv0_1"),
                  ("conv1.0", "conv1_0"), ("conv1.1", "conv1_1"),
                  ("conv1.2", "conv1_2"), ("conv2.0", "conv2_0"),
                  ("conv2.1", "conv2_1"), ("conv2.2", "conv2_2"))
FEATURE_HEADS = ("out1", "out2", "out3", "inner1", "inner2")
COSTREG_CONVS = ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5",
                 "conv6")
COSTREG_DECONVS = ("conv7", "conv9", "conv11")


def unconv(k) -> np.ndarray:
    """(*k, I, O) → (O, I, *k)."""
    k = np.asarray(k)
    n = k.ndim - 2
    return np.ascontiguousarray(np.transpose(k, (n + 1, n) + tuple(range(n))))


def undeconv(k) -> np.ndarray:
    """Flipped forward-conv (kd, kh, kw, I, O) → ConvTranspose (I, O, kd,
    kh, kw)."""
    k = np.transpose(np.asarray(k), (3, 4, 0, 1, 2))
    return np.ascontiguousarray(k[:, :, ::-1, ::-1, ::-1])


def _bn(sd, prefix, params, stats):
    """BN of a block under `prefix` (e.g. "conv0.bn" or "conv7.1")."""
    bn_p = params["TorchBatchNorm_0"]
    bn_s = stats["TorchBatchNorm_0"]
    sd[f"{prefix}.weight"] = bn_p["scale"]
    sd[f"{prefix}.bias"] = bn_p["bias"]
    sd[f"{prefix}.running_mean"] = bn_s["mean"]
    sd[f"{prefix}.running_var"] = bn_s["var"]
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _tensors(sd) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def state_dict_from_jax(params, batch_stats) -> dict[str, torch.Tensor]:
    """JAX CascadeMVSNet variables (nested dicts of arrays) → reference-
    named tensors for `CascadeMVSNet.load_state_dict(strict=True)`."""
    sd: dict[str, np.ndarray] = {}
    fp, fs = params["feature"], batch_stats["feature"]
    for torch_name, our_name in FEATURE_BLOCKS:
        prefix = f"feature.{torch_name}"
        sd[f"{prefix}.conv.weight"] = unconv(fp[our_name]["Conv_0"]["kernel"])
        _bn(sd, f"{prefix}.bn", fp[our_name], fs[our_name])
    for head in FEATURE_HEADS:
        entry = fp[head]["Conv_0"]
        sd[f"feature.{head}.weight"] = unconv(entry["kernel"])
        if "bias" in entry:
            sd[f"feature.{head}.bias"] = np.asarray(entry["bias"])
    i = 0
    while f"stage{i + 1}" in params:
        _costreg(sd, f"cost_regularization.{i}",
                 params[f"stage{i + 1}"]["cost_reg"],
                 batch_stats[f"stage{i + 1}"]["cost_reg"])
        i += 1
    return _tensors(sd)


def _costreg(sd, prefix, cp, cs, deconv_seq: bool = False):
    """One U-Net's blocks under `prefix`. deconv_seq: conv7/9/11 as the
    render branch's nn.Sequential (`.0` conv, `.1` BN)."""
    for name in COSTREG_CONVS:
        sd[f"{prefix}.{name}.conv.weight"] = unconv(
            cp[name]["Conv_0"]["kernel"])
        _bn(sd, f"{prefix}.{name}.bn", cp[name], cs[name])
    conv, bn = ("0", "1") if deconv_seq else ("conv", "bn")
    for name in COSTREG_DECONVS:
        sd[f"{prefix}.{name}.{conv}.weight"] = undeconv(cp[name]["kernel"])
        _bn(sd, f"{prefix}.{name}.{bn}", cp[name], cs[name])
    if "prob" in cp:
        sd[f"{prefix}.prob.weight"] = unconv(cp["prob"]["Conv_0"]["kernel"])


def costreg_state_dict_from_jax(params, batch_stats,
                                render: bool = False) -> dict[str,
                                                              torch.Tensor]:
    """One JAX CostRegNet (or, with render, RenderCostReg) → the port
    module's own state_dict."""
    sd: dict[str, np.ndarray] = {}
    _costreg(sd, "u", params, batch_stats, deconv_seq=render)
    return _tensors({k[2:]: v for k, v in sd.items()})


def render_state_dict_from_jax(params, batch_stats) -> dict[str,
                                                              torch.Tensor]:
    """JAX RenderingConsistencyNet variables (any net_type) → the
    reference's `*_nerf.ckpt` names, for
    `RenderingConsistencyNet.load_state_dict(strict=True)`:
    `MVSNet.cost_reg_2.*` (conv7/9/11 as `.0` ConvTranspose3d + `.1` BN)
    and `network_fn.nerf.*`."""
    sd: dict[str, np.ndarray] = {}
    _costreg(sd, "MVSNet.cost_reg_2", params["neural_volume"]["cost_reg_2"],
             batch_stats["neural_volume"]["cost_reg_2"], deconv_seq=True)
    _nerf(sd, "network_fn.nerf", params["nerf"])
    return _tensors(sd)


def _linear(sd, name, entry):
    sd[f"{name}.weight"] = np.ascontiguousarray(
        np.asarray(entry["kernel"]).T)
    if "bias" in entry:
        sd[f"{name}.bias"] = np.asarray(entry["bias"])


def _nerf(sd, prefix, nerf, depth: int = 6):
    """A JAX NerfMLP (v0, v2) or AttentionNerfMLP (v1; its shared trunk
    layer `pts_linear_shared` under each of `pts_linears.1..depth−1`, as
    the reference's list-replicated trunk names it)."""
    if "pts_linear_shared" in nerf:
        dense = [("pts_linears.0", "pts_linear_0")]
        dense += [(f"pts_linears.{i}", "pts_linear_shared")
                  for i in range(1, depth)]
        dense += [("weight_out", "weight_out")]
        att = nerf["color_attention"]
        for proj in ("w_qs", "w_ks", "w_vs", "fc"):
            _linear(sd, f"{prefix}.color_attention.{proj}", att[proj])
        ln = att["layer_norm"]
        sd[f"{prefix}.color_attention.layer_norm.weight"] = np.asarray(
            ln["scale"])
        sd[f"{prefix}.color_attention.layer_norm.bias"] = np.asarray(
            ln["bias"])
    else:
        dense = [(f"pts_linears.{i}", f"pts_linear_{i}")
                 for i in range(sum(k.startswith("pts_linear_")
                                    for k in nerf))]
    dense += [("pts_bias", "pts_bias"), ("views_linears.0", "views_linear_0"),
              ("feature_linear", "feature_linear"),
              ("alpha_linear", "alpha_linear"), ("rgb_linear", "rgb_linear")]
    for torch_name, our_name in dense:
        _linear(sd, f"{prefix}.{torch_name}", nerf[our_name]["Dense_0"])


def nerf_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """A JAX NerfMLP (v0, v2) or AttentionNerfMLP (v1) → the port's
    NerfMLP / AttentionNerfMLP state_dict."""
    sd: dict[str, np.ndarray] = {}
    _nerf(sd, "m", params)
    return _tensors({k[2:]: v for k, v in sd.items()})


def load_state_dict(path) -> dict[str, torch.Tensor]:
    """A port `.npz` (reference names → arrays), or a reference
    `*_cas.ckpt` ({'model': state_dict}, `module.` prefixes stripped)."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k].copy()) for k in z.files}
    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("model", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}
