"""Weight bridge: the JAX package's CascadeMVSNet variables → a reference-
named torch `state_dict`.

Inverts `rcmvsnet_tpu/train/convert.py:21-121` (`_conv`, `_deconv`,
`_convbn`, `convert_cascade_checkpoint`):
  Conv{2,3}d         (*k, I, O)              → (O, I, *k)
  ConvTranspose3d    spatially flipped (*k, I, O) → (I, O, *k), unflipped
  TorchBatchNorm     scale/bias + mean/var   → weight/bias +
                                               running_mean/running_var
                                               (+ num_batches_tracked = 0)
Takes numpy arrays and imports no JAX, so the golden backbone converts
once and ships as `assets/backbone_synth.npz` (`load_state_dict` reads it
back).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

ASSET = Path(__file__).resolve().parent / "assets" / "backbone_synth.npz"

FEATURE_BLOCKS = (("conv0.0", "conv0_0"), ("conv0.1", "conv0_1"),
                  ("conv1.0", "conv1_0"), ("conv1.1", "conv1_1"),
                  ("conv1.2", "conv1_2"), ("conv2.0", "conv2_0"),
                  ("conv2.1", "conv2_1"), ("conv2.2", "conv2_2"))
FEATURE_HEADS = ("out1", "out2", "out3", "inner1", "inner2")
COSTREG_CONVS = ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5",
                 "conv6")
COSTREG_DECONVS = ("conv7", "conv9", "conv11")


def _unconv(k) -> np.ndarray:
    """(*k, I, O) → (O, I, *k)."""
    k = np.asarray(k)
    n = k.ndim - 2
    return np.ascontiguousarray(np.transpose(k, (n + 1, n) + tuple(range(n))))


def _undeconv(k) -> np.ndarray:
    """Flipped forward-conv (kd, kh, kw, I, O) → ConvTranspose (I, O, kd,
    kh, kw)."""
    k = np.transpose(np.asarray(k), (3, 4, 0, 1, 2))
    return np.ascontiguousarray(k[:, :, ::-1, ::-1, ::-1])


def _bn(sd, prefix, params, stats):
    bn_p = params["TorchBatchNorm_0"]
    bn_s = stats["TorchBatchNorm_0"]
    sd[f"{prefix}.bn.weight"] = bn_p["scale"]
    sd[f"{prefix}.bn.bias"] = bn_p["bias"]
    sd[f"{prefix}.bn.running_mean"] = bn_s["mean"]
    sd[f"{prefix}.bn.running_var"] = bn_s["var"]
    sd[f"{prefix}.bn.num_batches_tracked"] = np.zeros((), np.int64)


def state_dict_from_jax(params, batch_stats) -> dict[str, torch.Tensor]:
    """JAX CascadeMVSNet variables (nested dicts of arrays) → reference-
    named tensors for `CascadeMVSNet.load_state_dict(strict=True)`."""
    sd: dict[str, np.ndarray] = {}
    fp, fs = params["feature"], batch_stats["feature"]
    for torch_name, our_name in FEATURE_BLOCKS:
        prefix = f"feature.{torch_name}"
        sd[f"{prefix}.conv.weight"] = _unconv(fp[our_name]["Conv_0"]["kernel"])
        _bn(sd, prefix, fp[our_name], fs[our_name])
    for head in FEATURE_HEADS:
        entry = fp[head]["Conv_0"]
        sd[f"feature.{head}.weight"] = _unconv(entry["kernel"])
        if "bias" in entry:
            sd[f"feature.{head}.bias"] = np.asarray(entry["bias"])
    i = 0
    while f"stage{i + 1}" in params:
        cp = params[f"stage{i + 1}"]["cost_reg"]
        cs = batch_stats[f"stage{i + 1}"]["cost_reg"]
        prefix = f"cost_regularization.{i}"
        for name in COSTREG_CONVS:
            sd[f"{prefix}.{name}.conv.weight"] = _unconv(
                cp[name]["Conv_0"]["kernel"])
            _bn(sd, f"{prefix}.{name}", cp[name], cs[name])
        for name in COSTREG_DECONVS:
            sd[f"{prefix}.{name}.conv.weight"] = _undeconv(
                cp[name]["kernel"])
            _bn(sd, f"{prefix}.{name}", cp[name], cs[name])
        sd[f"{prefix}.prob.weight"] = _unconv(cp["prob"]["Conv_0"]["kernel"])
        i += 1
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


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
