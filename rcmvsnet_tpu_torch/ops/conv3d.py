"""K2 (+K3): the cost-volume U-Net's 3×3×3 convolution.

`conv3d` launches the CUDA kernel `csrc/conv3d.cu` for a CUDA tensor; for
a CPU tensor it returns `conv3d_plain` (`F.conv3d` / `F.conv_transpose3d`
on the same BN-folded weights, then ReLU and the skip add).

Modes, all k=3, padding 1:
  * "s1": stride 1;
  * "s2": stride 2 in z/h/w — the TPU's `conv_lanes(z_stride=2)` followed
    by `pallas_resample.subsample_lanes`, computed at the strided output
    positions directly;
  * "t2": transposed, stride 2, output_padding 1 — the TPU's `conv_lanes`
    over `pallas_resample.stuff_lanes`' zero-stuffed copy, computed as a
    gather over the un-stuffed input.

Replaces `rcmvsnet_tpu/ops/pallas_costreg.py` `conv_lanes` and
`rcmvsnet_tpu/ops/pallas_resample.py` `subsample_lanes` / `stuff_lanes`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

MODES = {"s1": 0, "s2": 1, "t2": 2}


def out_shape(mode: str, d: int, h: int, w: int):
    """Output (D, H, W) of a mode for input (d, h, w)."""
    if mode == "s1":
        return d, h, w
    if mode == "s2":
        return (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return 2 * d, 2 * h, 2 * w


def conv3d_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 mode: str = "s1", relu: bool = True,
                 skip: torch.Tensor | None = None) -> torch.Tensor:
    """x [N, Ci, D, H, W]; weight [Co, Ci, 3, 3, 3] for "s1"/"s2" or the
    ConvTranspose3d layout [Ci, Co, 3, 3, 3] for "t2"; bias [Co]; skip, if
    given, is added after the ReLU. Returns [N, Co, D', H', W']."""
    if mode == "t2":
        y = F.conv_transpose3d(x, weight, bias, stride=2, padding=1,
                               output_padding=1)
    else:
        y = F.conv3d(x, weight, bias, stride=1 if mode == "s1" else 2,
                     padding=1)
    if relu:
        y = torch.relu(y)
    if skip is not None:
        y = y + skip
    return y


def _lib():
    fn = _build.load("conv3d").conv3d_f32
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           mode: str = "s1", relu: bool = True,
           skip: torch.Tensor | None = None) -> torch.Tensor:
    """Same contract as `conv3d_plain`; the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return conv3d_plain(x, weight, bias, mode, relu, skip)
    N, Ci, D, H, W = x.shape
    if mode == "t2":
        w = weight.permute(1, 0, 2, 3, 4)                   # [Co, Ci, 3,3,3]
    else:
        w = weight
    Co = w.shape[0]
    if tuple(w.shape) != (Co, Ci, 3, 3, 3) or bias.shape != (Co,):
        raise ValueError(f"conv3d: weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit input {Ci} "
                         f"channels in mode {mode}")
    w = w.reshape(Co, Ci, 27).contiguous()
    Do, Ho, Wo = out_shape(mode, D, H, W)
    tensors = [x, w, bias] + ([skip] if skip is not None else [])
    _build.require_cuda("conv3d", *tensors)
    if skip is not None and skip.shape != (N, Co, Do, Ho, Wo):
        raise ValueError(f"conv3d: skip {tuple(skip.shape)} != output "
                         f"{(N, Co, Do, Ho, Wo)}")
    out = torch.empty((N, Co, Do, Ho, Wo), dtype=torch.float32,
                      device=x.device)
    err = _lib()(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 skip.data_ptr() if skip is not None else None,
                 out.data_ptr(), N, Ci, D, H, W, Co, Do, Ho, Wo,
                 MODES[mode], int(relu), _build.stream_ptr(x.device))
    _build.check(err, "conv3d")
    conv3d.launches += 1
    return out


conv3d.launches = 0
