"""K5: the FeatureNet FPN's 2D convolution with a folded-BN epilogue.

`conv2d` launches the CUDA kernel `csrc/conv2d.cu` for a CUDA tensor; for
a CPU tensor it returns `conv2d_plain` (`F.conv2d`, then scale/shift,
ReLU and the nearest-×2 upsample-add with `F.interpolate`).

Replaces `rcmvsnet_tpu/ops/pallas_conv2d.py` `conv2d_cm` as
`nn/featurenet_fast.featurenet_packed` chains it, plus the 1×1 heads and
the upsample-add that chain leaves to XLA (`matmul_cm`, `upsample2_cm`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

KERNEL_SIZES = (1, 3, 5)


def conv2d_plain(x: torch.Tensor, weight: torch.Tensor,
                 scale: torch.Tensor | None = None,
                 shift: torch.Tensor | None = None, stride: int = 1,
                 padding: int = 0, relu: bool = False,
                 up: torch.Tensor | None = None) -> torch.Tensor:
    """x [N, Ci, H, W]; weight [Co, Ci, k, k]; y = conv·scale + shift
    (per output channel; None means 1 and 0); ReLU if asked; then, if `up`
    [N, Co, H'/2, W'/2] is given, y += nearest-×2(up)."""
    y = F.conv2d(x, weight, stride=stride, padding=padding)
    if scale is not None:
        y = y * scale[None, :, None, None]
    if shift is not None:
        y = y + shift[None, :, None, None]
    if relu:
        y = torch.relu(y)
    if up is not None:
        y = F.interpolate(up, scale_factor=2, mode="nearest") + y
    return y


def _lib():
    fn = _build.load("conv2d").conv2d_f32
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           scale: torch.Tensor | None = None,
           shift: torch.Tensor | None = None, stride: int = 1,
           padding: int = 0, relu: bool = False,
           up: torch.Tensor | None = None) -> torch.Tensor:
    """Same contract as `conv2d_plain`; the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return conv2d_plain(x, weight, scale, shift, stride, padding, relu,
                            up)
    N, Ci, H, W = x.shape
    Co, wci, k, k2 = weight.shape
    if wci != Ci or k != k2 or k not in KERNEL_SIZES or stride not in (1, 2):
        raise ValueError(f"conv2d: weight {tuple(weight.shape)}, stride "
                         f"{stride} do not fit input {tuple(x.shape)}")
    Ho = (H + 2 * padding - k) // stride + 1
    Wo = (W + 2 * padding - k) // stride + 1
    extra = [t for t in (scale, shift, up) if t is not None]
    _build.require_cuda("conv2d", x, weight, *extra)
    for t in (scale, shift):
        if t is not None and t.shape != (Co,):
            raise ValueError(f"conv2d: scale/shift must be [{Co}]")
    if up is not None and up.shape != (N, Co, Ho // 2, Wo // 2):
        raise ValueError(f"conv2d: up {tuple(up.shape)} is not half of "
                         f"{(N, Co, Ho, Wo)}")
    out = torch.empty((N, Co, Ho, Wo), dtype=torch.float32, device=x.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = _lib()(x.data_ptr(), weight.data_ptr(), ptr(scale), ptr(shift),
                 ptr(up), out.data_ptr(), N, Ci, H, W, Co, Ho, Wo, k, stride,
                 padding, int(relu), _build.stream_ptr(x.device))
    _build.check(err, "conv2d")
    conv2d.launches += 1
    return out


conv2d.launches = 0
