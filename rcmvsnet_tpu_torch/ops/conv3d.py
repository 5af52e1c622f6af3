"""K2 (+K3): the cost-volume U-Net's 3×3×3 convolution, and K9 on the
same kernel.

`conv3d` launches the CUDA kernel `csrc/conv3d.cu` for a CUDA tensor; for
a CPU tensor it returns `conv3d_plain` (`F.conv3d` / `F.conv_transpose3d`
on the same BN-folded weights, then ReLU and the skip add).

`conv3d_lanewise` (K9) is the raw convolution: the same kernel with zero
bias, no ReLU and no skip, on the unfolded weight, at any D/H/W (odd sizes
included: the kernel bounds every axis of its bricks on its own). It
counts its own launches; `conv3d.launches` counts K2's.

Modes, all k=3, padding 1:
  * "s1": stride 1;
  * "s2": stride 2 in z/h/w — the TPU's `conv_lanes(z_stride=2)` followed
    by `pallas_resample.subsample_lanes`, computed at the strided output
    positions directly;
  * "t2": transposed, stride 2, output_padding 1 — the TPU's `conv_lanes`
    over `pallas_resample.stuff_lanes`' zero-stuffed copy, computed as 8
    parity classes over the un-stuffed input (output 2i + p reads, per
    axis, tap 1 from input i when p = 0, taps 0 and 2 from inputs i + 1
    and i when p = 1).

The kernel is an implicit GEMM on the tensor cores (3xTF32 m16n8k8 MMAs,
float32 accumulators; see `csrc/tc_conv3d.cuh`); `tile` picks its block
tile from the shapes.

bfloat16 (the bf16 eval and train paths): a bf16 `x` launches K2-bf16,
`csrc/conv3d_bf16.cu` (counted in `conv3d.bf16.launches`, the float32
kernel in `conv3d.launches`): the same modes, tiles and epilogue, its own
design (x staged channels-last, one bf16 m16n8k16 MMA per multiply-add;
the source's header): x, weight and skip bf16, bias float32, float32
accumulation, bias, ReLU and skip add, the output rounded to bf16 once,
or written float32 with `out_dtype=torch.float32` (the prob head, as
`costreg_lanes` writes it). The plain version is the float32 one on the
bf16 operands, rounded where the kernel rounds.

Replaces `rcmvsnet_tpu/ops/pallas_costreg.py` `conv_lanes` and
`rcmvsnet_tpu/ops/pallas_resample.py` `subsample_lanes` / `stuff_lanes`
(K2, K3), and `rcmvsnet_tpu/ops/pallas_conv3d.py:167` `conv3d_lanewise`
(K9).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import _build
from ._build import SMS

MODES = {"s1": 0, "s2": 1, "t2": 2}
# block tiles (MT, NTB) the kernel is built for, per mode: MT rows of 16 x
# positions per warp (a brick of MT x 8 x 16 base positions), NTB tiles of
# 8 output channels per block ("t2" keeps all 8 parity classes' sums in
# registers, so MT * NTB <= 2 there)
TILES = {"s1": ((1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (4, 1)),
         "s2": ((1, 1), (1, 2), (1, 4)),
         "t2": ((1, 1), (1, 2), (2, 1))}


def out_shape(mode: str, d: int, h: int, w: int):
    """Output (D, H, W) of a mode for input (d, h, w)."""
    if mode == "s1":
        return d, h, w
    if mode == "s2":
        return (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return 2 * d, 2 * h, 2 * w


def tile(mode: str, n: int, co: int, base) -> tuple[int, int]:
    """(MT, NTB) for `co` output channels over the base grid `base` (the
    output for "s1"/"s2", the input for "t2") of `n` samples: as many
    channel tiles per block as TILES allows, then the most rows per warp
    that still leave two blocks per SM."""
    nt = -(-co // 8)
    ntb = 4 if (1, 4) in TILES[mode] and nt % 4 == 0 else min(nt, 2)
    blocks = n * -(-nt // ntb) * -(-base[1] // 8) * -(-base[2] // 16)
    for mt in (4, 2, 1):
        if (mt, ntb) in TILES[mode] and (
                mt == 1 or blocks * -(-base[0] // mt) >= 2 * SMS):
            return mt, ntb
    raise AssertionError("TILES lists (1, ntb) for every mode")


def _t2_padding(d: int, h: int, w: int, out_dhw) -> tuple:
    """output_padding of a "t2" conv over (d, h, w) that gives out_dhw
    (2n or 2n − 1 per axis; None: 2n)."""
    if out_dhw is None:
        return (1, 1, 1)
    pad = tuple(o - (2 * i - 1) for o, i in zip(out_dhw, (d, h, w)))
    if any(p not in (0, 1) for p in pad):
        raise ValueError(f"t2 over {(d, h, w)} cannot give {tuple(out_dhw)}")
    return pad


def conv3d_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 mode: str = "s1", relu: bool = True,
                 skip: torch.Tensor | None = None,
                 out_dhw=None, out_dtype=None) -> torch.Tensor:
    """x [N, Ci, D, H, W]; weight [Co, Ci, 3, 3, 3] for "s1"/"s2" or the
    ConvTranspose3d layout [Ci, Co, 3, 3, 3] for "t2"; bias [Co]; skip, if
    given, is added after the ReLU. Returns [N, Co, D', H', W']. `out_dhw`
    ("t2" only) trims the output to 2n − 1 on an axis, as the adjoint of a
    stride-2 conv over an odd size needs. A bf16 x: float32 on the bf16
    operands, the result in `out_dtype` (default bf16)."""
    if x.dtype == torch.bfloat16:
        y = conv3d_plain(x.float(), weight.to(torch.bfloat16).float(), bias,
                         mode, relu,
                         skip.float() if skip is not None else None, out_dhw)
        return y.to(out_dtype or torch.bfloat16)
    if mode == "t2":
        y = F.conv_transpose3d(x, weight, bias, stride=2, padding=1,
                               output_padding=_t2_padding(*x.shape[2:],
                                                          out_dhw))
    else:
        y = F.conv3d(x, weight, bias, stride=1 if mode == "s1" else 2,
                     padding=1)
    if relu:
        y = torch.relu(y)
    if skip is not None:
        y = y + skip
    return y


def _lib(entry: str = "conv3d_f32", n_int: int = 13, lib: str = "conv3d"):
    fn = getattr(_build.load(lib), entry)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor, mode: str, relu: bool,
            skip: torch.Tensor | None, out_dhw=None,
            out_dtype=None) -> torch.Tensor:
    """Check the arguments and launch `csrc/conv3d.cu` once, the instance
    of x's element type."""
    N, Ci, D, H, W = x.shape
    bf16 = x.dtype == torch.bfloat16
    if mode == "t2":
        w = weight.permute(1, 0, 2, 3, 4)                   # [Co, Ci, 3,3,3]
    else:
        w = weight
    Co = w.shape[0]
    if tuple(w.shape) != (Co, Ci, 3, 3, 3) or bias.shape != (Co,):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit input {Ci} "
                         f"channels in mode {mode}")
    w = w.reshape(Co, Ci, 27).contiguous()
    if mode == "t2":
        pad = _t2_padding(D, H, W, out_dhw)
        Do, Ho, Wo = (2 * n - 1 + p for n, p in zip((D, H, W), pad))
    elif out_dhw is not None:
        raise ValueError(f"{name}: out_dhw is for mode t2 only")
    else:
        Do, Ho, Wo = out_shape(mode, D, H, W)
    out_dtype = out_dtype or x.dtype
    out_f32 = bf16 and out_dtype == torch.float32
    if out_dtype not in (x.dtype, torch.float32) or (
            out_f32 and (mode != "s1" or skip is not None)):
        raise ValueError(f"{name}: out_dtype {out_dtype} for a {x.dtype} "
                         f"input in mode {mode} (float32 out of bf16: s1 "
                         f"without skip)")
    skips = [skip] if skip is not None else []
    if bf16:
        _build.require_cuda(name, bias, bf16=(x, w, *skips))
    else:
        _build.require_cuda(name, x, w, bias, *skips)
    if skip is not None and skip.shape != (N, Co, Do, Ho, Wo):
        raise ValueError(f"{name}: skip {tuple(skip.shape)} != output "
                         f"{(N, Co, Do, Ho, Wo)}")
    mt, ntb = tile(mode, N, Co, (D, H, W) if mode == "t2" else (Do, Ho, Wo))
    out = torch.empty((N, Co, Do, Ho, Wo), dtype=out_dtype, device=x.device)
    # the kernel's weight layout, 27·8·8·ntb 4-byte words per (group of
    # 8·ntb output channels, chunk of 8 input channels, or of 16 bf16)
    chunk = 16 if bf16 else 8
    wt = torch.empty(-(-Co // (8 * ntb)) * -(-Ci // chunk) * 27 * 64 * ntb,
                     dtype=torch.int32, device=x.device)
    args = [x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            skip.data_ptr() if skip is not None else None,
            out.data_ptr(), wt.data_ptr(), N, Ci, D, H, W, Co, Do, Ho, Wo,
            MODES[mode], int(relu)]
    if bf16:
        err = _lib("conv3d_bf16", 14, "conv3d_bf16")(
            *args, int(out_f32), mt, ntb, _build.stream_ptr(x.device))
    else:
        err = _lib()(*args, mt, ntb, _build.stream_ptr(x.device))
    _build.check(err, name)
    return out


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           mode: str = "s1", relu: bool = True,
           skip: torch.Tensor | None = None, out_dhw=None,
           out_dtype=None) -> torch.Tensor:
    """Same contract as `conv3d_plain`; the kernel on a CUDA tensor, the
    instance of x's element type."""
    if x.device.type == "cpu":
        return conv3d_plain(x, weight, bias, mode, relu, skip, out_dhw,
                            out_dtype)
    out = _launch("conv3d", x, weight, bias, mode, relu, skip, out_dhw,
                  out_dtype)
    (conv3d.bf16 if x.dtype == torch.bfloat16 else conv3d).launches += 1
    return out


conv3d.launches = 0
conv3d.bf16 = SimpleNamespace(launches=0)


def conv3d_lanewise_plain(x: torch.Tensor, weight: torch.Tensor,
                          mode: str = "s1") -> torch.Tensor:
    """The raw 3×3×3 convolution, padding 1, no bias: x [N, Ci, D, H, W];
    weight [Co, Ci, 3, 3, 3] ("s1", "s2": stride 2, output ceil(n / 2)) or
    [Ci, Co, 3, 3, 3] ("t2": transposed, exactly 2× every axis)."""
    return conv3d_plain(x, weight, None, mode, relu=False)


def conv3d_lanewise(x: torch.Tensor, weight: torch.Tensor,
                    mode: str = "s1") -> torch.Tensor:
    """K9, replacing `rcmvsnet_tpu/ops/pallas_conv3d.py:167`
    `conv3d_lanewise` (its `pallas_call` at `:139`): the contract of
    `conv3d_lanewise_plain`, run on K2's kernel (`csrc/conv3d.cu`, zero
    bias, relu=0) for a CUDA tensor. The JAX function takes one sample
    [D, H, W, Ci] and a DHWIO kernel; `weights.unconv` / `undeconv` give
    that kernel in this layout."""
    if x.device.type == "cpu":
        return conv3d_lanewise_plain(x, weight, mode)
    co = weight.shape[1] if mode == "t2" else weight.shape[0]
    zero = torch.zeros(co, dtype=torch.float32, device=x.device)
    out = _launch("conv3d_lanewise", x, weight, zero, mode, False, None)
    conv3d_lanewise.launches += 1
    return out


conv3d_lanewise.launches = 0
