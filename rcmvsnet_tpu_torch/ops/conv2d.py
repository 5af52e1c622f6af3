"""K5: the FeatureNet FPN's 2D convolution with a folded-BN epilogue, and
stage 3's lateral head in one pass.

`conv2d` launches the CUDA kernel `csrc/conv2d.cu` for a CUDA tensor; for
a CPU tensor it returns `conv2d_plain` (`F.conv2d`, then scale/shift,
ReLU and the nearest-×2 upsample-add with `F.interpolate`). The kernel
has two routes, picked per call by `route`: a 3xTF32 implicit GEMM on the
tensor cores ("tc", the 3×3 and 5×5 convs with Ci ≥ 8; `tile` picks its
block tile) and a direct conv on the CUDA cores ("direct", conv0.0 with
its 3 input channels and the 1×1 heads, which are bound by bytes).

`lateral_conv2d` is stage 3's head: out3(nearest×2(up) + inner(lat) + b)
with the lateral sum formed tile by tile in shared memory and never
written; `lateral_conv2d_plain` is the composition of the two plain calls.
Its launches count as K5's.

Both write NCHW or, with out_layout="warp", [N, H, W, Co]: the source
layout of the warp kernels (K1), so the eval heads feed K1 without a
permute.

bfloat16 (the bf16 eval path, `BackboneConfig.eval_dtype`): a bf16 `x`
selects K5-bf16, `csrc/conv2d_bf16.cu` (counted in `conv2d.bf16.launches`,
the float32 kernel in `conv2d.launches`), a design of its own: the tile
staged channels-last, 8-byte fragment loads, 8-channel chunks (m16n8k8)
at Ci ≤ 8, the lateral sum formed in registers, 16-byte stores. x, weight
and up bf16, scale and shift float32, float32 accumulation and epilogue,
the output rounded to bf16 once; with `up` the conv's result is rounded
first and the sum again, as the JAX path adds two bf16 arrays. Its plain
version is the float32 one on the bf16 operands (`.float()`), rounded
where JAX rounds; its 1×1 convs sum
the input channels in order (the kernel's order: products of bf16 values
are exact in float32, so the two agree in every bit and a rounding to
bf16 after them cannot fall on different sides).

Replaces `rcmvsnet_tpu/ops/pallas_conv2d.py` `conv2d_cm` as
`nn/featurenet_fast.featurenet_packed` chains it, plus the 1×1 heads and
the upsample-add that chain leaves to XLA (`matmul_cm`, `upsample2_cm`)
and its stage-3 head `_stage3_polyphase`.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import _build
from ._build import SMS

KERNEL_SIZES = (1, 3, 5)
LAYOUTS = ("nchw", "warp")
# the tensor-core route's block tiles (MT, NTB) per (kernel size,
# stride): 8 warps as WY x WX (`warps`), each MT output rows x 16 columns,
# so a block covers WY·MT rows x 16·WX columns and NTB tiles of 8 output
# channels (MT·NTB ≤ 4: the accumulators live in registers)
TILES = {(3, 1): ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (1, 4)),
         (5, 2): ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4))}
LATERAL_TILES = ((1, 1), (2, 1), (4, 1))
# K5-bf16's tiles: TILES and two with more rows a warp at 2 and 4 channel
# tiles (measured faster at the DTU eval shapes; PERF.md)
TILES_BF16 = {(3, 1): TILES[(3, 1)] + ((2, 4), (4, 2)),
              (5, 2): TILES[(5, 2)] + ((2, 4),)}


def route(k: int, stride: int, padding: int, ci: int) -> str:
    """"tc" for the 3×3 (stride 1) and 5×5 (stride 2) convs with at least
    8 input channels and padding k // 2; "direct" otherwise (each 1×1
    head and conv0.0 measured faster there)."""
    if (k, stride) in TILES and padding == k // 2 and ci >= 8:
        return "tc"
    return "direct"


def warps(stride: int) -> tuple[int, int]:
    """(WY, WX): the tensor-core route's warps per block, rows x columns;
    2 x 4 at stride 1, 8 x 1 at stride 2."""
    return (2, 4) if stride == 1 else (8, 1)


def tile(k: int, stride: int, n: int, co: int, ho: int, wo: int,
         tiles=None) -> tuple[int, int]:
    """(MT, NTB) of the tensor-core route for `co` output channels over an
    [ho, wo] output of `n` samples: every channel tile in one block where
    TILES allows (up to 4), then the most rows per warp that still leave
    two blocks per SM."""
    tiles = tiles or TILES[(k, stride)]
    nt = -(-co // 8)
    ntb = max((b for _, b in tiles if nt % b == 0), default=1)
    for mt in (4, 2, 1):
        if (mt, ntb) not in tiles:
            continue
        wy, wx = warps(stride)
        blocks = n * -(-nt // ntb) * -(-ho // (wy * mt)) * -(-wo // (16 * wx))
        if blocks >= 2 * SMS or mt == min(m for m, b in tiles if b == ntb):
            return mt, ntb
    raise AssertionError(f"no tile with {ntb} channel tiles in {tiles}")


def scratch_floats(k: int, ci: int, co: int, ntb: int,
                   chunk: int = 8) -> int:
    """4-byte words of the prepared weights the tensor-core route lays
    out: [groups][chunks of `chunk` ci][k·k][8][8·ntb] (chunk 8 for
    float32, 16 for K5-bf16, two channels a word; its 8-channel chunks at
    Ci ≤ 8 take half)."""
    nw = 8 * ntb
    return -(-co // nw) * -(-ci // chunk) * k * k * 8 * nw


def _chunk(dtype) -> int:
    """Input channels a tensor-core chunk stages."""
    return 16 if dtype == torch.bfloat16 else 8


def _layout(y: torch.Tensor, out_layout: str) -> torch.Tensor:
    if out_layout not in LAYOUTS:
        raise ValueError(f"out_layout must be one of {LAYOUTS}")
    return y.permute(0, 2, 3, 1).contiguous() if out_layout == "warp" else y


def _conv1x1_ordered(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A 1×1 conv as Σ_ci x[:, ci] · w[:, ci], the input channels in
    order: the bf16 kernels' order of operations for their 1×1 sums."""
    w = weight[:, :, 0, 0]
    y = x[:, None, 0] * w[None, :, 0, None, None]
    for ci in range(1, x.shape[1]):
        y = y + x[:, None, ci] * w[None, :, ci, None, None]
    return y


def _conv2d_plain_bf16(x, weight, scale, shift, stride, padding, relu, up,
                       out_layout):
    """`conv2d_plain` for a bf16 x: float32 on the bf16 operands, the
    result rounded to bf16 (before and after the up-add)."""
    xf, wf = x.float(), weight.to(torch.bfloat16).float()
    if wf.shape[-1] == 1 and stride == 1 and padding == 0:
        y = _conv1x1_ordered(xf, wf)
    else:
        y = F.conv2d(xf, wf, stride=stride, padding=padding)
    if scale is not None:
        y = y * scale[None, :, None, None]
    if shift is not None:
        y = y + shift[None, :, None, None]
    if relu:
        y = torch.relu(y)
    if up is not None:
        y = F.interpolate(up.float(), scale_factor=2, mode="nearest") \
            + y.to(torch.bfloat16).float()
    return _layout(y.to(torch.bfloat16), out_layout)


def conv2d_plain(x: torch.Tensor, weight: torch.Tensor,
                 scale: torch.Tensor | None = None,
                 shift: torch.Tensor | None = None, stride: int = 1,
                 padding: int = 0, relu: bool = False,
                 up: torch.Tensor | None = None,
                 out_layout: str = "nchw") -> torch.Tensor:
    """x [N, Ci, H, W]; weight [Co, Ci, k, k]; y = conv·scale + shift
    (per output channel; None means 1 and 0); ReLU if asked; then, if `up`
    [N, Co, H'/2, W'/2] is given, y += nearest-×2(up). NCHW, or [N, H',
    W', Co] with out_layout="warp". A bf16 x gives a bf16 result (see the
    module's note)."""
    if x.dtype == torch.bfloat16:
        return _conv2d_plain_bf16(x, weight, scale, shift, stride, padding,
                                  relu, up, out_layout)
    y = F.conv2d(x, weight, stride=stride, padding=padding)
    if scale is not None:
        y = y * scale[None, :, None, None]
    if shift is not None:
        y = y + shift[None, :, None, None]
    if relu:
        y = torch.relu(y)
    if up is not None:
        y = F.interpolate(up, scale_factor=2, mode="nearest") + y
    return _layout(y, out_layout)


def lateral_conv2d_plain(up: torch.Tensor, lat: torch.Tensor,
                         inner_w: torch.Tensor, inner_b: torch.Tensor | None,
                         weight: torch.Tensor,
                         out_layout: str = "nchw") -> torch.Tensor:
    """conv3×3(nearest-×2(up) + inner(lat) + inner_b), padding 1: up [N,
    Cu, H/2, W/2], lat [N, Cl, H, W], inner_w [Cu, Cl, 1, 1], weight [Co,
    Cu, 3, 3]; the two plain calls the FPN makes (bf16: the sum rounded to
    bf16 as the kernel stages it)."""
    s = conv2d_plain(lat, inner_w, shift=inner_b, up=up)
    return conv2d_plain(s, weight, padding=1, out_layout=out_layout)


def _lib(entry: str, n_ptr: int, n_int: int):
    """A C entry: `*_f32` of `csrc/conv2d.cu`, `*_bf16` of
    `csrc/conv2d_bf16.cu`."""
    source = "conv2d_bf16" if entry.endswith("_bf16") else "conv2d"
    fn = getattr(_build.load(source), entry)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _kind(x: torch.Tensor) -> str:
    """The C entries' suffix for x's element type."""
    return "bf16" if x.dtype == torch.bfloat16 else "f32"


def _require(name, x, weight, f32, typed):
    """f32: the float32 operands; typed: the ones of x's element type."""
    if x.dtype == torch.bfloat16:
        _build.require_cuda(name, *f32, bf16=(x, weight, *typed))
    else:
        _build.require_cuda(name, x, weight, *f32, *typed)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           scale: torch.Tensor | None = None,
           shift: torch.Tensor | None = None, stride: int = 1,
           padding: int = 0, relu: bool = False,
           up: torch.Tensor | None = None,
           out_layout: str = "nchw") -> torch.Tensor:
    """Same contract as `conv2d_plain`; the kernel on a CUDA tensor, by
    the route `route` picks, the instance of x's element type."""
    if x.device.type == "cpu":
        return conv2d_plain(x, weight, scale, shift, stride, padding, relu,
                            up, out_layout)
    N, Ci, H, W = x.shape
    Co, wci, k, k2 = weight.shape
    if wci != Ci or k != k2 or k not in KERNEL_SIZES or stride not in (1, 2):
        raise ValueError(f"conv2d: weight {tuple(weight.shape)}, stride "
                         f"{stride} do not fit input {tuple(x.shape)}")
    if out_layout not in LAYOUTS:
        raise ValueError(f"conv2d: out_layout must be one of {LAYOUTS}")
    Ho = (H + 2 * padding - k) // stride + 1
    Wo = (W + 2 * padding - k) // stride + 1
    _require("conv2d", x, weight, [t for t in (scale, shift) if t is not None],
             [up] if up is not None else [])
    for t in (scale, shift):
        if t is not None and t.shape != (Co,):
            raise ValueError(f"conv2d: scale/shift must be [{Co}]")
    if up is not None and up.shape != (N, Co, Ho // 2, Wo // 2):
        raise ValueError(f"conv2d: up {tuple(up.shape)} is not half of "
                         f"{(N, Co, Ho, Wo)}")
    nhwc = out_layout == "warp"
    shape = (N, Ho, Wo, Co) if nhwc else (N, Co, Ho, Wo)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    stream = _build.stream_ptr(x.device)
    kind = _kind(x)
    if route(k, stride, padding, Ci) == "tc":
        mt, ntb = tile(k, stride, N, Co, Ho, Wo,
                       TILES_BF16[(k, stride)] if kind == "bf16" else None)
        wt = torch.empty(scratch_floats(k, Ci, Co, ntb, _chunk(x.dtype)),
                         dtype=torch.int32, device=x.device)
        err = _lib(f"conv2d_tc_{kind}", 7, 13)(
            x.data_ptr(), weight.data_ptr(), _ptr(scale), _ptr(shift),
            _ptr(up), out.data_ptr(), wt.data_ptr(), N, Ci, H, W, Co, Ho, Wo,
            k, stride, int(relu), int(nhwc), mt, ntb, stream)
    else:
        err = _lib(f"conv2d_{kind}", 6, 12)(
            x.data_ptr(), weight.data_ptr(), _ptr(scale), _ptr(shift),
            _ptr(up), out.data_ptr(), N, Ci, H, W, Co, Ho, Wo, k, stride,
            padding, int(relu), int(nhwc), stream)
    _build.check(err, "conv2d")
    _count(x).launches += 1
    return out


conv2d.launches = 0
conv2d.bf16 = SimpleNamespace(launches=0)


def _count(x: torch.Tensor):
    """The launch count of x's instance: `conv2d` (float32) or
    `conv2d.bf16`."""
    return conv2d.bf16 if x.dtype == torch.bfloat16 else conv2d


def lateral_conv2d(up: torch.Tensor, lat: torch.Tensor,
                   inner_w: torch.Tensor, inner_b: torch.Tensor | None,
                   weight: torch.Tensor,
                   out_layout: str = "nchw") -> torch.Tensor:
    """Same contract as `lateral_conv2d_plain`; on a CUDA tensor one
    launch of K5's lateral head (counted as `conv2d`'s launch of lat's
    element type)."""
    if lat.device.type == "cpu":
        return lateral_conv2d_plain(up, lat, inner_w, inner_b, weight,
                                    out_layout)
    N, Cl, H, W = lat.shape
    Co, Cu = weight.shape[:2]
    if (tuple(weight.shape[2:]) != (3, 3) or inner_w.shape != (Cu, Cl, 1, 1)
            or Cl > 8 or H % 2 or W % 2
            or up.shape != (N, Cu, H // 2, W // 2)):
        raise ValueError(
            f"lateral_conv2d: up {tuple(up.shape)}, lat {tuple(lat.shape)}, "
            f"inner {tuple(inner_w.shape)}, weight {tuple(weight.shape)} do "
            f"not fit (Cl <= 8, H and W even)")
    if out_layout not in LAYOUTS:
        raise ValueError(f"lateral_conv2d: out_layout must be one of "
                         f"{LAYOUTS}")
    _require("lateral_conv2d", lat, weight,
             [inner_b] if inner_b is not None else [], [up, inner_w])
    nhwc = out_layout == "warp"
    out = torch.empty((N, H, W, Co) if nhwc else (N, Co, H, W),
                      dtype=lat.dtype, device=lat.device)
    mt, ntb = tile(3, 1, N, Co, H, W, LATERAL_TILES)
    wt = torch.empty(scratch_floats(3, Cu, Co, ntb, _chunk(lat.dtype)),
                     dtype=torch.int32, device=lat.device)
    err = _lib(f"lateral_conv2d_{_kind(lat)}", 7, 9)(
        up.data_ptr(), lat.data_ptr(), inner_w.data_ptr(), _ptr(inner_b),
        weight.data_ptr(), out.data_ptr(), wt.data_ptr(), N, Cu, Cl, H, W,
        Co, int(nhwc), mt, ntb, _build.stream_ptr(lat.device))
    _build.check(err, "lateral_conv2d")
    _count(lat).launches += 1
    return out
