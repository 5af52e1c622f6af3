"""K8: the differentiable 3×3×3 convolution of the train-mode U-Nets.

`conv3d_train(x, weight, mode)` is one `torch.autograd.Function` around K2
(`ops/conv3d.conv3d`, zero bias, no ReLU, no skip — BN and ReLU stay in
autograd outside it):
  * forward: K2 in `mode`;
  * dx: K2 in the adjoint mode: "s1" with the flipped, ci↔co-swapped
    kernel; "s2" ↔ "t2" with the same weights ("t2" reads its weight in
    the ConvTranspose3d layout, which is the stride-2 conv's [Co, Ci] read
    the other way round; over an odd input size the "t2" adjoint is
    trimmed to it);
  * dw: `conv3d_dw`, the kernel `csrc/conv3d_dw.cu` on a CUDA tensor (a
    split-K GEMM on the tensor cores over the brick plan of `dw_chunks`,
    any Co: a block owns a group of ≤ CO_GROUP output channels),
    or `conv3d_dw_plain` (27 shifted products, one einsum each) on a CPU
    one.
Both halves dispatch by device, so on the CPU the Function runs the plain
versions and its backward composition is what the tests check.
`conv3d_train_plain` is the same function in plain PyTorch
(`F.conv3d` / `F.conv_transpose3d` under autograd). K2's bias is float32
in every instance: the Function passes a float32 zero bias whatever x's
dtype.

bfloat16 (the bf16 train path, `conv_lanes_t` at compute dtype bf16): a
bf16 x runs the bf16 instances. The float32 master weight is rounded to
bf16 inside the Function (as `conv_lanes` casts its kernel); the forward
is K2-bf16 (bf16 out, or float32 with `out_dtype=torch.float32`: the
prob head, JAX `nn/costreg.py:185-188`); the backward rounds its
cotangent to bf16 (a float32 one, the prob head's, changes: JAX rounds
the masked cotangent before its dx conv and its dw kernel,
`pallas_costreg_train.py:197-203`), runs K2-bf16 in the adjoint mode
(dx bf16, x's dtype) and `conv3d_dw` on K8dw-bf16,
`csrc/conv3d_dw_bf16.cu` (its own design: the GEMM dWᵀ[(ci, tap), co],
x im2col'd while staging, over the plan of `dw_plan_bf16`; one bf16 MMA
per multiply-add, float32 sums; dw float32, the parameter's dtype,
`pallas_costreg_train.py:157`). Its
plain version is the same Function on the plain versions
(`conv3d_train_plain` of a bf16 x): the float32 convolutions on the bf16
operands, rounded where the kernels round.

Replaces `rcmvsnet_tpu/ops/pallas_costreg_train.py` `conv_lanes_t` (its
custom VJP: dx through the forward kernel, dw through `_conv_dw`).
"""
from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .conv3d import MODES, conv3d, conv3d_plain, out_shape

# the adjoint of each mode, as a K2 mode
ADJOINT = {"s1": "s1", "s2": "t2", "t2": "s2"}
# the dw kernel's brick of base positions (z, y, x) per mode; the bf16
# kernel's (4 z rows in s1, 2 in s2: a smaller share of halo rows)
BRICK = {"s1": (1, 8, 16), "s2": (1, 4, 16), "t2": (1, 8, 16)}
BRICK_BF16 = {"s1": (4, 8, 16), "s2": (2, 4, 16), "t2": (1, 8, 16)}
TARGET_BLOCKS = _build.SMS * 4  # about four dw blocks per SM
CO_GROUP = 64                 # output channels of one dw block (4 m16 tiles)
DW_TILES = 14                 # bf16 dw: m16 tiles of an octet of Ci (8 ci
                              # at 2 of the 27 taps each)


class DwPlan(NamedTuple):
    """The dw kernel's split-K plan: the base grid (the output for
    "s1"/"s2", the input for "t2", whose 8 parity classes each get their
    own blocks) cut into bricks of `brick`, `grid` bricks per axis and
    `bricks` in all (samples included; brick index x fastest, then y, z,
    sample), run as `chunks` runs of `per_chunk` consecutive bricks (the
    last one shorter), one block per (run, 8-channel chunk of Ci, class,
    group of CO_GROUP output channels); each block writes its group's rows
    of one partial."""
    brick: tuple
    grid: tuple
    bricks: int
    chunks: int
    per_chunk: int
    ci_chunks: int
    classes: int


class DwPlanBf16(NamedTuple):
    """The bf16 dw kernel's split-K plan: the base grid cut into bricks of
    `brick` (BRICK_BF16; `grid`, `bricks` and their order as in `DwPlan`),
    run as `chunks` runs of `per_chunk` consecutive bricks, one block per
    (run, block of `tiles` m16 tiles of one octet of Ci, block of
    `n_tiles` n8 tiles of Co): `m_blocks` x `co_blocks` blocks a run. A
    block runs every parity class of its bricks ("t2"), so classes add no
    blocks."""
    brick: tuple
    grid: tuple
    bricks: int
    chunks: int
    per_chunk: int
    m_blocks: int
    co_blocks: int
    tiles: int
    n_tiles: int


def conv3d_train_plain(x: torch.Tensor, weight: torch.Tensor,
                       mode: str, out_dtype=None) -> torch.Tensor:
    """x [N, Ci, D, H, W]; weight [Co, Ci, 3, 3, 3] ("s1", "s2") or
    [Ci, Co, 3, 3, 3] ("t2"). No bias, no ReLU. A bf16 x: the bf16
    Function (see the module doc) on the plain versions; out_dtype
    (bf16 x only) float32 for the prob head."""
    if x.dtype == torch.bfloat16:
        return _Conv3dTrain.apply(x, weight, mode, out_dtype, True)
    # float32: autograd through the plain conv, whose weight gradient is
    # one library call (the Function's `conv3d_dw_plain` is 27 gathered
    # products: far slower on the CPU, where the tests run this path)
    return conv3d_plain(x, weight, None, mode, relu=False)


def _taps(k: int):
    return k // 9, (k // 3) % 3, k % 3


def conv3d_dw_plain(x: torch.Tensor, g: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """Weight gradient of `conv3d_train_plain` for the output cotangent g
    [N, Co, Do, Ho, Wo], in the weight's own layout: dW[co, ci, k] =
    Σ g[co, o] · x[ci, tap(o, k)], float32 (bf16 x and g: float32 sums
    of their exact products)."""
    if x.dtype == torch.bfloat16:
        return conv3d_dw_plain(x.float(), g.float(), mode)
    N, Ci, D, H, W = x.shape
    Co = g.shape[1]
    cols = []
    if mode == "t2":
        # output o = 2i − 1 + k reads input i: shift the padded cotangent
        gp = F.pad(g, (1, 1) * 3)
        for k in range(27):
            kz, ky, kx = _taps(k)
            gs = gp[:, :, kz:kz + 2 * D:2, ky:ky + 2 * H:2, kx:kx + 2 * W:2]
            cols.append(torch.einsum("ncdhw,nodhw->oc", x, gs))
        return torch.stack(cols, -1).reshape(Co, Ci, 3, 3, 3).transpose(0, 1)
    s = 1 if mode == "s1" else 2
    Do, Ho, Wo = g.shape[2:]
    xp = F.pad(x, (1, 1) * 3)
    for k in range(27):
        kz, ky, kx = _taps(k)
        xs = xp[:, :, kz:kz + s * (Do - 1) + 1:s, ky:ky + s * (Ho - 1) + 1:s,
                kx:kx + s * (Wo - 1) + 1:s]
        cols.append(torch.einsum("ncdhw,nodhw->oc", xs, g))
    return torch.stack(cols, -1).reshape(Co, Ci, 3, 3, 3)


def dw_chunks(mode: str, n: int, ci: int, d: int, h: int,
              w: int) -> DwPlan:
    """The plan of bricks and chunks for x [n, ci, d, h, w] in `mode`:
    enough runs for about TARGET_BLOCKS blocks, each at least one brick."""
    base = (d, h, w) if mode == "t2" else out_shape(mode, d, h, w)
    brick = BRICK[mode]
    grid = tuple(-(-b // e) for b, e in zip(base, brick))
    bricks = n * grid[0] * grid[1] * grid[2]
    ci_chunks, classes = -(-ci // 8), 8 if mode == "t2" else 1
    want = -(-TARGET_BLOCKS // (ci_chunks * classes))
    per_chunk = -(-bricks // max(1, min(want, bricks)))
    return DwPlan(brick, grid, bricks, -(-bricks // per_chunk), per_chunk,
                  ci_chunks, classes)


@functools.lru_cache(maxsize=256)
def dw_plan_bf16(mode: str, n: int, ci: int, co: int, d: int, h: int,
                 w: int) -> DwPlanBf16:
    """The bf16 dw kernel's plan for x [n, ci, d, h, w] and `co` output
    channels in `mode`: the rule `csrc/conv3d_dw_bf16.cu` (`by_co`) sizes
    its blocks by (Co ≤ 8: one n8 tile and a whole octet's 14 m16 tiles a
    block; wider: two n8 tiles and 7 m16 tiles), then enough runs for
    about TARGET_BLOCKS blocks in all, each at least one brick."""
    base = (d, h, w) if mode == "t2" else out_shape(mode, d, h, w)
    brick = BRICK_BF16[mode]
    grid = tuple(-(-b // e) for b, e in zip(base, brick))
    bricks = n * grid[0] * grid[1] * grid[2]
    n_tiles = 1 if co <= 8 else 2
    tiles = DW_TILES if co <= 8 else DW_TILES // 2
    m_blocks = -(-ci // 8) * (DW_TILES // tiles)
    co_blocks = -(-co // (8 * n_tiles))
    want = -(-TARGET_BLOCKS // (m_blocks * co_blocks))
    per_chunk = -(-bricks // max(1, min(want, bricks)))
    return DwPlanBf16(brick, grid, bricks, -(-bricks // per_chunk),
                      per_chunk, m_blocks, co_blocks, tiles, n_tiles)


def _lib(entry: str = "conv3d_dw_f32", lib: str = "conv3d_dw"):
    fn = getattr(_build.load(lib), entry)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv3d_dw(x: torch.Tensor, g: torch.Tensor, mode: str) -> torch.Tensor:
    """Same contract as `conv3d_dw_plain`; the kernel on a CUDA tensor,
    the one of x's element type (bf16 x and g: K8dw-bf16,
    `csrc/conv3d_dw_bf16.cu`, counted in `conv3d_dw.bf16.launches`)."""
    if x.device.type == "cpu":
        return conv3d_dw_plain(x, g, mode)
    N, Ci, D, H, W = x.shape
    Co = g.shape[1]
    Do, Ho, Wo = out_shape(mode, D, H, W)
    if tuple(g.shape) != (N, Co, Do, Ho, Wo):
        raise ValueError(f"conv3d_dw: g {tuple(g.shape)} is not the "
                         f"{mode} output of x {tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        _build.require_cuda("conv3d_dw", bf16=(x, g))
    else:
        _build.require_cuda("conv3d_dw", x, g)
    plan = (dw_plan_bf16(mode, N, Ci, Co, D, H, W) if bf16
            else dw_chunks(mode, N, Ci, D, H, W))
    partial = torch.empty((plan.chunks, Co, Ci, 27), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((Co, Ci, 27), dtype=torch.float32, device=x.device)
    err = (_lib("conv3d_dw_bf16", "conv3d_dw_bf16") if bf16 else _lib())(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(), N, Ci,
        D, H, W, Co, Do, Ho, Wo, MODES[mode], plan.chunks, plan.per_chunk,
        plan.brick[1], _build.stream_ptr(x.device))
    _build.check(err, "conv3d_dw")
    (conv3d_dw.bf16 if bf16 else conv3d_dw).launches += 1
    dw = dw.reshape(Co, Ci, 3, 3, 3)
    return dw.transpose(0, 1) if mode == "t2" else dw


conv3d_dw.launches = 0
conv3d_dw.bf16 = SimpleNamespace(launches=0)


def _adjoint_weight(weight: torch.Tensor, mode: str) -> torch.Tensor:
    """The weight K2 takes in the adjoint mode (see the module doc)."""
    if mode == "s1":
        return weight.flip((2, 3, 4)).transpose(0, 1).contiguous()
    return weight


def _zero_bias(n: int, x: torch.Tensor) -> torch.Tensor:
    """K2's zero bias: float32 in every instance."""
    return torch.zeros(n, dtype=torch.float32, device=x.device)


class _Conv3dTrain(torch.autograd.Function):
    """K8 (see the module doc); `plain` runs the plain versions on any
    device (the bf16 plain pair)."""

    @staticmethod
    def forward(ctx, x, weight, mode, out_dtype=None, plain=False):
        ctx.mode, ctx.plain = mode, plain
        ctx.save_for_backward(x, weight)
        co = weight.shape[1] if mode == "t2" else weight.shape[0]
        if plain:
            return conv3d_plain(x, weight, None, mode, relu=False,
                                out_dtype=out_dtype)
        return conv3d(x, weight.to(x.dtype), _zero_bias(co, x), mode,
                      relu=False, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        mode, plain = ctx.mode, ctx.plain
        g = g.to(x.dtype).contiguous()
        w = weight.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            adj = ADJOINT[mode]
            dhw = tuple(x.shape[2:]) if adj == "t2" else None
            if plain:
                dx = conv3d_plain(g, _adjoint_weight(w, mode), None, adj,
                                  relu=False, out_dhw=dhw)
            else:
                dx = conv3d(g, _adjoint_weight(w, mode),
                            _zero_bias(x.shape[1], x), adj, relu=False,
                            out_dhw=dhw)
        if ctx.needs_input_grad[1]:
            dw = (conv3d_dw_plain if plain else conv3d_dw)(x, g, mode)
        return dx, dw, None, None, None


def conv3d_train(x: torch.Tensor, weight: torch.Tensor, mode: str,
                 out_dtype=None) -> torch.Tensor:
    """Same function as `conv3d_train_plain`, forward and backward through
    K2 and the dw kernel on a CUDA tensor (bf16 x: their bf16 instances;
    out_dtype float32 for the prob head)."""
    return _Conv3dTrain.apply(x, weight, mode, out_dtype)
