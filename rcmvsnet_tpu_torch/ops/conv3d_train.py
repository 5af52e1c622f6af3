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
(`F.conv3d` / `F.conv_transpose3d` under autograd).

Replaces `rcmvsnet_tpu/ops/pallas_costreg_train.py` `conv_lanes_t` (its
custom VJP: dx through the forward kernel, dw through `_conv_dw`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .conv3d import MODES, conv3d, conv3d_plain, out_shape

# the adjoint of each mode, as a K2 mode
ADJOINT = {"s1": "s1", "s2": "t2", "t2": "s2"}
# the dw kernel's brick of base positions (z, y, x) per mode
BRICK = {"s1": (1, 8, 16), "s2": (1, 4, 16), "t2": (1, 8, 16)}
TARGET_BLOCKS = _build.SMS * 4  # about four dw blocks per SM
CO_GROUP = 64                 # output channels of one dw block (4 m16 tiles)


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


def conv3d_train_plain(x: torch.Tensor, weight: torch.Tensor,
                       mode: str) -> torch.Tensor:
    """x [N, Ci, D, H, W]; weight [Co, Ci, 3, 3, 3] ("s1", "s2") or
    [Ci, Co, 3, 3, 3] ("t2"). No bias, no ReLU."""
    return conv3d_plain(x, weight, None, mode, relu=False)


def _taps(k: int):
    return k // 9, (k // 3) % 3, k % 3


def conv3d_dw_plain(x: torch.Tensor, g: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """Weight gradient of `conv3d_train_plain` for the output cotangent g
    [N, Co, Do, Ho, Wo], in the weight's own layout: dW[co, ci, k] =
    Σ g[co, o] · x[ci, tap(o, k)]."""
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


def _lib():
    fn = _build.load("conv3d_dw").conv3d_dw_f32
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv3d_dw(x: torch.Tensor, g: torch.Tensor, mode: str) -> torch.Tensor:
    """Same contract as `conv3d_dw_plain`; the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return conv3d_dw_plain(x, g, mode)
    N, Ci, D, H, W = x.shape
    Co = g.shape[1]
    Do, Ho, Wo = out_shape(mode, D, H, W)
    if tuple(g.shape) != (N, Co, Do, Ho, Wo):
        raise ValueError(f"conv3d_dw: g {tuple(g.shape)} is not the "
                         f"{mode} output of x {tuple(x.shape)}")
    _build.require_cuda("conv3d_dw", x, g)
    plan = dw_chunks(mode, N, Ci, D, H, W)
    partial = torch.empty((plan.chunks, Co, Ci, 27), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((Co, Ci, 27), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                 dw.data_ptr(), N, Ci, D, H, W, Co, Do, Ho, Wo, MODES[mode],
                 plan.chunks, plan.per_chunk, plan.brick[1],
                 _build.stream_ptr(x.device))
    _build.check(err, "conv3d_dw")
    conv3d_dw.launches += 1
    dw = dw.reshape(Co, Ci, 3, 3, 3)
    return dw.transpose(0, 1) if mode == "t2" else dw


conv3d_dw.launches = 0


def _adjoint_weight(weight: torch.Tensor, mode: str) -> torch.Tensor:
    """The weight K2 takes in the adjoint mode (see the module doc)."""
    if mode == "s1":
        return weight.flip((2, 3, 4)).transpose(0, 1).contiguous()
    return weight


class _Conv3dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, mode):
        ctx.mode = mode
        ctx.save_for_backward(x, weight)
        co = weight.shape[1] if mode == "t2" else weight.shape[0]
        return conv3d(x, weight, x.new_zeros(co), mode, relu=False)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        mode = ctx.mode
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            adj = ADJOINT[mode]
            dx = conv3d(g, _adjoint_weight(weight, mode),
                        x.new_zeros(x.shape[1]), adj, relu=False,
                        out_dhw=tuple(x.shape[2:]) if adj == "t2" else None)
        if ctx.needs_input_grad[1]:
            dw = conv3d_dw(x, g, mode)
        return dx, dw, None


def conv3d_train(x: torch.Tensor, weight: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """Same function as `conv3d_train_plain`, forward and backward through
    K2 and the dw kernel on a CUDA tensor."""
    return _Conv3dTrain.apply(x, weight, mode)
