"""K1: fused plane-sweep warp + multi-view variance, and K6, its backward.

`warp_variance` launches the CUDA kernel `csrc/warp_variance.cu` for a
float32 CUDA tensor; for a CPU tensor it returns `warp_variance_plain`,
the same function in plain PyTorch (`ops/warp.plane_sweep_variance` on
the [D, h, w] hypothesis volume built from (lo, step)). The kernel gives
a group of C/4 lanes to each reference pixel (one float4 of channels a
lane) and a block of 256 lanes walks a chunk of planes for its pixels
(the kernel's entry sizes the grid: `plan` in the source).

`warp_variance_bwd` (K6) is the cotangent of the features: the second entry
of the same source on a CUDA tensor, `warp_variance_bwd_plain` (autograd
through the plain version) on a CPU one. K6 sums in 64-bit fixed point
(`csrc/warp_bwd.cuh`), so two calls on the same inputs agree in every
bit. `warp_variance_train` wraps the pair in one `torch.autograd.Function`;
the projections and depth planes get no gradient (the sampling grid carries
none).

bfloat16 (the bf16 eval path): bf16 feats select K1-bf16, the forward of
`csrc/warp_variance_bf16.cu` (8 channels a lane, one 16-byte gather a
tap; counted in `warp_variance.bf16.launches`, the float32 kernel in
`warp_variance.launches`): the same function over bf16 maps, each
bilinear x weight rounded to bf16, the y weights, Σx and Σx² float32,
the variance rounded to bf16, as the JAX kernel at its default compute
and output dtype bf16. Its plain version samples at K1's own coordinates
(`ops/warp_view.pixel_coords`) with the same weights and sums in K1's
order.

bf16 feats under autograd (the bf16 train path): `warp_variance_train`
runs K1-bf16 and K6-bf16, the backward of `csrc/warp_variance_bf16.cu`
(4 channels a lane; `warp_variance_bwd`, counted in
`warp_variance_bwd.bf16.launches`): bf16 feats and cotangent, each
source tap's contribution bf16(e·wy)·bf16(wx) of the float32 cotangent
e of its sample (JAX `pallas_warp_train.py:180-182,251-253`), the same
fixed-point scatter, dfeats rounded to bf16 once.
`warp_variance_bwd_plain` of bf16 feats spells that out in PyTorch
(float64 sums); `warp_variance_train(..., plain=True)` runs the plain
pair under autograd.

Replaces the TPU kernels `rcmvsnet_tpu/ops/pallas_warp2.py`
`plane_sweep_variance_lanes` (planes mode) and the backward of
`rcmvsnet_tpu/ops/pallas_warp_train.py` `plane_sweep_variance_fused_train`.
The TPU kernels' VMEM residency, band ladder and coverage counter are not
ported: the Hopper kernels sample straight from device memory and have no
such precondition.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from ..core.geometry import relative_projection
from . import _build
from .warp import plane_sweep_variance

CHANNELS = (8, 16, 32)
MAX_VIEWS = 16


def relative_projections(projs: torch.Tensor) -> torch.Tensor:
    """[V, 4, 4] K-folded projections → [V, 16] src @ inv(ref), row 0 the
    identity (the kernel reads the reference view in place)."""
    eye = torch.eye(4, dtype=torch.float32, device=projs.device)[None]
    rel = relative_projection(projs[1:].float(), projs[:1].float())
    return torch.cat([eye, rel]).reshape(-1, 16).contiguous()


def warp_variance_plain(feats: torch.Tensor, projs: torch.Tensor,
                        lo: torch.Tensor, step: torch.Tensor,
                        ndepth: int) -> torch.Tensor:
    """feats [V, h, w, C] (view 0 = reference), projs [V, 4, 4], lo/step
    [h, w] → variance [C, D, h, w] over dv(d) = lo + d·step (bf16 feats:
    a bf16 variance, see the module's note)."""
    if feats.dtype == torch.bfloat16:
        return _warp_variance_plain_bf16(feats, projs, lo, step, ndepth)
    idx = torch.arange(ndepth, dtype=lo.dtype, device=lo.device)
    dv = lo[None] + idx[:, None, None] * step[None]               # [D, h, w]
    V = feats.shape[0]
    var = plane_sweep_variance(
        feats[:1], [feats[v:v + 1] for v in range(1, V)],
        [projs[v:v + 1] for v in range(1, V)], projs[:1], dv[None])
    return var[0].permute(3, 0, 1, 2).contiguous()


def _bilinear_bf16_weights(src: torch.Tensor, px: torch.Tensor,
                           py: torch.Tensor) -> torch.Tensor:
    """src [h, w, C] (float32 values of a bf16 map) sampled at pixel
    coordinates px, py [D, h, w] → [D, h, w, C]: zeros padding per tap,
    tap k's weight bf16(x weight) · (y weight), taps summed 0..3."""
    h, w, C = src.shape
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx, wy = px - x0f, py - y0f
    x0, y0 = x0f.long(), y0f.long()
    flat = src.reshape(h * w, C)
    out = None
    for k in range(4):
        xi, yi = x0 + (k & 1), y0 + (k >> 1)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        wxk = (wx if k & 1 else 1.0 - wx).to(torch.bfloat16).float()
        wgt = wxk * (wy if k >> 1 else 1.0 - wy) * inside
        val = flat[yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        term = wgt[..., None] * val
        out = term if out is None else out + term
    return out


def _warp_variance_plain_bf16(feats, projs, lo, step, ndepth):
    """`warp_variance_plain` for bf16 feats: K1's coordinates, bf16 x
    weights, float32 sums, the variance rounded to bf16."""
    from .warp_view import pixel_coords
    V, h, w, C = feats.shape
    idx = torch.arange(ndepth, dtype=lo.dtype, device=lo.device)
    dv = lo[None] + idx[:, None, None] * step[None]               # [D, h, w]
    rel = relative_projections(projs).reshape(-1, 4, 4)
    f = feats.float()
    inv_v = 1.0 / V
    vol_sum = f[0][None].expand(ndepth, h, w, C)
    vol_sq = vol_sum * vol_sum
    for v in range(1, V):
        px, py = pixel_coords(rel[v:v + 1], dv[None], h, w)
        x = _bilinear_bf16_weights(f[v], px[0], py[0])
        vol_sum = vol_sum + x
        vol_sq = vol_sq + x * x
    mean = vol_sum * inv_v
    var = vol_sq * inv_v - mean * mean
    return var.permute(3, 0, 1, 2).contiguous().to(torch.bfloat16)


def source_taps(projs: torch.Tensor, lo: torch.Tensor, step: torch.Tensor,
                ndepth: int):
    """K1's sample coordinates of each source view: (px, py), each
    [V-1, D, h, w] (`ops/warp_view.pixel_coords`)."""
    from .warp_view import pixel_coords
    h, w = lo.shape
    idx = torch.arange(ndepth, dtype=lo.dtype, device=lo.device)
    dv = lo[None] + idx[:, None, None] * step[None]               # [D, h, w]
    rel = relative_projections(projs).reshape(-1, 4, 4)[1:]
    return pixel_coords(rel, dv[None], h, w)


def scatter_taps_bf16(px: torch.Tensor, py: torch.Tensor,
                      e: torch.Tensor) -> torch.Tensor:
    """The bf16 instances' transposed sample (warp_bwd.cuh): e [D, h, w,
    C'] float32 cotangents of the samples at (px, py) [D, h, w] → [h, w,
    C'] float64 sums, tap k receiving bf16(e·wy_k)·bf16(wx_k) where it
    lies in the image."""
    D, h, w = px.shape
    C = e.shape[-1]
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx, wy = px - x0f, py - y0f
    x0, y0 = x0f.long(), y0f.long()
    rnd = lambda t: t.to(torch.bfloat16).to(torch.float64)
    out = torch.zeros(h * w, C, dtype=torch.float64, device=e.device)
    for k in range(4):
        xi, yi = x0 + (k & 1), y0 + (k >> 1)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        wxk = rnd(wx if k & 1 else 1.0 - wx)
        wyk = wy if k >> 1 else 1.0 - wy
        term = rnd(e * wyk[..., None]) * wxk[..., None]
        out.index_add_(0, (yi * w + xi)[inside], term[inside])
    return out.reshape(h, w, C)


def _warp_variance_bwd_plain_bf16(feats, projs, lo, step, g):
    """`warp_variance_bwd_plain` for bf16 feats: K6's bf16 instance in
    PyTorch (x_v and the mean as the bf16 forward's, e = (2/V)·g·(x_v −
    mean) float32, `scatter_taps_bf16`, the reference view's cotangent
    summed over the planes), rounded to bf16 once."""
    V, h, w, C = feats.shape
    D = g.shape[1]
    px, py = source_taps(projs, lo, step, D)
    f = feats.float()
    xs = [_bilinear_bf16_weights(f[v], px[v - 1], py[v - 1])
          for v in range(1, V)]
    total = f[0][None].expand(D, h, w, C)
    for x in xs:
        total = total + x
    mean = total / V
    gs = (2.0 / V) * g.float().permute(1, 2, 3, 0)            # [D, h, w, C]
    out = [(gs * (f[0][None] - mean)).double().sum(0)]
    out += [scatter_taps_bf16(px[v - 1], py[v - 1], gs * (xs[v - 1] - mean))
            for v in range(1, V)]
    return torch.stack(out).float().to(torch.bfloat16)


def warp_variance_bwd_plain(feats: torch.Tensor, projs: torch.Tensor,
                            lo: torch.Tensor, step: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """Cotangent of feats [V, h, w, C] for the variance cotangent g
    [C, D, h, w]: autograd through `warp_variance_plain` (bf16 feats: the
    bf16 backward, see the module's note)."""
    if feats.dtype == torch.bfloat16:
        return _warp_variance_bwd_plain_bf16(feats, projs, lo, step, g)
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        var = warp_variance_plain(f, projs, lo, step, g.shape[1])
        return torch.autograd.grad(var, f, g)[0]


def _lib(entry="warp_variance_f32", n_ptr=5, source="warp_variance"):
    fn = getattr(_build.load(source), entry)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bwd_scratch(source: str, feats: torch.Tensor) -> torch.Tensor:
    """The scratch a backward entry of `csrc/<source>.cu` takes for feats
    [V, h, w, C] (its fixed-point sums and their quantum), as bytes on
    feats' device; the entry `<source>_bwd_scratch_bytes` sizes it."""
    fn = getattr(_build.load(source), f"{source}_bwd_scratch_bytes")
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    return torch.empty(fn(*feats.shape), dtype=torch.uint8,
                       device=feats.device)


def _check(name, feats, lo, step):
    V, h, w, C = feats.shape
    if C not in CHANNELS or not 1 <= V <= MAX_VIEWS:
        raise ValueError(f"{name}: C in {CHANNELS} and 1 <= V <= "
                         f"{MAX_VIEWS}, got V={V} C={C}")
    if lo.shape != (h, w) or step.shape != (h, w):
        raise ValueError(f"{name}: lo/step must be {(h, w)}")


def warp_variance(feats: torch.Tensor, projs: torch.Tensor,
                  lo: torch.Tensor, step: torch.Tensor,
                  ndepth: int) -> torch.Tensor:
    """Same contract as `warp_variance_plain`; the kernel on a CUDA tensor,
    the instance of feats' element type."""
    if feats.device.type == "cpu":
        return warp_variance_plain(feats, projs, lo, step, ndepth)
    _check("warp_variance", feats, lo, step)
    V, h, w, C = feats.shape
    rel = relative_projections(projs)
    bf16 = feats.dtype == torch.bfloat16
    if bf16:
        _build.require_cuda("warp_variance", rel, lo, step, bf16=(feats,))
    else:
        _build.require_cuda("warp_variance", feats, rel, lo, step)
    out = torch.empty((C, ndepth, h, w), dtype=feats.dtype,
                      device=feats.device)
    err = (_lib("warp_variance_bf16", source="warp_variance_bf16") if bf16
           else _lib())(
        feats.data_ptr(), rel.data_ptr(), lo.data_ptr(), step.data_ptr(),
        out.data_ptr(), V, h, w, C, ndepth, _build.stream_ptr(feats.device))
    _build.check(err, "warp_variance")
    (warp_variance.bf16 if bf16 else warp_variance).launches += 1
    return out


warp_variance.launches = 0
warp_variance.bf16 = SimpleNamespace(launches=0)


def warp_variance_bwd(feats: torch.Tensor, projs: torch.Tensor,
                      lo: torch.Tensor, step: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """Same contract as `warp_variance_bwd_plain`; K6 on a CUDA tensor,
    the instance of feats' element type (g of the same type)."""
    if feats.device.type == "cpu":
        return warp_variance_bwd_plain(feats, projs, lo, step, g)
    _check("warp_variance_bwd", feats, lo, step)
    V, h, w, C = feats.shape
    D = g.shape[1]
    if tuple(g.shape) != (C, D, h, w):
        raise ValueError(f"warp_variance_bwd: g {tuple(g.shape)} is not "
                         f"[{C}, D, {h}, {w}]")
    rel = relative_projections(projs)
    bf16 = feats.dtype == torch.bfloat16
    if bf16:
        _build.require_cuda("warp_variance_bwd", rel, lo, step,
                            bf16=(feats, g))
    else:
        _build.require_cuda("warp_variance_bwd", feats, rel, lo, step, g)
    dsrc = torch.empty_like(feats)
    source = "warp_variance_bf16" if bf16 else "warp_variance"
    scratch = bwd_scratch(source, feats)
    err = _lib("warp_variance_bwd_bf16" if bf16 else "warp_variance_bwd_f32",
               7, source)(
        feats.data_ptr(), rel.data_ptr(), lo.data_ptr(), step.data_ptr(),
        g.data_ptr(), dsrc.data_ptr(), scratch.data_ptr(), V, h, w, C, D,
        _build.stream_ptr(feats.device))
    _build.check(err, "warp_variance_bwd")
    (warp_variance_bwd.bf16 if bf16 else warp_variance_bwd).launches += 1
    return dsrc


warp_variance_bwd.launches = 0
warp_variance_bwd.bf16 = SimpleNamespace(launches=0)


class _WarpVariance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, projs, lo, step, ndepth, plain=False):
        ctx.plain = plain
        ctx.save_for_backward(feats, projs, lo, step)
        fwd = warp_variance_plain if plain else warp_variance
        return fwd(feats, projs, lo, step, ndepth)

    @staticmethod
    def backward(ctx, g):
        feats, projs, lo, step = ctx.saved_tensors
        bwd = warp_variance_bwd_plain if ctx.plain else warp_variance_bwd
        dfeats = bwd(feats, projs, lo, step, g.contiguous())
        return dfeats, None, None, None, None, None


def warp_variance_train(feats: torch.Tensor, projs: torch.Tensor,
                        lo: torch.Tensor, step: torch.Tensor,
                        ndepth: int, plain: bool = False) -> torch.Tensor:
    """`warp_variance` with K6 as its backward (differentiable in feats);
    `plain` runs both plain versions."""
    return _WarpVariance.apply(feats, projs, lo, step, ndepth, plain)
