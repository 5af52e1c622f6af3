"""K7: the stage-1 train volume — all-view variance, no-ref variance and
warped source images in one sweep — and its backward.

`warp_volume` launches the CUDA kernel `csrc/warp_volume.cu` (bf16:
`csrc/warp_volume_bf16.cu`) for a CUDA tensor; for a CPU tensor it
returns `warp_volume_plain` (`ops/warp.py`'s `homo_warp`, variance and
`plane_sweep_variance_no_ref`, the composition the JAX cascade runs when
the kernel is off). Both return (var, vol): the variance [C, D, h, w] the
U-Net reads, and the render branch's volume_feature [3(V−1) + C, D, h, w]
(warped source images, view-major, then the no-ref variance), which the
kernel writes in place, so the cascade neither concatenates nor stacks
it. The float32 kernel shares K1's block skeleton (`csrc/warp_fwd.cuh`: a
group of C/4 lanes per pixel, the plane loop in the block).
`warp_volume_bwd` is the backward (the second entry of the same source,
deterministic like K6's, or autograd through the plain version); it takes
vol's cotangent whole and hands the kernel its two row slices.
`warp_volume_train` wraps both in one `torch.autograd.Function`,
differentiable in the features and the images.

bfloat16 (the bf16 train path, the JAX kernel at compute and output
dtype bf16): bf16 feats and images select the bf16 pair of
`csrc/warp_volume_bf16.cu` (counted in `warp_volume.bf16.launches` and
`warp_volume_bwd.bf16.launches`; K1-bf16's and K6-bf16's pieces,
`csrc/warp_bf16.cuh`). The forward, K7-bf16 (8 channels a lane, 16-byte
gathers, shared projections one plane ahead, bf16 staging and 16-byte
stores), samples features and images with bf16 x weights (K1-bf16's
rule), sums in float32 and writes var and vol in bf16; it reads the
images from a [V, h, w, 4] copy (`images4`: one 8-byte load a tap), which
the wrapper makes. The backward (4 channels a lane, shared projections,
the image cotangent in the lane that projects its view) takes bf16
cotangents, rounds each tap's contribution as K6-bf16 does and writes
bf16 dfeats and dimgs. Their plain versions spell the same out in PyTorch
(`warp_volume_plain` / `warp_volume_bwd_plain` of bf16 feats);
`warp_volume_train(..., plain=True)` runs the plain pair under autograd.

Replaces the TPU kernel `rcmvsnet_tpu/ops/pallas_warp_volume.py`
`plane_sweep_volume_fused_train` (forward and backward); as for K1, the
band ladder and coverage counter are not ported.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from . import _build
from .warp import homo_warp, plane_sweep_variance_no_ref
from .warp_variance import (CHANNELS, MAX_VIEWS, _bilinear_bf16_weights,
                            bwd_scratch, relative_projections,
                            scatter_taps_bf16, source_taps,
                            warp_variance_plain)


def _samples_bf16(feats, imgs, projs, lo, step, ndepth):
    """The bf16 sweep's samples: (px, py) [V-1, D, h, w] and, per source
    view, its features [D, h, w, C] and RGB [D, h, w, 3] (float32 values
    of bf16 maps, bf16 x weights)."""
    px, py = source_taps(projs, lo, step, ndepth)
    f, im = feats.float(), imgs.float()
    V = feats.shape[0]
    xs = [_bilinear_bf16_weights(f[v], px[v - 1], py[v - 1])
          for v in range(1, V)]
    rgb = [_bilinear_bf16_weights(im[v], px[v - 1], py[v - 1])
           for v in range(1, V)]
    return px, py, xs, rgb


def _warp_volume_plain_bf16(feats, imgs, projs, lo, step, ndepth):
    """`warp_volume_plain` for bf16 feats and imgs: the bf16 sweep's
    samples, K7's sums (source views, then the reference for var), each
    output rounded to bf16."""
    V = feats.shape[0]
    _, _, xs, rgb = _samples_bf16(feats, imgs, projs, lo, step, ndepth)
    ref = feats[0].float()[None]
    s, q = xs[0], xs[0] * xs[0]
    for x in xs[1:]:
        s, q = s + x, q + x * x
    m_nr, m = s / V, (s + ref) / V
    var_nr = q / V - m_nr * m_nr
    var = (q + ref * ref) / V - m * m
    vol = torch.cat(rgb + [var_nr], dim=-1)                 # [D, h, w, ·]
    out = lambda t: t.permute(3, 0, 1, 2).contiguous().to(torch.bfloat16)
    return out(var), out(vol)


def warp_volume_plain(feats: torch.Tensor, imgs: torch.Tensor,
                      projs: torch.Tensor, lo: torch.Tensor,
                      step: torch.Tensor, ndepth: int):
    """feats [V, h, w, C], imgs [V, h, w, 3] (view 0 = reference), projs
    [V, 4, 4], lo/step [h, w] → (variance [C, D, h, w], vol
    [3 (V−1) + C, D, h, w]: the warped source images, view-major, then the
    no-ref variance). bf16 feats and imgs: bf16 outputs (see the module
    doc)."""
    if feats.dtype == torch.bfloat16:
        return _warp_volume_plain_bf16(feats, imgs, projs, lo, step, ndepth)
    idx = torch.arange(ndepth, dtype=lo.dtype, device=lo.device)
    dv = (lo[None] + idx[:, None, None] * step[None])[None]   # [1, D, h, w]
    V = feats.shape[0]
    ref_p = projs[:1]
    warp = lambda x, v: homo_warp(x[v:v + 1], projs[v:v + 1], ref_p, dv)
    var_nr = plane_sweep_variance_no_ref([warp(feats, v)
                                          for v in range(1, V)])
    wimg = [warp(imgs, v) for v in range(1, V)]
    vol = torch.cat(wimg + [var_nr], dim=-1)[0]             # [D, h, w, ·]
    return (warp_variance_plain(feats, projs, lo, step, ndepth),
            vol.permute(3, 0, 1, 2).contiguous())


def _warp_volume_bwd_plain_bf16(feats, imgs, projs, lo, step, g_var, g_vol):
    """`warp_volume_bwd_plain` for bf16 inputs: K7's bf16 backward in
    PyTorch (e = (2/V)·(g_var·(x_v − mean) + g_nr·(x_v − mean_nr)) float32,
    the image cotangent as it is, `scatter_taps_bf16`; the reference's
    cotangent summed over the planes), rounded to bf16 once."""
    V, h, w, C = feats.shape
    D = g_var.shape[1]
    px, py, xs, _ = _samples_bf16(feats, imgs, projs, lo, step, D)
    ref = feats[0].float()[None]
    s = xs[0]
    for x in xs[1:]:
        s = s + x
    m, m_nr = (s + ref) / V, s / V
    nv = 3 * (V - 1)
    cot = lambda t: t.float().permute(1, 2, 3, 0)             # [D, h, w, ·]
    gv, gn = (2.0 / V) * cot(g_var), (2.0 / V) * cot(g_vol[nv:])
    gi = cot(g_vol[:nv])
    dfeat = [(gv * (ref - m)).double().sum(0)]
    dimg = [torch.zeros(h, w, 3, dtype=torch.float64, device=feats.device)]
    for v in range(1, V):
        e = gv * (xs[v - 1] - m) + gn * (xs[v - 1] - m_nr)
        dfeat.append(scatter_taps_bf16(px[v - 1], py[v - 1], e))
        dimg.append(scatter_taps_bf16(px[v - 1], py[v - 1],
                                      gi[..., 3 * (v - 1):3 * v]))
    bf = lambda t: torch.stack(t).float().to(torch.bfloat16)
    return bf(dfeat), bf(dimg)


def warp_volume_bwd_plain(feats, imgs, projs, lo, step, g_var, g_vol):
    """Cotangents of (feats, imgs) for the output cotangents (g_var,
    g_vol): autograd through `warp_volume_plain` (bf16 inputs: the bf16
    backward, see the module doc)."""
    if feats.dtype == torch.bfloat16:
        return _warp_volume_bwd_plain_bf16(feats, imgs, projs, lo, step,
                                           g_var, g_vol)
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        im = imgs.detach().requires_grad_(True)
        outs = warp_volume_plain(f, im, projs, lo, step, g_var.shape[1])
        return torch.autograd.grad(outs, (f, im), (g_var, g_vol))


def _lib(entry, n_ptr, source="warp_volume"):
    fn = getattr(_build.load(source), entry)
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, feats, imgs, lo, step):
    V, h, w, C = feats.shape
    if C not in CHANNELS or not 2 <= V <= MAX_VIEWS:
        raise ValueError(f"{name}: C in {CHANNELS} and 2 <= V <= "
                         f"{MAX_VIEWS}, got V={V} C={C}")
    if tuple(imgs.shape) != (V, h, w, 3):
        raise ValueError(f"{name}: imgs {tuple(imgs.shape)} != "
                         f"{(V, h, w, 3)}")
    if lo.shape != (h, w) or step.shape != (h, w):
        raise ValueError(f"{name}: lo/step must be {(h, w)}")


def images4(imgs: torch.Tensor) -> torch.Tensor:
    """imgs [V, h, w, 3] as the [V, h, w, 4] copy K7-bf16 samples (one
    8-byte load a tap); channel 3 is left unset and never read into an
    output."""
    out = imgs.new_empty((*imgs.shape[:-1], 4))
    out[..., :3] = imgs
    return out


def warp_volume(feats: torch.Tensor, imgs: torch.Tensor,
                projs: torch.Tensor, lo: torch.Tensor, step: torch.Tensor,
                ndepth: int):
    """Same contract as `warp_volume_plain`; the kernel on a CUDA tensor,
    the instance of feats' element type (imgs of the same type)."""
    if feats.device.type == "cpu":
        return warp_volume_plain(feats, imgs, projs, lo, step, ndepth)
    _check("warp_volume", feats, imgs, lo, step)
    V, h, w, C = feats.shape
    rel = relative_projections(projs)
    bf16 = feats.dtype == torch.bfloat16
    if bf16:
        _build.require_cuda("warp_volume", rel, lo, step, bf16=(feats, imgs))
    else:
        _build.require_cuda("warp_volume", feats, imgs, rel, lo, step)
    new = lambda c: torch.empty((c, ndepth, h, w), dtype=feats.dtype,
                                device=feats.device)
    var, vol = new(C), new(3 * (V - 1) + C)
    if bf16:
        imgs = images4(imgs)
    err = _lib("warp_volume_bf16" if bf16 else "warp_volume_f32", 7,
               "warp_volume_bf16" if bf16 else "warp_volume")(
        feats.data_ptr(), imgs.data_ptr(), rel.data_ptr(), lo.data_ptr(),
        step.data_ptr(), var.data_ptr(), vol.data_ptr(), V, h, w, C, ndepth,
        _build.stream_ptr(feats.device))
    _build.check(err, "warp_volume")
    (warp_volume.bf16 if bf16 else warp_volume).launches += 1
    return var, vol


warp_volume.launches = 0
warp_volume.bf16 = SimpleNamespace(launches=0)


def warp_volume_bwd(feats, imgs, projs, lo, step, g_var, g_vol):
    """Same contract as `warp_volume_bwd_plain`; the kernel on a CUDA
    tensor, the instance of feats' element type (imgs and the cotangents
    of the same type). Returns (dfeats [V, h, w, C], dimgs [V, h, w,
    3])."""
    if feats.device.type == "cpu":
        return warp_volume_bwd_plain(feats, imgs, projs, lo, step, g_var,
                                     g_vol)
    _check("warp_volume_bwd", feats, imgs, lo, step)
    V, h, w, C = feats.shape
    D = g_var.shape[1]
    want = {"g_var": (C, D, h, w), "g_vol": (3 * (V - 1) + C, D, h, w)}
    for name, t in (("g_var", g_var), ("g_vol", g_vol)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"warp_volume_bwd: {name} {tuple(t.shape)} "
                             f"!= {want[name]}")
    rel = relative_projections(projs)
    bf16 = feats.dtype == torch.bfloat16
    if bf16:
        _build.require_cuda("warp_volume_bwd", rel, lo, step,
                            bf16=(feats, imgs, g_var, g_vol))
    else:
        _build.require_cuda("warp_volume_bwd", feats, rel, lo, step, g_var,
                            g_vol)
    g_img, g_nr = g_vol[:3 * (V - 1)], g_vol[3 * (V - 1):]   # row slices
    dfeat = torch.empty_like(feats)
    dimg = torch.empty((V, h, w, 3), dtype=feats.dtype, device=feats.device)
    source = "warp_volume_bf16" if bf16 else "warp_volume"
    scratch = bwd_scratch(source, feats)
    err = _lib("warp_volume_bwd_bf16" if bf16 else "warp_volume_bwd_f32",
               10, source)(
        feats.data_ptr(), rel.data_ptr(), lo.data_ptr(), step.data_ptr(),
        g_var.data_ptr(), g_nr.data_ptr(), g_img.data_ptr(),
        dfeat.data_ptr(), dimg.data_ptr(), scratch.data_ptr(), V, h, w, C,
        D, _build.stream_ptr(feats.device))
    _build.check(err, "warp_volume_bwd")
    (warp_volume_bwd.bf16 if bf16 else warp_volume_bwd).launches += 1
    return dfeat, dimg


warp_volume_bwd.launches = 0
warp_volume_bwd.bf16 = SimpleNamespace(launches=0)


class _WarpVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, imgs, projs, lo, step, ndepth, plain=False):
        ctx.plain = plain
        ctx.save_for_backward(feats, imgs, projs, lo, step)
        fwd = warp_volume_plain if plain else warp_volume
        return fwd(feats, imgs, projs, lo, step, ndepth)

    @staticmethod
    def backward(ctx, g_var, g_vol):
        feats, imgs, projs, lo, step = ctx.saved_tensors
        bwd = warp_volume_bwd_plain if ctx.plain else warp_volume_bwd
        dfeat, dimg = bwd(feats, imgs, projs, lo, step, g_var.contiguous(),
                          g_vol.contiguous())
        return dfeat, dimg, None, None, None, None, None


def warp_volume_train(feats: torch.Tensor, imgs: torch.Tensor,
                      projs: torch.Tensor, lo: torch.Tensor,
                      step: torch.Tensor, ndepth: int, plain: bool = False):
    """`warp_volume` with its kernel backward (differentiable in feats and
    imgs); `plain` runs both plain versions."""
    return _WarpVolume.apply(feats, imgs, projs, lo, step, ndepth, plain)
