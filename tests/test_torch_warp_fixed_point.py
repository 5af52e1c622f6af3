"""The accumulation rule of K6 and K7's backward kernels
(`rcmvsnet_tpu_torch/ops/csrc/warp_bwd.cuh`), emulated in plain torch on
the CPU, against the port's plain versions and JAX's gradient.

The kernels cannot run here, so `emulate` repeats what they compute, step
by step: each (plane, pixel) sample's taps from the kernels' coordinates
(`ops/warp_view.pixel_coords`, `warp::project` spelled out), per source view
and reference pixel a run of consecutive planes with one top-left tap whose
weighted cotangents add up in float32, one flush per run that rounds each
tap's sum to an integer number of quanta 2^e, chosen from the inputs'
maxima so that D·h·w samples of the largest cotangent fit in 2^62, and
int64 `index_add_` of the flushes. Each case checks:
  * the emulation against the same rule in float64 (the kernels'
    coordinates, exact sums) to 1e-6 of the largest value: what float32
    runs and the quantum cost (measured ≤ 1.6e-7);
  * against `warp_variance_bwd_plain` / `warp_volume_bwd_plain` to 2e-6:
    the plain versions sample through `grid_sample` at coordinates
    normalized to [-1, 1] and back in float32, an ulp or so off the
    kernels' (tests/test_torch_kernels_gpu.py's K10 note), which moves the
    gradient by up to 1.3e-6 of its largest value at these inputs, JAX
    and the plain versions agreeing to 2e-7 (the float64 rule is as far
    from the plain versions as the float32 one);
  * against jax.grad through the JAX package's plane-sweep variance (as
    tests/test_torch_train_kernels.py does) to 1e-4;
  * that the flushes, added in a shuffled order, give the same integers;
  * ("worst") that every sample of every pixel on one texel, and the bound
    itself (D·h·w samples of the largest cotangent), stay inside int64.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmvsnet_tpu.core.geometry import compose_projection
from rcmvsnet_tpu.data.synthetic import make_synthetic_views
from rcmvsnet_tpu.ops.warp import (homo_warp, plane_sweep_variance,
                                   plane_sweep_variance_no_ref)
from rcmvsnet_tpu_torch.ops import warp_variance as K6
from rcmvsnet_tpu_torch.ops import warp_volume as K7
from rcmvsnet_tpu_torch.ops.warp_view import pixel_coords

torch.set_num_threads(2)
T = torch.from_numpy
H, W, V = 16, 24, 4


def _inputs(C, D, window, seed):
    """Features, images, projections and (lo, step) of the JAX kernel
    tests' synthetic scene; `window`: a narrow window of D planes around a
    noisy depth, as stages 2–3 see it, else the full sweep."""
    s = make_synthetic_views(H=H, W=W, V=V, depth0=600.0, seed=seed,
                             baseline=24.0)
    rs = np.random.RandomState(seed)
    feats = rs.randn(V, H, W, C).astype(np.float32)
    imgs = rs.rand(V, H, W, 3).astype(np.float32)
    pairs = np.zeros((1, V, 2, 4, 4), np.float32)
    for v in range(V):
        pairs[0, v, 0] = s["extrinsics"][v]
        pairs[0, v, 1, :3, :3] = s["intrinsics"]
    projs = np.array(compose_projection(jnp.asarray(pairs)))[0]
    if window:
        step = np.full((H, W), 2.0, np.float32)
        lo = (600.0 + 8.0 * rs.randn(H, W) - D / 2 * step).astype(np.float32)
    else:
        lo = np.full((H, W), s["depth_min"], np.float32)
        step = np.full((H, W), (s["depth_max"] - s["depth_min"]) / (D - 1),
                       np.float32)
    return feats, imgs, projs, lo, step


def _quantum(bound):
    """(to_q, from_q) = (2^-e, 2^e) with bound <= 2^62 * 2^e, as
    warp_bwd.cuh's quantum_for (bound finite and > 0 here)."""
    _, k = math.frexp(bound)
    return math.ldexp(1.0, 62 - k), math.ldexp(1.0, k - 62)


def emulate(feats, rel, lo, step, cots, shuffle=None, dtype=torch.float32):
    """K6 (cots = (g,)) or K7's backward (cots = (g_var, g_nr, g_img)) as
    the kernels compute them (`dtype` float64: the same rule with exact
    sums). Returns the cotangents (dfeats and, for K7, dimgs), the int64
    quanta per scatter target, and the number of samples and flushes per
    source view."""
    feats = feats.to(dtype)
    cots = tuple(c.to(dtype) for c in cots)
    Vn, h, w, C = feats.shape
    D = cots[0].shape[1]
    HW, nv = h * w, Vn - 1
    k7 = len(cots) == 3
    d = torch.arange(D, dtype=torch.float32)
    dv = lo[None] + d[:, None, None] * step[None]                 # [D,h,w]
    px, py = (c.to(dtype) for c in pixel_coords(rel[1:].reshape(-1, 4, 4),
                                                 dv[None], h, w))
    x0f, y0f = px.floor(), py.floor()
    wx, wy = (px - x0f).reshape(nv, D, HW), (py - y0f).reshape(nv, D, HW)
    x0 = x0f.long().reshape(nv, D, HW)
    y0 = y0f.long().reshape(nv, D, HW)
    wts = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                       wx * wy], -1)                          # [nv,D,HW,4]
    src = feats.reshape(Vn, HW, C)

    def tap_index(xs, ys, k):
        xi, yi = xs + (k & 1), ys + (k >> 1)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1), inside

    x = torch.zeros(nv, D, HW, C, dtype=dtype)
    for v in range(nv):
        for k in range(4):
            p, inside = tap_index(x0[v], y0[v], k)
            x[v] = x[v] + wts[v, :, :, k, None] * (src[v + 1][p]
                                                    * inside[..., None])
    ref = src[0][None]                                        # [1, HW, C]
    cm = lambda g: g.reshape(g.shape[0], D, HW).permute(1, 2, 0)
    scale = 2.0 / Vn
    if k7:
        gv, gn = cm(cots[0]) * scale, cm(cots[1]) * scale
        gi = cm(cots[2]).reshape(D, HW, nv, 3).permute(2, 0, 1, 3)
        m, m_nr = (x.sum(0) + ref) / Vn, x.sum(0) / Vn
        cot = gv * (x - m) + gn * (x - m_nr)
        dref = (gv * (ref - m)).sum(0)
        targets = [(cot, C), (gi, 3)]
        maxima = [float(feats.abs().max()),
                  float(cots[0].abs().max()) + float(cots[1].abs().max()),
                  float(cots[2].abs().max())]
        bounds = [D * HW * scale * maxima[1] * 2 * maxima[0],
                  D * HW * maxima[2]]
    else:
        g = cm(cots[0]) * scale
        mean = (x.sum(0) + ref) / Vn
        cot = g * (x - mean)
        dref = (g * (ref - mean)).sum(0)
        targets = [(cot, C)]
        bounds = [D * HW * scale * float(cots[0].abs().max()) * 2
                  * float(feats.abs().max())]

    # runs of consecutive planes with one top-left tap, per (view, pixel)
    new = torch.ones(nv, D, HW, dtype=torch.bool)
    new[:, 1:] = (x0[:, 1:] != x0[:, :-1]) | (y0[:, 1:] != y0[:, :-1])
    run = new.long().cumsum(1) - 1                            # [nv, D, HW]
    outs, quanta = [], []
    for vals, nc in targets:
        to_q, from_q = _quantum(bounds[len(quanta)])
        # float32 sums per (view, pixel, run, tap), planes in order
        acc = torch.zeros(nv, D, HW, 4, nc, dtype=dtype)
        for dd in range(D):
            r = run[:, dd]
            acc.scatter_add_(1, r[:, None, :, None, None].expand(
                nv, 1, HW, 4, nc), (wts[:, dd, :, :, None]
                                    * vals[:, dd, :, None, :])[:, None])
        starts = new.nonzero(as_tuple=True)                   # run starts
        fv, fp = starts[0], starts[2]
        fr = run[starts]
        idx, q = [], []
        for k in range(4):
            p, inside = tap_index(x0[starts], y0[starts], k)
            sums = acc[fv, fr, fp, k].double()                # [flushes, nc]
            idx.append((fv * HW + p)[inside])
            q.append(torch.round(sums * to_q).long()[inside])
        idx, q = torch.cat(idx), torch.cat(q)
        if shuffle is not None:
            perm = torch.randperm(len(idx), generator=shuffle)
            idx, q = idx[perm], q[perm]
        total = torch.zeros(nv * HW, nc, dtype=torch.int64)
        total.index_add_(0, idx, q)
        quanta.append(total)
        outs.append((total.double() * from_q).to(dtype).reshape(nv, h, w,
                                                                  nc))
    dfeat = torch.cat([dref.reshape(1, h, w, C), outs[0]])
    grads = (dfeat,)
    if k7:
        grads += (torch.cat([torch.zeros(1, h, w, 3, dtype=dtype),
                             outs[1]]),)
    return grads, quanta, D * HW, int(new.sum()) / nv


def _jax_grads(kind, feats, imgs, projs, dv, cots):
    """jax.grad of Σ output · cotangent through the JAX package's XLA
    warp + variance (K7: + no-ref variance + warped images)."""
    src = lambda f: [f[v][None] for v in range(1, V)]
    prj = [jnp.asarray(projs[v])[None] for v in range(1, V)]
    ref_p = jnp.asarray(projs[0])[None]
    jdv = jnp.asarray(dv)[None]
    cl = [jnp.asarray(np.transpose(c.numpy(), (1, 2, 3, 0))) for c in cots]

    def var(f):
        return plane_sweep_variance(f[0][None], src(f), prj, ref_p, jdv)[0]

    if kind == "k6":
        return (np.asarray(jax.grad(lambda f: jnp.sum(var(f)[0] * cl[0]))(
            jnp.asarray(feats))),)

    def loss(f, im):
        nr = plane_sweep_variance_no_ref(
            [homo_warp(s, p, ref_p, jdv) for s, p in zip(src(f), prj)])
        wimg = jnp.concatenate([homo_warp(im[v][None], prj[v - 1], ref_p,
                                          jdv) for v in range(1, V)], -1)
        return (jnp.sum(var(f)[0] * cl[0]) + jnp.sum(nr[0] * cl[1])
                + jnp.sum(wimg[0] * cl[2]))
    return tuple(np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(imgs)))


def _rel_err(got, want):
    want = torch.as_tensor(np.asarray(want)).double()
    return float((got.double() - want).abs().max()) / float(
        want.abs().max())


@pytest.mark.parametrize("kind,C,D,window", [
    ("k6", 8, 8, True), ("k6", 16, 16, True), ("k6", 32, 16, False),
    ("k7", 16, 12, True), ("k7", 8, 16, False), ("worst", 8, 16, False)])
def test_fixed_point_scatter_matches_plain_and_jax(kind, C, D, window):
    feats, imgs, projs, lo, step = _inputs(C, D, window, seed=C + D)
    rs = np.random.RandomState(D)
    nch = (C, C, 3 * (V - 1)) if kind == "k7" else (C,)
    cots = tuple(T(rs.randn(c, D, H, W).astype(np.float32)) for c in nch)
    rel = K6.relative_projections(T(projs))
    if kind == "worst":
        # every sample of every pixel lands on texel (3, 2) with weight 1:
        # no rotation, p = t = (3, 2, 1); the source views agree and the
        # reference is their negative, each cotangent of one sign
        rel[1:] = torch.tensor([0, 0, 0, 3.0, 0, 0, 0, 2.0, 0, 0, 0, 1.0,
                                0, 0, 0, 1.0])
        feats[1:], feats[0] = 1.0, -1.0
        cots = (cots[0].abs(),)
    args = (T(feats), T(projs), T(lo), T(step))
    shuffle = torch.Generator().manual_seed(7)
    grads, quanta, samples, flushes = emulate(T(feats), rel, T(lo), T(step),
                                              cots)
    _, again, _, _ = emulate(T(feats), rel, T(lo), T(step), cots, shuffle)
    assert all(torch.equal(a, b) for a, b in zip(quanta, again))

    if kind == "worst":
        g = cots[0]
        m = 2.0 / V * float(g.abs().max()) * 2 * float(np.abs(feats).max())
        to_q, _ = _quantum(D * H * W * m)
        per_sample = round(m * to_q)
        assert D * H * W * per_sample <= 2 ** 62             # the bound
        cot = 2.0 / V * g.double() * 2.0 / V                 # x_v − mean
        exact = int(round(float(cot.sum()) * to_q))
        got = int(quanta[0].reshape(V - 1, H, W, C)[0, 2, 3].sum())
        assert abs(got - exact) <= 1e-6 * exact      # float32 run sums
        assert 0 < got <= 2 ** 62                    # no wrap-around
        assert flushes == H * W                               # one run each
        return

    dv = np.asarray(lo)[None] + np.arange(D, dtype=np.float32)[:, None,
                                                                None] * step
    if kind == "k6":
        plain = (K6.warp_variance_bwd_plain(*args, cots[0]),)
    else:
        plain = K7.warp_volume_bwd_plain(  # vol's cotangent: g_img, g_nr
            T(feats), T(imgs), T(projs), T(lo), T(step), cots[0],
            torch.cat([cots[2], cots[1]]))
    want = _jax_grads(kind, feats, imgs, projs, dv, cots)
    exact, _, _, _ = emulate(T(feats), rel, T(lo), T(step), cots,
                             dtype=torch.float64)
    for got, e, p, j in zip(grads, exact, plain, want):
        assert _rel_err(got, e) <= 1e-6
        assert _rel_err(got, p) <= 2e-6
        assert _rel_err(got, j) <= 1e-4
    # several planes share a top-left tap in a narrow window
    assert samples / flushes > (2.0 if window else 1.0)
