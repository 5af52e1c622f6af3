"""The tensor-core decomposition of K2 (`ops/csrc/conv3d.cu`) and K8's
weight gradient (`ops/csrc/conv3d_dw.cu`), checked on the CPU.

CUDA cannot run here, so these tests hold what the kernels compute, in
plain numpy/torch, against the plain versions:
  * the transposed conv as 8 parity classes (`T2_TAPS`), forward and
    weight gradient, equals `conv3d_plain` / `conv3d_dw_plain`;
  * the dw kernel's split-K brick plan (`conv3d_train.dw_chunks`, walked
    as the kernel walks it) covers every output position exactly once, at
    the train and eval shapes, from shapes alone;
  * 3xTF32 (TF32 emulated by bit masking) stays within 1e-6 of the
    largest value of a float64 conv; one-pass TF32 does not stay within
    1e-4 — the precision choice;
  * an emulation of both kernels at their own shared-memory addressing
    (halo bricks with zero fill, the stride-2 parity halves, the padded
    channel strides, the weight chunk [tap][ci][co], the tile that
    `conv3d.tile` picks, the dw plan's runs and per-run partials) equals
    the plain versions.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rcmvsnet_tpu_torch.ops import conv3d as K2
from rcmvsnet_tpu_torch.ops import conv3d_train as K8

# "t2" per axis: output 2i + p reads input i + offset with tap k, as
# (k, offset) pairs for p = 0 and p = 1 (27 taps over the 8 classes), as
# csrc/tc_conv3d.cuh's t2_tap gives them
T2_TAPS = {0: ((1, 0),), 1: ((0, 1), (2, 0))}


def brick_origins(plan, chunk):
    """[k, 4] (sample, z0, y0, x0) of the bricks of one run of a dw plan,
    in the order the kernel walks them (x fastest)."""
    b = np.arange(chunk * plan.per_chunk,
                  min((chunk + 1) * plan.per_chunk, plan.bricks))
    nbz, nby, nbx = plan.grid
    bz, by, bx = plan.brick
    return np.stack([b // (nbx * nby * nbz), (b // (nbx * nby)) % nbz * bz,
                     (b // nbx) % nby * by, b % nbx * bx], -1)


# (D, H, W) of the inputs of every 3D conv on the main paths: the eval
# CostRegNets (864x1152, D 48/32/8; T&T 1056x1920), the train CostRegNets
# (512x640, D 48/32/8) and the render U-Net (128 planes at 128x160)
EVAL_SHAPES = ((48, 216, 288), (32, 432, 576), (8, 864, 1152),
               (8, 1056, 1920))
TRAIN_SHAPES = ((48, 128, 160), (32, 256, 320), (8, 512, 640),
                (128, 128, 160))


def _trunk_inputs(d, h, w):
    """(mode, input dhw) of the U-Net's convs from an input of (d, h, w)."""
    out, cur = [], (d, h, w)
    for _, mode in (("conv0", "s1"), ("conv1", "s2"), ("conv2", "s1"),
                    ("conv3", "s2"), ("conv4", "s1"), ("conv5", "s2"),
                    ("conv6", "s1"), ("conv7", "t2"), ("conv9", "t2"),
                    ("conv11", "t2")):
        out.append((mode, cur))
        cur = K2.out_shape(mode, *cur)
    return out


# ---------------------------------------------------------------- t2 split

def t2_by_classes(x, w):
    """The transposed conv (k3 s2 p1, output_padding 1) as 8 dense parity
    classes: output 2i + p, per axis, reads input i + offset with tap k,
    for (k, offset) in T2_TAPS[p]. x [N, Ci, D, H, W]; w [Ci, Co, 3,3,3]."""
    N, _, D, H, W = x.shape
    xp = F.pad(x, (0, 1) * 3)
    out = x.new_zeros(N, w.shape[1], 2 * D, 2 * H, 2 * W)
    for cls in range(8):
        pz, py, px = cls >> 2, (cls >> 1) & 1, cls & 1
        acc = 0
        for kz, oz in T2_TAPS[pz]:
            for ky, oy in T2_TAPS[py]:
                for kx, ox in T2_TAPS[px]:
                    acc = acc + torch.einsum(
                        "ncdhw,co->nodhw",
                        xp[:, :, oz:oz + D, oy:oy + H, ox:ox + W],
                        w[:, :, kz, ky, kx])
        out[:, :, pz::2, py::2, px::2] = acc
    return out


def t2_dw_by_classes(x, g):
    """dW [Ci, Co, 3, 3, 3] of the transposed conv by parity classes:
    each tap belongs to one class and reads its outputs 2i + p."""
    N, Ci, D, H, W = x.shape
    xp = F.pad(x, (0, 1) * 3)
    dw = x.new_zeros(Ci, g.shape[1], 3, 3, 3)
    for cls in range(8):
        pz, py, px = cls >> 2, (cls >> 1) & 1, cls & 1
        gc = g[:, :, pz::2, py::2, px::2]
        for kz, oz in T2_TAPS[pz]:
            for ky, oy in T2_TAPS[py]:
                for kx, ox in T2_TAPS[px]:
                    dw[:, :, kz, ky, kx] = torch.einsum(
                        "ncdhw,nodhw->co",
                        xp[:, :, oz:oz + D, oy:oy + H, ox:ox + W], gc)
    return dw


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(4, 6, 8), (5, 9, 7), (3, 5, 6)])
def test_t2_parity_classes_match_plain(shape):
    ci, co = 8, 16
    x = _rand((2, ci, *shape), 0)
    w = _rand((ci, co, 3, 3, 3), 1)
    want = K2.conv3d_plain(x, w, None, "t2", relu=False)
    got = t2_by_classes(x, w)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("shape", [(4, 6, 8), (5, 9, 7), (3, 5, 6)])
def test_t2_dw_parity_classes_match_plain(shape):
    ci, co = 8, 16
    x = _rand((2, ci, *shape), 2)
    g = _rand((2, co, *(2 * n for n in shape)), 3)
    want = K8.conv3d_dw_plain(x, g, "t2")
    got = t2_dw_by_classes(x, g)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# ---------------------------------------------------------------- dw plan

@pytest.mark.parametrize("net", ["eval", "train"])
def test_dw_plan_covers_every_position_once(net):
    """Every (sample, output position) of every conv of the U-Nets at the
    main paths' shapes lies in exactly one brick of one run (t2: one base
    position per parity class), from the plan alone."""
    shapes = EVAL_SHAPES if net == "eval" else TRAIN_SHAPES
    n = 1
    for d, h, w in shapes:
        for mode, (di, hi, wi) in _trunk_inputs(d, h, w):
            plan = K8.dw_chunks(mode, n, 16, di, hi, wi)
            base = (di, hi, wi) if mode == "t2" else K2.out_shape(
                mode, di, hi, wi)
            count = np.zeros((n, *base), np.int32)
            assert (plan.chunks - 1) * plan.per_chunk < plan.bricks \
                <= plan.chunks * plan.per_chunk
            for c in range(plan.chunks):
                o = brick_origins(plan, c)
                assert len(o) >= 1
                for s, z, y, x in o:
                    bz, by, bx = plan.brick
                    count[s, z:z + bz, y:y + by, x:x + bx] += 1
            assert count.min() == 1 and count.max() == 1, (mode, base)


def test_dw_plan_targets_the_card():
    """About TARGET_BLOCKS blocks where the positions allow; the partials
    of the largest train call stay small."""
    p = K8.dw_chunks("s1", 1, 41, 128, 128, 160)      # render conv0
    blocks = p.chunks * p.ci_chunks * p.classes
    assert K8.TARGET_BLOCKS <= blocks < K8.TARGET_BLOCKS + p.ci_chunks * 8
    assert p.chunks * 8 * 41 * 27 * 4 < 8 << 20
    p = K8.dw_chunks("s1", 1, 64, 6, 16, 20)          # conv6 at stage 1
    assert p.chunks == p.bricks == 6 * 2 * 2


# ---------------------------------------------------------------- 3xTF32

def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as cvt.rna does: to nearest on the 10-bit
    mantissa, ties away from zero (bit masking of the magnitude)."""
    b = a.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split3(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def test_tf32_rounding_is_cvt_rna():
    a = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0 + 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 3.0])
    assert torch.equal(tf32(a), want)
    hi, lo = split3(torch.tensor([1.0 + 2 ** -20], dtype=torch.float32))
    assert float(hi) == 1.0 and float(lo) == 2 ** -20


@pytest.mark.parametrize("ci,co", [(8, 8), (16, 32), (41, 8), (64, 64)])
def test_3xtf32_meets_the_gate_and_one_pass_does_not(ci, co):
    x = _rand((1, ci, 6, 8, 10), ci)
    w = _rand((co, ci, 3, 3, 3), co) * 0.1
    d = lambda t: t.double()
    exact = F.conv3d(d(x), d(w), padding=1)
    (xh, xl), (wh, wl) = split3(x), split3(w)
    three = (F.conv3d(d(xl), d(wh), padding=1)
             + F.conv3d(d(xh), d(wl), padding=1)
             + F.conv3d(d(xh), d(wh), padding=1))
    one = F.conv3d(d(xh), d(wh), padding=1)
    scale = float(exact.abs().max())
    assert float((three - exact).abs().max()) <= 1e-6 * scale
    assert float((one - exact).abs().max()) > 1e-4 * scale


# ------------------------------------------- the kernels' own addressing

def _pad_to(n, r):
    return n + ((r - n % 32) + 32) % 32


def _halo(m, bz, by):
    """(EZ, EY, EX, XS) of tc_conv3d.cuh's Halo: s1 rows hold 6 16-byte
    vectors (inputs bx0 - 4 .. bx0 + 19), t2 rows 5, s2 rows two parity
    halves of 17."""
    ez, ey, ex = ((bz + 2, by + 2, 18), (2 * bz + 1, 2 * by + 1, 33),
                  (bz + 1, by + 1, 17))[m]
    xs = (24, 34, 20)[m]
    # every staged column lies inside its own row (rows do not overlap)
    assert _xcol(m, ex - 1) < xs and (m == 1 or (ex + 3 * (m == 0)) <= xs)
    return ez, ey, ex, xs


def _xcol(m, rx):
    return (rx & 1) * 17 + (rx >> 1) if m == 1 else rx + 3 if m == 0 else rx


def _origin(m, b0):
    return (b0 - 1, 2 * b0 - 1, b0)[m]


def _stage_halo(x, n, c0, m, bz, by, b0, ps):
    """load_halo: 8 channel planes of stride ps, zero outside."""
    ez, ey, ex, xs = _halo(m, bz, by)
    C, Di, Hi, Wi = x.shape[1:]
    rz, ry, rx = np.meshgrid(np.arange(ez), np.arange(ey), np.arange(ex),
                             indexing="ij")
    gz, gy, gx = (_origin(m, b) + r for b, r in zip(b0, (rz, ry, rx)))
    ok = (gz >= 0) & (gz < Di) & (gy >= 0) & (gy < Hi) & (gx >= 0) & (gx < Wi)
    s = np.zeros(8 * ps)
    for c in range(min(8, C - c0)):
        v = x[n, c0 + c, gz.clip(0, Di - 1), gy.clip(0, Hi - 1),
              gx.clip(0, Wi - 1)]
        s[c * ps + (rz * ey + ry) * xs + _xcol(m, rx)] = np.where(ok, v, 0)
    return s


def _mm3(a, b):
    """3xTF32 product in float64: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    (ah, al), (bh, bl) = (
        (t.double().numpy() for t in split3(torch.from_numpy(
            np.ascontiguousarray(v, np.float32)))) for v in (a, b))
    return al @ bh + ah @ bl + ah @ bh


def _t2_taps(cls):
    pz, py, px = cls >> 2, (cls >> 1) & 1, cls & 1
    return [(kz * 9 + ky * 3 + kx, (oz, oy, ox))
            for kz, oz in T2_TAPS[pz] for ky, oy in T2_TAPS[py]
            for kx, ox in T2_TAPS[px]]


def emulate_conv3d(x, w27, mode, out_dhw=None):
    """conv3d.cu block by block: x [N, Ci, D, H, W] float32 numpy, w27
    [Co, Ci, 27] as the wrapper hands it; returns the raw conv."""
    m = K2.MODES[mode]
    N, Ci, D, H, W = x.shape
    Co = w27.shape[0]
    if mode == "t2":
        pad = K2._t2_padding(D, H, W, out_dhw)
        Do, Ho, Wo = (2 * n - 1 + p for n, p in zip((D, H, W), pad))
        base = (D, H, W)
    else:
        Do, Ho, Wo = base = K2.out_shape(mode, D, H, W)
    mt, ntb = K2.tile(mode, N, Co, base)
    assert (mt, ntb) in K2.TILES[mode]
    bz, by = mt, 8
    ez, ey, ex, xs = _halo(m, bz, by)
    ps = _pad_to(ez * ey * xs, 8)
    nw = 8 * ntb
    nps = nw if nw % 32 in (8, 24) else nw + 8
    assert ps % 32 == 8 and nps % 32 in (8, 24)
    out = np.zeros((N, Co, Do, Ho, Wo))
    warps = np.arange(8)
    r16, c8 = np.arange(16), np.arange(8)
    for n in range(N):
        for bz0 in range(0, base[0], bz):
            for by0 in range(0, base[1], by):
                for bx0 in range(0, base[2], 16):
                    for co0 in range(0, Co, nw):
                        for cls in range(8 if mode == "t2" else 1):
                            acc = np.zeros((mt, 8, 16, nw))
                            for c0 in range(0, Ci, 8):
                                sx = _stage_halo(x, n, c0, m, bz, by,
                                                 (bz0, by0, bx0), ps)
                                sw = np.zeros(27 * 8 * nps)
                                for c in range(min(8, Ci - c0)):
                                    for col in range(min(nw, Co - co0)):
                                        sw[(np.arange(27) * 8 + c) * nps
                                           + col] = w27[co0 + col, c0 + c]
                                if mode == "t2":
                                    taps = [(k, oz, 1, oy, 1, _xcol(m, ox))
                                            for k, (oz, oy, ox)
                                            in _t2_taps(cls)]
                                else:
                                    s = 1 if mode == "s1" else 2
                                    taps = [(k, k // 9, s, (k // 3) % 3, s,
                                             _xcol(m, k % 3))
                                            for k in range(27)]
                                for k, rz0, dz, ry0, ys, xc in taps:
                                    b = sw[(k * 8 + c8)[:, None] * nps
                                           + np.arange(nw)[None]]
                                    for i in range(mt):
                                        row = ((rz0 + i * dz) * ey + ys * warps
                                               + ry0) * xs + xc
                                        a = sx[row[:, None, None]
                                               + r16[None, :, None]
                                               + c8[None, None, :] * ps]
                                        acc[i] += _mm3(a, b)
                            pz, py, px = cls >> 2, (cls >> 1) & 1, cls & 1
                            for i in range(mt):
                                for wp in range(8):
                                    z, y = bz0 + i, by0 + wp
                                    xx = bx0 + r16
                                    oz, oy, ox = ((2 * z + pz, 2 * y + py,
                                                   2 * xx + px)
                                                  if mode == "t2"
                                                  else (z, y, xx))
                                    if oz >= Do or oy >= Ho:
                                        continue
                                    keep = ox < Wo
                                    ncol = min(nw, Co - co0)
                                    # advanced indices first: [x, co]
                                    out[n, co0:co0 + ncol, oz, oy,
                                        ox[keep]] = acc[i, wp][keep][:, :ncol]
    return out


def emulate_dw(x, g, mode):
    """conv3d_dw.cu run by run: partials [chunks, Co, Ci, 27], each block
    one group of ≤ 64 output channels (`CO_GROUP`), then their sum in
    order; returns dW [Co, Ci, 27]."""
    m = K2.MODES[mode]
    N, Ci, D, H, W = x.shape
    Co, Do, Ho, Wo = g.shape[1:]
    plan = K8.dw_chunks(mode, N, Ci, D, H, W)
    bz, by, bx = plan.brick
    ez, ey, ex, xs = _halo(m, bz, by)
    ps = _pad_to(ez * ey * xs, 4)
    P = bz * by * bx
    pg = _pad_to(P, 4)
    assert ps % 32 == 4 and pg % 32 == 4
    group = K8.CO_GROUP
    rows = 16 * min(-(-Co // 16), group // 16)
    partial = np.full((plan.chunks, Co, Ci, 27), np.nan)
    p = np.arange(P)
    prx, pry, prz = p % 16, (p // 16) % by, p // (16 * by)
    for ch in range(plan.chunks):
        for c0 in range(0, Ci, 8):
            for cls, co0 in ((c, o) for o in range(0, Co, group)
                             for c in range(plan.classes)):
                pz, py, px = cls >> 2, (cls >> 1) & 1, cls & 1
                taps = (_t2_taps(cls) if mode == "t2" else
                        [(k, None) for k in range(27)])
                acc = np.zeros((rows, 8, 27))
                for n, z0, y0, x0 in brick_origins(plan, ch):
                    sx = _stage_halo(x, n, c0, m, bz, by, (z0, y0, x0), ps)
                    oz, oy, ox = z0 + prz, y0 + pry, x0 + prx
                    if mode == "t2":
                        oz, oy, ox = 2 * oz + pz, 2 * oy + py, 2 * ox + px
                    ok = (oz < Do) & (oy < Ho) & (ox < Wo)
                    sg = np.zeros(rows * pg)
                    for co in range(min(rows, Co - co0)):
                        sg[co * pg + p] = np.where(
                            ok, g[n, co0 + co, oz.clip(0, Do - 1),
                                  oy.clip(0, Ho - 1), ox.clip(0, Wo - 1)], 0)
                    for ks in range(P // 8):
                        p0 = 8 * ks
                        row, xo = p0 // 16, p0 % 16
                        rzb, ryb = row // by, row % by
                        a = sg[np.arange(rows)[:, None] * pg + p0
                               + np.arange(8)[None]]
                        for k, off in taps:
                            kz, ky, kx = k // 9, (k // 3) % 3, k % 3
                            if mode == "s1":
                                rz, ry = rzb + kz, ryb + ky
                                xc = _xcol(m, xo + kx)
                            elif mode == "s2":
                                rz, ry = 2 * rzb + kz, 2 * ryb + ky
                                xc = (kx & 1) * 17 + xo + (kx >> 1)
                            else:
                                rz, ry = rzb + off[0], ryb + off[1]
                                xc = _xcol(m, xo + off[2])
                            b = sx[np.arange(8)[None] * ps
                                   + (rz * ey + ry) * xs + xc
                                   + np.arange(8)[:, None]]
                            acc[:, :, k] += _mm3(a, b)
                ks = [k for k, _ in taps]
                ncl, nco = min(8, Ci - c0), min(rows, Co - co0)
                partial[ch, co0:co0 + nco, c0:c0 + ncl][..., ks] = \
                    acc[:nco, :ncl][..., ks]
    assert not np.isnan(partial).any()
    return partial.sum(0)


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 8, 16, (3, 10, 20)), ("s1", 41, 8, (2, 9, 17)),
    ("s1", 1, 41, (2, 9, 7)), ("s2", 16, 32, (5, 9, 7)),
    ("s2", 8, 1, (4, 18, 34)), ("t2", 16, 8, (3, 5, 6)),
    ("t2", 64, 32, (2, 4, 3)), ("s1", 16, 64, (1, 9, 33))])
def test_conv3d_kernel_emulation_matches_plain(mode, ci, co, shape):
    x = _rand((1, ci, *shape), ci + co).numpy()
    wshape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    w = _rand(wshape, co).numpy() * 0.1
    w27 = (w.transpose(1, 0, 2, 3, 4) if mode == "t2" else w).reshape(
        co, ci, 27)
    want = K2.conv3d_plain(torch.from_numpy(x).double(),
                           torch.from_numpy(w).double(), None, mode,
                           relu=False).numpy()
    got = emulate_conv3d(x, w27, mode)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_conv3d_kernel_emulation_trims_odd_t2():
    """The adjoint of "s2" over an odd size: "t2" written to 2n − 1."""
    x = _rand((1, 8, 3, 5, 4), 7).numpy()
    w = _rand((8, 16, 3, 3, 3), 8).numpy() * 0.1
    w27 = w.transpose(1, 0, 2, 3, 4).reshape(16, 8, 27)
    want = K2.conv3d_plain(torch.from_numpy(x).double(),
                           torch.from_numpy(w).double(), None, "t2",
                           relu=False, out_dhw=(5, 9, 8)).numpy()
    got = emulate_conv3d(x, w27, "t2", out_dhw=(5, 9, 8))
    assert got.shape == want.shape == (1, 16, 5, 9, 8)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 8, 16, (3, 10, 20)), ("s1", 41, 8, (2, 9, 17)),
    ("s1", 8, 1, (2, 9, 7)), ("s2", 16, 32, (5, 9, 7)),
    ("s2", 32, 64, (4, 10, 6)), ("t2", 16, 8, (3, 5, 6)),
    ("t2", 64, 32, (2, 4, 3)), ("s1", 8, 128, (2, 9, 17)),
    ("s2", 8, 128, (3, 6, 5)), ("t2", 8, 128, (2, 3, 3)),
    ("s1", 16, 72, (1, 8, 16))])
def test_dw_kernel_emulation_matches_plain(mode, ci, co, shape):
    x = _rand((1, ci, *shape), ci * co).numpy()
    g = _rand((1, co, *K2.out_shape(mode, *shape)), co).numpy()
    want = K8.conv3d_dw_plain(torch.from_numpy(x).double(),
                              torch.from_numpy(g).double(), mode).numpy()
    if mode == "t2":
        want = want.transpose(1, 0, 2, 3, 4)
    got = emulate_dw(x, g, mode)
    assert np.abs(got - want.reshape(co, ci, 27)).max() \
        <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("net", ["eval", "train"])
def test_tiles_are_built(net):
    """`tile` picks a tile the kernel is built for at every main-path
    conv, forward and (train) adjoint."""
    shapes = EVAL_SHAPES if net == "eval" else TRAIN_SHAPES
    for d, h, w in shapes:
        for mode, dhw in _trunk_inputs(d, h, w):
            for co in (1, 8, 16, 32, 41, 64):
                base = dhw if mode == "t2" else K2.out_shape(mode, *dhw)
                assert K2.tile(mode, 1, co, base) in K2.TILES[mode]


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 8, 8, (9, 10, 20)), ("s1", 16, 16, (5, 9, 17)),
    ("s1", 8, 1, (6, 9, 7)), ("t2", 16, 8, (3, 9, 6))])
def test_conv3d_kernel_emulation_largest_tiles(monkeypatch, mode, ci, co,
                                               shape):
    """With every grid counted large enough, `tile` picks the tallest
    bricks (4 x 8 x 16 at 8 channels in "s1"); the emulation at those
    tiles still equals the plain version."""
    monkeypatch.setattr(K2, "SMS", 0)
    nt = -(-co // 8)
    assert K2.tile(mode, 1, co, shape)[0] == (4 if mode == "s1" and nt == 1
                                             else 2)
    test_conv3d_kernel_emulation_matches_plain(mode, ci, co, shape)
