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


# ------------------------------- the bf16 kernels' own plans and layouts
#
# csrc/conv3d_dw_bf16.cu (K8dw-bf16) and csrc/conv3d_bf16.cu (K2-bf16)
# emulated in float64 at their shared-memory word addressing: the staged
# layouts (dw: the kx-shifted copies of the halo rows and the g rows, t2's
# class split; K2: channels-last positions, the s2 parity halves, the
# prepared weights), the fragments each lane loads (8-byte loads whose
# four elements are k = 2t, 2t + 1, 2t + 8, 2t + 9 of an m16n8k16
# product; 4-byte ones for K2's 8-channel chunks), the transposed dw GEMM
# (rows: an octet of Ci at two taps; t2: taps of one parity class), its
# split-K plan (`dw_plan_bf16`), the per-warp brick rows and the fixed-
# order sums, and K2's epilogue tile and 8-output vectors.


def _t2_tap(p, bit):
    return (2 if bit else 0, 0 if bit else 1) if p else (1, 0)


def _t2_class_tap(c, i):
    """(k, oz, oy, ox) of tap i of parity class c (csrc t2_class_tap)."""
    bit, out = 0, []
    for p in (c >> 2, (c >> 1) & 1, c & 1):
        b = 0
        if p:
            b = (i >> bit) & 1
            bit += 1
        out.append(_t2_tap(p, b))
    (kz, oz), (ky, oy), (kx, ox) = out
    return kz * 9 + ky * 3 + kx, oz, oy, ox


def _dwb_cfg(mode):
    """conv3d_dw_bf16.cu's DwB<MODE>."""
    bz, by = K8.BRICK_BF16[mode][:2]
    ez = {"s1": bz + 2, "s2": 2 * bz + 1, "t2": bz + 1}[mode]
    ey = {"s1": by + 2, "s2": 2 * by + 1, "t2": by + 1}[mode]
    pr = ez * ey + ((1 - ez * ey % 4) + 4) % 4
    r = bz * by
    nv = 4 if mode == "s2" else 2
    lo, hi = mode != "t2", mode != "s2"
    sw, nw = 3 if lo else 0, 4 * nv + lo + hi
    return dict(BZ=bz, BY=by, R=r, KW=r // 8, EZ=ez, EY=ey, PR=pr,
                NCP=2 if mode == "t2" else 3, NV=nv, LO=lo, HI=hi,
                NW=nw, SW=sw, RW=((sw + nw + 3) // 4 | 1) * 4, PG=r * 16 + 16,
                A_STEP=(2 if mode == "s2" else 1) * ey * 8, B_STEP=64)


def _tile_half(mode, q, h, rz, ry, c):
    """(tap or -1, copy, hz, hy, class) of half h of tile q (tile_half)."""
    if mode != "t2":
        tap = 2 * q + h
        if tap >= 27:
            return -1, 0, 0, 0, 0
        kz, ky, kx = tap // 9, (tap // 3) % 3, tap % 3
        s = 1 if mode == "s1" else 2
        return tap, kx, s * rz + kz, s * ry + ky, 0
    start, cls = 0, 0
    for cls in range(8):
        n = ((1 << bin(cls).count("1")) + 1) >> 1
        if q < start + n or cls == 7:
            break
        start += n
    i = 2 * (q - start) + h
    if i >= 1 << bin(cls).count("1"):
        return -1, 0, 0, 0, cls
    k, oz, oy, ox = _t2_class_tap(cls, i)
    return k, ox, rz + oz, ry + oy, cls


def _span(row, x0, n):
    """Elements [x0, x0 + n) of a row, zero outside (load_span)."""
    out = np.zeros(n)
    lo, hi = max(x0, 0), min(x0 + n, len(row))
    if hi > lo:
        out[lo - x0:hi - x0] = row[lo:hi]
    return out


def emulate_dw_bf16(x, g, mode):
    """conv3d_dw_bf16.cu block by block; returns dW [Co, Ci, 27]."""
    N, Ci, D, H, W = x.shape
    Co, Do, Ho, Wo = g.shape[1:]
    c = _dwb_cfg(mode)
    plan = K8.dw_plan_bf16(mode, N, Ci, Co, D, H, W)
    MW, NB = plan.tiles, plan.n_tiles
    assert (MW, NB) == ((14, 1) if Co <= 8 else (7, 2))
    assert plan.m_blocks == -(-Ci // 8) * (14 // MW)
    assert plan.brick == (c["BZ"], c["BY"], 16)
    nbz, nby, nbx = plan.grid
    PR, EY, EZ, PG = c["PR"], c["EY"], c["EZ"], c["PG"]
    x_words = c["NCP"] * 8 * PR * 8
    g_words = 8 * NB * 8 * PG // 2 if mode == "t2" else 0
    zero = x_words + g_words
    gg, tt = np.arange(8)[:, None], np.arange(4)[None, :]
    partial = np.full((plan.chunks, Co, Ci, 27), np.nan)
    for ch in range(plan.chunks):
        for mb in range(plan.m_blocks):
            c0, q0 = (mb // (14 // MW)) * 8, (mb % (14 // MW)) * MW
            for cb in range(plan.co_blocks):
                co0 = cb * NB * 8
                acc = np.zeros((8, MW, NB, 16, 8))
                for b in range(ch * plan.per_chunk,
                               min((ch + 1) * plan.per_chunk, plan.bricks)):
                    bx0 = (b % nbx) * 16
                    by0 = (b // nbx) % nby * c["BY"]
                    bz0 = (b // (nbx * nby)) % nbz * c["BZ"]
                    n = b // (nbx * nby * nbz)
                    # the copies (element space: word w = elements 2w, 2w+1)
                    work = np.zeros(2 * (zero + c["KW"] * c["A_STEP"]))
                    # a raw row as the transform sees it: NW words from
                    # input XV - 2 LO (XV: s1 and t2 bx0, s2 2 bx0)
                    xv = 2 * bx0 if mode == "s2" else bx0
                    x0 = xv - 2 * c["LO"]
                    for ci in range(8):
                        for hz in range(EZ):
                            for hy in range(EY):
                                gz = {"s1": bz0 - 1, "s2": 2 * bz0 - 1,
                                      "t2": bz0}[mode] + hz
                                gy = {"s1": by0 - 1, "s2": 2 * by0 - 1,
                                      "t2": by0}[mode] + hy
                                ok = (c0 + ci < Ci and 0 <= gz < D
                                      and 0 <= gy < H)
                                sp = _span(x[n, c0 + ci, gz, gy] if ok
                                           else np.zeros(W), x0,
                                           2 * c["NW"])
                                for cp in range(c["NCP"]):
                                    d = ((cp * 8 + ci) * PR + hz * EY + hy) * 16
                                    for k in range(8):
                                        e, s = {"s1": (1 + cp + 2 * k, 1),
                                                "s2": (4 * k + cp + 1, 2),
                                                "t2": (2 * k + cp, 1)}[mode]
                                        work[d + 2 * k] = sp[e]
                                        work[d + 2 * k + 1] = sp[e + s]
                    # g: s1, s2 rows [co][rz * BY + ry][16]; t2 by class
                    gbuf = np.zeros(8 * NB * 8 * PG)
                    for co in range(NB * 8):
                        cg = co0 + co
                        for rr in range(c["R"]):
                            rz, ry = rr // c["BY"], rr % c["BY"]
                            for cls in range(8 if mode == "t2" else 1):
                                pz, py, px = cls >> 2, (cls >> 1) & 1, cls & 1
                                if mode == "t2":
                                    oz, oy = 2 * (bz0 + rz) + pz, 2 * (by0 + ry) + py
                                    ok = cg < Co and oz < Do and oy < Ho
                                    sp = _span(g[n, cg, oz, oy] if ok
                                               else np.zeros(Wo), 2 * bx0, 32)
                                    vals = [sp[4 * k + px + 2 * j]
                                            for k in range(8) for j in (0, 1)]
                                else:
                                    oz, oy = bz0 + rz, by0 + ry
                                    ok = cg < Co and oz < Do and oy < Ho
                                    vals = _span(g[n, cg, oz, oy] if ok
                                                 else np.zeros(Wo), bx0, 16)
                                base = (cls * NB * 8 + co) * PG + rr * 16
                                gbuf[base:base + 16] = vals
                    for w in range(8):
                        rz = w // c["BY"] if mode == "s2" else 0
                        ry = w % c["BY"]
                        offb = (gg * PG + (rz * c["BY"] + ry) * 16 + 4 * tt) // 2
                        for mt in range(MW):
                            offa = []
                            for h in range(2):
                                tap, cp, hz, hy, cls = _tile_half(
                                    mode, q0 + mt, h, rz, ry, c)
                                offa.append(
                                    zero + 2 * tt + 0 * gg if tap < 0 else
                                    ((cp * 8 + gg) * PR + hz * EY + hy) * 8
                                    + 2 * tt)
                                if h == 0:
                                    offg = cls * NB * 8 * PG // 2
                            for nb in range(NB):
                                for k in range(c["KW"]):
                                    A = np.zeros((16, 16))
                                    for h in range(2):
                                        e0 = 2 * (offa[h] + k * c["A_STEP"])
                                        for j in range(2):
                                            A[gg + 8 * h, 2 * tt + j] = work[e0 + j]
                                            A[gg + 8 * h, 2 * tt + 8 + j] = \
                                                work[e0 + 2 + j]
                                    e0 = 2 * (offb + k * c["B_STEP"]
                                              + nb * 8 * PG // 2
                                              + (offg if mode == "t2" else 0))
                                    B = np.zeros((16, 8))
                                    for j in range(2):
                                        B[2 * tt + j, gg] = gbuf[e0 + j]
                                        B[2 * tt + 8 + j, gg] = gbuf[e0 + 2 + j]
                                    acc[w, mt, nb] += A @ B
                # the warps in order, then the partial's rows
                tot = acc.sum(0)
                for mt in range(MW):
                    for h in range(2):
                        tap = _tile_half(mode, q0 + mt, h, 0, 0, c)[0]
                        for gi in range(8):
                            ci = c0 + gi
                            if tap < 0 or ci >= Ci:
                                continue
                            for nb in range(NB):
                                for col in range(8):
                                    co = co0 + nb * 8 + col
                                    if co < Co:
                                        partial[ch, co, ci, tap] = \
                                            tot[mt, nb, 8 * h + gi, col]
    assert not np.isnan(partial).any()
    return partial.sum(0)


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 8, 8, (3, 10, 20)), ("s1", 41, 8, (2, 9, 17)),
    ("s1", 8, 1, (3, 9, 7)), ("s2", 8, 16, (5, 9, 7)),
    ("s2", 16, 8, (4, 10, 12)), ("t2", 16, 8, (3, 5, 6)),
    ("t2", 8, 16, (2, 4, 3)), ("s1", 16, 72, (2, 8, 16))])
def test_dw_bf16_kernel_emulation_matches_plain(mode, ci, co, shape):
    """The bf16 dw kernel's transposed GEMM, copies, plan and sums equal
    the plain weight gradient (float64, index maps exact)."""
    x = _rand((1, ci, *shape), 3 * ci + co).numpy().astype(np.float64)
    g = _rand((1, co, *K2.out_shape(mode, *shape)), co + 1).numpy().astype(
        np.float64)
    want = K8.conv3d_dw_plain(torch.from_numpy(x), torch.from_numpy(g),
                              mode).numpy()
    if mode == "t2":
        want = want.transpose(1, 0, 2, 3, 4)
    got = emulate_dw_bf16(x, g, mode)
    assert np.abs(got - want.reshape(co, ci, 27)).max() \
        <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["s1", "s2", "t2"])
def test_dw_bf16_tma_box_holds_the_span(mode):
    """The bf16 dw kernel's TMA box of a halo row: it starts on a 16-byte
    boundary (8 inputs), its rows are an odd number of 16-byte units (the
    transform's loads of 8 rows on distinct banks), its sizes are TMA's,
    and the span the transform reads from it (raw words SW.., zero past
    the row's ends, as the box is filled) is the span the emulation
    stages, for every brick of a row."""
    c = _dwb_cfg(mode)
    rw, sw, nw, lo = c["RW"], c["SW"], c["NW"], c["LO"]
    assert (rw // 4) % 2 == 1 and sw + nw <= rw
    assert max(2 * rw, c["EY"], c["EZ"], 8) <= 256
    assert 8 * c["EZ"] * c["EY"] * 4 * rw < 1 << 20     # mbarrier tx count
    for w in (16, 40, 64):
        row = np.arange(1, w + 1, dtype=np.float64)
        for bx0 in range(0, w if mode == "t2" else w + 16, 16):
            xv = 2 * bx0 if mode == "s2" else bx0
            x0 = xv - 8 * lo
            assert x0 % 8 == 0
            box = _span(row, x0, 2 * rw)
            np.testing.assert_array_equal(
                box[2 * sw:2 * sw + 2 * nw], _span(row, xv - 2 * lo, 2 * nw))


@pytest.mark.parametrize("net", ["eval", "train"])
def test_dw_bf16_plan_covers_every_position_once(net):
    """The bf16 plan's bricks (two z rows in s1 and s2) cover every base
    position of every U-Net conv exactly once, and its grid is sized by
    all of its dimensions: about TARGET_BLOCKS blocks where positions
    allow, every tile of every octet and every n8 tile of Co in some
    block."""
    shapes = EVAL_SHAPES if net == "eval" else TRAIN_SHAPES
    for d, h, w in shapes:
        for mode, (di, hi, wi) in _trunk_inputs(d, h, w):
            for ci, co in ((8, 8), (16, 1), (41, 16), (64, 128)):
                plan = K8.dw_plan_bf16(mode, 1, ci, co, di, hi, wi)
                base = (di, hi, wi) if mode == "t2" else K2.out_shape(
                    mode, di, hi, wi)
                assert plan.grid == tuple(-(-b // e) for b, e in
                                          zip(base, plan.brick))
                assert (plan.chunks - 1) * plan.per_chunk < plan.bricks \
                    <= plan.chunks * plan.per_chunk
                assert plan.m_blocks * plan.tiles == -(-ci // 8) * 14
                assert plan.co_blocks * plan.n_tiles * 8 >= co
                blocks = plan.chunks * plan.m_blocks * plan.co_blocks
                assert blocks >= min(K8.TARGET_BLOCKS // 2, plan.bricks *
                                     plan.m_blocks * plan.co_blocks)
            plan = K8.dw_plan_bf16(mode, 1, 16, 8, di, hi, wi)
            count = np.zeros(base, np.int32)
            for c in range(plan.chunks):
                for _, z, y, x in brick_origins(plan, c):
                    bz, by, bx = plan.brick
                    count[z:z + bz, y:y + by, x:x + bx] += 1
            assert count.min() == 1 and count.max() == 1, (mode, base)


def _k2b_cfg(mode, mt, ntb, ck):
    """conv3d_bf16.cu's Cfg<MODE, MT, NTB, CK>."""
    ez = {"s1": mt + 2, "s2": 2 * mt + 1, "t2": mt + 1}[mode]
    ey = {"s1": 10, "s2": 17, "t2": 9}[mode]
    return dict(EZ=ez, EY=ey, NG={"s1": 4, "s2": 5, "t2": 3}[mode],
                EX={"s1": 18, "s2": 33, "t2": 17}[mode], PW=ck // 2,
                NW=8 * ntb, CS=mt * 8 * 16 + 4)


def _x_col(mode, rel):
    if mode == "s1":
        return rel - 7 if 7 <= rel < 25 else -1
    if mode == "t2":
        return rel if rel < 17 else -1
    h = rel - 7
    return -1 if h < 0 or h > 32 else (17 + (h >> 1) if h & 1 else h >> 1)


def _tap_col(mode, j, kx):
    if mode == "s2":
        return 17 + j if kx == 1 else j + (kx >> 1)
    return j + kx


def emulate_conv3d_bf16(x, w27, bias, mode, relu=True, skip=None,
                        out_dhw=None):
    """conv3d_bf16.cu block by block in float64: x [N, Ci, D, H, W], w27
    [Co, Ci, 27], bias [Co]; returns the output."""
    N, Ci, D, H, W = x.shape
    Co = w27.shape[0]
    if mode == "t2":
        pad = K2._t2_padding(D, H, W, out_dhw)
        Do, Ho, Wo = (2 * n - 1 + p for n, p in zip((D, H, W), pad))
        base = (D, H, W)
    else:
        Do, Ho, Wo = base = K2.out_shape(mode, D, H, W)
    MT, NTB = K2.tile(mode, N, Co, base)
    ck = 8 if Ci <= 8 and mode != "t2" else 16
    c = _k2b_cfg(mode, MT, NTB, ck)
    EZ, EY, EX, NW, CS = c["EZ"], c["EY"], c["EX"], c["NW"], c["CS"]
    nch = -(-Ci // ck)
    gg, tt = np.arange(8)[:, None], np.arange(4)[None, :]
    # prep_weights_bf16: [group][chunk][tap][co][ck] elements
    groups = -(-Co // NW)
    wt = np.zeros((groups, nch, 27, NW, ck))
    for co in range(Co):
        for ci in range(Ci):
            wt[co // NW, ci // ck, :, co % NW, ci % ck] = w27[co, ci]
    out = np.zeros((N, Co, Do, Ho, Wo))
    ncls = 8 if mode == "t2" else 1
    for n in range(N):
        for bz0 in range(0, base[0], MT):
            for by0 in range(0, base[1], 8):
                for bx0 in range(0, base[2], 16):
                    for grp in range(groups):
                        co0 = grp * NW
                        acc = np.zeros((ncls, 8, MT, 16, NW))
                        for ch in range(nch):
                            S = np.zeros(EZ * EY * EX * ck)
                            iz0 = {"s1": bz0 - 1, "s2": 2 * bz0 - 1,
                                   "t2": bz0}[mode]
                            iy0 = {"s1": by0 - 1, "s2": 2 * by0 - 1,
                                   "t2": by0}[mode]
                            xg0 = {"s1": bx0 - 8, "s2": 2 * bx0 - 8,
                                   "t2": bx0}[mode]
                            # the groups' inputs (stage_x)
                            staged = [xg0 + 8 * gi + p
                                      for gi in range(c["NG"])
                                      for p in range(8)]
                            for row in range(EZ * EY):
                                gz, gy = iz0 + row // EY, iy0 + row % EY
                                for gx in staged:
                                    col = _x_col(mode, gx - xg0)
                                    if col < 0:
                                        continue
                                    for cc in range(ck):
                                        ci = ch * ck + cc
                                        if (ci < Ci and 0 <= gz < D and
                                                0 <= gy < H and 0 <= gx < W):
                                            S[(row * EX + col) * ck + cc] = \
                                                x[n, ci, gz, gy, gx]
                            Wsm = wt[grp, ch].reshape(-1)

                            def frag_a(pos):
                                # pos [8, 1]: the halo position of row g
                                if ck == 16:
                                    A = np.zeros((16, 16))
                                    for h in range(2):
                                        e0 = (pos + 8 * h) * 16 + 4 * tt
                                        for j in range(2):
                                            A[gg + 8 * h, 2 * tt + j] = S[e0 + j]
                                            A[gg + 8 * h, 2 * tt + 8 + j] = \
                                                S[e0 + 2 + j]
                                    return A
                                A = np.zeros((16, 8))
                                for h in range(2):
                                    e0 = (pos + 8 * h) * 8 + 2 * tt
                                    for j in range(2):
                                        A[gg + 8 * h, 2 * tt + j] = S[e0 + j]
                                return A

                            def frag_b(tap):
                                B = np.zeros((ck, NW))
                                for nt in range(NTB):
                                    r = (tap * NTB + nt) * 8 + gg
                                    cols = nt * 8 + gg
                                    if ck == 16:
                                        e0 = r * 16 + 4 * tt
                                        for j in range(2):
                                            B[2 * tt + j, cols] = Wsm[e0 + j]
                                            B[2 * tt + 8 + j, cols] = \
                                                Wsm[e0 + 2 + j]
                                    else:
                                        e0 = r * 8 + 2 * tt
                                        for j in range(2):
                                            B[2 * tt + j, cols] = Wsm[e0 + j]
                                return B

                            for warp in range(8):
                                for cls in range(ncls):
                                    if mode == "t2":
                                        taps = [(k, oz, 1, oy, ox) for k, (
                                            oz, oy, ox) in _t2_taps(cls)]
                                    else:
                                        s = 1 if mode == "s1" else 2
                                        taps = [(k, k // 9, s, (k // 3) % 3,
                                                 k % 3) for k in range(27)]
                                    for k, kz, sz, ky, kx in taps:
                                        B = frag_b(k)
                                        for mt in range(MT):
                                            if mode == "t2":
                                                hz, hy = mt + kz, warp + ky
                                                col = gg + kx
                                            else:
                                                hz = sz * mt + kz
                                                hy = sz * warp + ky
                                                col = _tap_col(mode, gg, kx)
                                            A = frag_a((hz * EY + hy) * EX
                                                       + col)
                                            acc[cls, warp, mt] += A @ B
                        # epilogue tile, then 8-output vectors
                        ep = np.zeros(ncls * NW * CS)
                        for cls in range(ncls):
                            for warp in range(8):
                                for mt in range(MT):
                                    for co in range(NW):
                                        b = bias[co0 + co] if co0 + co < Co \
                                            else 0.0
                                        r = acc[cls, warp, mt, :, co] + b
                                        if relu:
                                            r = np.maximum(r, 0)
                                        i0 = (cls * NW + co) * CS + \
                                            (mt * 8 + warp) * 16
                                        ep[i0:i0 + 16] = r
                        rv = 4 if mode == "t2" else 2
                        rows = NW * MT * 8 * (4 if mode == "t2" else 1)
                        for e in range(rows * rv):
                            v, r = e % rv, e // rv
                            pz = py = 0
                            if mode == "t2":
                                py, pz, r = r & 1, (r >> 1) & 1, r >> 2
                            y, mt, co = r % 8, (r // 8) % MT, r // (8 * MT)
                            cg = co0 + co
                            oz = 2 * (bz0 + mt) + pz if mode == "t2" else bz0 + mt
                            oy = 2 * (by0 + y) + py if mode == "t2" else by0 + y
                            ox0 = (2 * bx0 if mode == "t2" else bx0) + 8 * v
                            if cg >= Co or oz >= Do or oy >= Ho or ox0 >= Wo:
                                continue
                            for k in range(8):
                                if ox0 + k >= Wo:
                                    break
                                cls = pz * 4 + py * 2 + (k & 1) \
                                    if mode == "t2" else 0
                                j = 4 * v + (k >> 1) if mode == "t2" \
                                    else 8 * v + k
                                val = ep[(cls * NW + co) * CS +
                                         (mt * 8 + y) * 16 + j]
                                if skip is not None:
                                    val += skip[n, cg, oz, oy, ox0 + k]
                                out[n, cg, oz, oy, ox0 + k] = val
    return out


@pytest.mark.parametrize("mode,ci,co,shape,skip", [
    ("s1", 8, 8, (3, 10, 20), False), ("s1", 16, 16, (2, 9, 17), False),
    ("s1", 41, 8, (2, 9, 7), False), ("s1", 8, 1, (2, 9, 7), False),
    ("s2", 8, 16, (5, 9, 7), False), ("s2", 32, 8, (4, 10, 12), False),
    ("t2", 16, 8, (3, 5, 6), True), ("t2", 8, 16, (2, 4, 3), True)])
def test_conv3d_bf16_kernel_emulation_matches_plain(mode, ci, co, shape,
                                                    skip):
    """K2-bf16's channels-last staging (both chunk widths), fragments,
    taps and epilogue vectors equal the plain conv with bias, ReLU and
    the skip (float64, index maps exact)."""
    x = _rand((1, ci, *shape), 5 * ci + co).numpy().astype(np.float64)
    wshape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    w = _rand(wshape, co + 2).numpy().astype(np.float64) * 0.1
    b = _rand((co,), co + 3).numpy().astype(np.float64)
    w27 = (w.transpose(1, 0, 2, 3, 4) if mode == "t2" else w).reshape(
        co, ci, 27)
    sk = (_rand((1, co, *K2.out_shape(mode, *shape)), 9).numpy()
          .astype(np.float64) if skip else None)
    want = K2.conv3d_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), mode, relu=True,
                           skip=None if sk is None else torch.from_numpy(sk)
                           ).numpy()
    got = emulate_conv3d_bf16(x, w27, b, mode, relu=True, skip=sk)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_conv3d_bf16_kernel_emulation_trims_odd_t2():
    """The adjoint of "s2" over an odd size: K2-bf16's "t2" written to
    2n − 1 (scalar stores past the last whole vector)."""
    x = _rand((1, 16, 3, 5, 4), 7).numpy().astype(np.float64)
    w = _rand((16, 8, 3, 3, 3), 8).numpy().astype(np.float64) * 0.1
    w27 = w.transpose(1, 0, 2, 3, 4).reshape(8, 16, 27)
    zero = np.zeros(8)
    want = K2.conv3d_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(zero), "t2", relu=False,
                           out_dhw=(5, 9, 7)).numpy()
    got = emulate_conv3d_bf16(x, w27, zero, "t2", relu=False,
                              out_dhw=(5, 9, 7))
    assert got.shape == want.shape == (1, 8, 5, 9, 7)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
