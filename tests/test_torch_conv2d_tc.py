"""K5's two routes and lateral head (`ops/csrc/conv2d.cu`), checked on the
CPU.

CUDA cannot run here, so these tests hold what the kernel computes, in
plain numpy/torch, against the plain versions:
  * an emulation of `conv2d_tc` block by block at its own shared-memory
    addressing (warps as 2 x 4 at stride 1 and 8 x 1 at stride 2, each MT
    output rows x 16 columns; at stride 1 each halo row's fragment feeding
    every output row and tap row that read it; the output tile and its
    halo, zero fill outside
    the image, 16-byte row vectors at stride 1 or one float at a time,
    stride-2 rows as two parity halves, the weights laid out
    [group][chunk][tap][ci][co] and staged with padded rows, the C
    fragment's epilogue in NCHW or [N, H, W, C]), and of the direct
    `conv2d_kernel` at its own addressing (one thread a pixel, CO_T
    channels a block row, the weight tile [Ci][k·k][CO_T] in smem),
    equals `conv2d_plain` for every one of FeatureNet's 13 calls on the
    route `route` gives it, at the tile `tile` picks for the DTU eval
    shape; cells the kernel never stages or writes are NaN, so a read of
    one shows;
  * the same for the lateral head against `lateral_conv2d_plain`;
  * 3xTF32 (TF32 emulated by bit masking) stays within 1e-6 of the
    largest value of a float64 conv at K = 5·5·16 and 3·3·32, where one
    TF32 product does not stay within 1e-4;
  * `route` and `tile` pick a built route and tile for every call at the
    DTU and T&T eval shapes;
  * K5-bf16 (`ops/csrc/conv2d_bf16.cu`) at its own addressing: the halo
    staged channels-last writes every cell once (NaN in the row pads),
    its A and B fragment maps are `tc_bf16.cuh`'s k-permutation, every
    fragment load of every tile (stride 2 reading its parity halves) falls
    on distinct banks, and the emulated tensor-core route, direct route
    and lateral head (at the tiles `TILES_BF16` gives the DTU shapes) stay
    within the bf16 gate of the plain versions for the bf16 eval path's 12
    calls.
"""
import numpy as np
import pytest
import torch

from rcmvsnet_tpu_torch.ops import conv2d as K5

torch.set_num_threads(2)

# FeatureNet's 13 calls (name, Ci, Co, k, stride, level of the input: 0
# full, 1 half, 2 quarter resolution; up: the call adds nearest-×2 of a
# map one level down; relu and BN; the eval path's output layout)
LAYERS = (
    ("conv0.0", 3, 8, 3, 1, 0, False, True, "nchw"),
    ("conv0.1", 8, 8, 3, 1, 0, False, True, "nchw"),
    ("conv1.0", 8, 16, 5, 2, 0, False, True, "nchw"),
    ("conv1.1", 16, 16, 3, 1, 1, False, True, "nchw"),
    ("conv1.2", 16, 16, 3, 1, 1, False, True, "nchw"),
    ("conv2.0", 16, 32, 5, 2, 1, False, True, "nchw"),
    ("conv2.1", 32, 32, 3, 1, 2, False, True, "nchw"),
    ("conv2.2", 32, 32, 3, 1, 2, False, True, "nchw"),
    ("out1", 32, 32, 1, 1, 2, False, False, "warp"),
    ("inner1+up", 16, 32, 1, 1, 1, True, False, "nchw"),
    ("out2", 32, 16, 3, 1, 1, False, False, "warp"),
    ("inner2+up", 8, 32, 1, 1, 0, True, False, "nchw"),
    ("out3", 32, 8, 3, 1, 0, False, False, "warp"),
)
DTU = (5, 864, 1152)            # views, full-resolution input
TANKS = (7, 1056, 1920)


def _pad_to(n, r):
    return n + ((r - n % 32) + 32) % 32


class Tile:
    """conv2d.cu's Tile<K, S, MT> and Cfg<..., NTB>."""

    def __init__(self, k, s, mt, ntb):
        self.k, self.s, self.mt, self.ntb = k, s, mt, ntb
        self.pad = k // 2
        self.wy, self.wx = K5.warps(s)
        self.by, self.bx = self.wy * mt, 16 * self.wx
        self.ey, self.ex = s * (self.by - 1) + k, s * (self.bx - 1) + k
        self.xh = (self.ex + 1) // 2
        self.xs = 2 * self.xh if s == 2 else self.bx + 8
        self.nv = self.xs // 4
        self.ps = _pad_to(self.ey * self.xs, 8)
        self.nw = 8 * ntb
        self.nps = self.nw if self.nw % 32 in (8, 24) else self.nw + 8
        assert self.ps % 32 == 8 and self.nps % 32 in (8, 24)
        assert self.xs % 4 == 0 and self.ps % 4 == 0 and self.nps % 4 == 0
        if s == 1:
            assert self.ex + 4 - self.pad <= self.xs
        # every column a tap reads was staged (see stage_tile)
        cols = {self.xcol(rx) for rx in range(self.ex)}
        for kx in range(k):
            for r in range(self.bx):
                assert self.col(kx) + r in cols
        rows = s * (self.by - 1) + k - 1
        assert rows < self.ey

    def xcol(self, rx):
        return ((rx & 1) * self.xh + (rx >> 1) if self.s == 2
                else rx + 4 - self.pad)

    def col(self, kx):
        """Column of output x 0 of the tile for tap kx."""
        return ((kx & 1) * self.xh + (kx >> 1) if self.s == 2
                else kx + 4 - self.pad)


def stage_tile(x, n, c0, t, by0, bx0, vec, sm=None):
    """load_tile: channels [c0, c0 + 8) of sample n's halo tile into an
    8·PS smem image (unstaged cells stay as they were: NaN)."""
    C, H, W = x.shape[1:]
    sm = np.full(8 * t.ps, np.nan) if sm is None else sm
    iy0 = t.s * by0 - t.pad
    if t.s == 1 and vec:
        gx0 = bx0 - 4
        for c in range(8):
            for ry in range(t.ey):
                gy = iy0 + ry
                for v in range(t.nv):
                    gx = gx0 + 4 * v
                    nx = (min(4, max(0, W - gx)) if c0 + c < C and 0 <= gy < H
                          and gx >= 0 else 0)
                    dst = c * t.ps + ry * t.xs + 4 * v
                    vals = np.zeros(4)
                    if nx:
                        vals[:nx] = x[n, c0 + c, gy, gx:gx + nx]
                    sm[dst:dst + 4] = vals
        return sm
    ix0 = t.s * bx0 - t.pad
    rx = np.arange(t.ex)
    cols = np.array([t.xcol(r) for r in rx])
    for c in range(8):
        for ry in range(t.ey):
            gy, gx = iy0 + ry, ix0 + rx
            ok = (c0 + c < C) & (0 <= gy < H) & (gx >= 0) & (gx < W)
            vals = np.zeros(t.ex)
            if c0 + c < C and 0 <= gy < H:
                vals[ok] = x[n, c0 + c, gy, gx[ok]]
            sm[c * t.ps + ry * t.xs + cols] = vals
    return sm


def prep_weights(w, t):
    """prep_weights + load_weights: per (group, chunk) the smem image
    [tap][ci 8][NPS], the NPS - NW padding columns NaN."""
    Co, Ci, k, _ = w.shape
    kk = k * k
    groups, nch = -(-Co // t.nw), -(-Ci // 8)
    wt = np.zeros((groups, nch, kk, 8, t.nw))
    w3 = w.reshape(Co, Ci, kk)
    for i in range(wt.size):
        g, ch, tap, c, col = np.unravel_index(i, wt.shape)
        co, ci = g * t.nw + col, ch * 8 + c
        if co < Co and ci < Ci:
            wt[g, ch, tap, c, col] = w3[co, ci, tap]
    out = {}
    for g in range(groups):
        for ch in range(nch):
            sw = np.full(kk * 8 * t.nps, np.nan)
            rows = np.arange(kk * 8)
            for col in range(t.nw):
                sw[rows * t.nps + col] = wt[g, ch].reshape(kk * 8, t.nw)[:,
                                                                         col]
            out[g, ch] = sw
    return out


def _mm3(a, b):
    """3xTF32 product in float64: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    (ah, al), (bh, bl) = (
        (v.double().numpy() for v in split3(torch.from_numpy(
            np.ascontiguousarray(u, np.float32)))) for u in (a, b))
    return al @ bh + ah @ bl + ah @ bh


def chunk_mma(acc, sx, sw, t):
    """chunk_mma: acc [8 warps, MT, 16, NW] += every tap's windows; warp
    w = WX·wy + wx. Stride 1: per tap column, each of the warp's MT + k - 1
    halo rows loaded once and used for every (mt, ky) with mt + ky = row;
    stride 2: per tap, each output row's window."""
    r16, c8 = np.arange(16), np.arange(8)

    def b_of(ky, kx):
        tap = ky * t.k + kx
        b = sw[(tap * 8 + c8)[:, None] * t.nps + np.arange(t.nw)[None]]
        assert not np.isnan(b).any()
        return b

    def a_of(row, col):
        a = sx[row * t.xs + col + r16[:, None] + c8[None] * t.ps]
        assert not np.isnan(a).any()
        return a

    for wp in range(8):
        wy, wx = wp // t.wx, wp % t.wx
        for kx in range(t.k):
            if t.s == 1:
                for z in range(t.mt + t.k - 1):
                    a = a_of(wy * t.mt + z, 16 * wx + t.col(kx))
                    for ky in range(t.k):
                        if 0 <= z - ky < t.mt:
                            acc[wp, z - ky] += _mm3(a, b_of(ky, kx))
            else:
                for ky in range(t.k):
                    for mt in range(t.mt):
                        a = a_of(2 * (wy * t.mt + mt) + ky,
                                 16 * wx + t.col(kx))
                        acc[wp, mt] += _mm3(a, b_of(ky, kx))


def store_tile(acc, out, n, by0, bx0, co0, t, nhwc, scale=None, shift=None,
               relu=False, up=None):
    Ho, Wo = (out.shape[1:3] if nhwc else out.shape[2:])
    Co = out.shape[3] if nhwc else out.shape[1]
    for wp in range(8):
        wy, wx = wp // t.wx, wp % t.wx
        for mt in range(t.mt):
            oy = by0 + wy * t.mt + mt
            if oy >= Ho:
                continue
            for r in range(16):
                ox = bx0 + 16 * wx + r
                for j in range(t.nw):
                    co = co0 + j
                    if ox >= Wo or co >= Co:
                        continue
                    v = acc[wp, mt, r, j]
                    if scale is not None:
                        v *= scale[co]
                    if shift is not None:
                        v += shift[co]
                    if relu:
                        v = max(v, 0.0)
                    if up is not None:
                        v += up[n, co, oy // 2, ox // 2]
                    idx = (n, oy, ox, co) if nhwc else (n, co, oy, ox)
                    assert np.isnan(out[idx]), "written twice"
                    out[idx] = v


def emulate_conv2d_tc(x, w, k, s, mt, ntb, scale=None, shift=None,
                      relu=False, up=None, nhwc=False):
    """conv2d_tc block by block; x [N, Ci, H, W] float32 numpy."""
    N, Ci, H, W = x.shape
    Co = w.shape[0]
    t = Tile(k, s, mt, ntb)
    Ho, Wo = (H + 2 * t.pad - k) // s + 1, (W + 2 * t.pad - k) // s + 1
    out = np.full((N, Ho, Wo, Co) if nhwc else (N, Co, Ho, Wo), np.nan)
    sws = prep_weights(w, t)
    vec = s == 1 and W % 4 == 0
    nch = -(-Ci // 8)
    for n in range(N):
        for by0 in range(0, Ho, t.by):
            for bx0 in range(0, Wo, t.bx):
                for g in range(-(-Co // t.nw)):
                    acc = np.zeros((8, t.mt, 16, t.nw))
                    for ch in range(nch):
                        sx = stage_tile(x, n, ch * 8, t, by0, bx0, vec)
                        chunk_mma(acc, sx, sws[g, ch], t)
                    store_tile(acc, out, n, by0, bx0, g * t.nw, t, nhwc,
                               scale, shift, relu, up)
    return out


def emulate_conv2d_direct(x, w, k, s, scale=None, shift=None, relu=False,
                          up=None, nhwc=False):
    """conv2d_kernel<K, CO_T, NHWC> thread by thread (all threads of a
    block row at once), on flat buffers as the kernel indexes them."""
    N, Ci, H, W = x.shape
    Co, pad = w.shape[0], k // 2
    Ho, Wo = (H + 2 * pad - k) // s + 1, (W + 2 * pad - k) // s + 1
    co_t = 16 if Co % 16 == 0 else 8 if Co % 8 == 0 else 1
    xf, wf = x.astype(np.float64).ravel(), w.astype(np.float64).ravel()
    out = np.full(N * Ho * Wo * Co, np.nan)
    out_sp, kk = Ho * Wo, k * k
    idx = np.arange(-(-N * out_sp // 128) * 128)      # whole blocks of 128
    idx = idx[idx < N * out_sp]                       # the rest return
    n, r = idx // out_sp, idx % out_sp
    oy, ox = r // Wo, r % Wo
    y0, x0 = oy * s - pad, ox * s - pad
    for by in range(Co // co_t):
        co0 = by * co_t
        i = np.arange(Ci * kk * co_t)
        j, tap, c = i % co_t, (i // co_t) % kk, i // (co_t * kk)
        s_w = wf[((co0 + j) * Ci + c) * kk + tap]
        acc = np.zeros((len(idx), co_t))
        for c in range(Ci):
            for ky in range(k):
                for kx in range(k):
                    yi, xi = y0 + ky, x0 + kx
                    ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
                    at = ((n * Ci + c) * H + yi) * W + xi
                    v = np.where(ok, xf[np.where(ok, at, 0)], 0.0)
                    wk = s_w[(c * kk + ky * k + kx) * co_t + np.arange(co_t)]
                    acc += v[:, None] * wk[None]
        for j in range(co_t):
            co = co0 + j
            res = acc[:, j]
            if scale is not None:
                res = res * scale[co]
            if shift is not None:
                res = res + shift[co]
            if relu:
                res = np.maximum(res, 0.0)
            if up is not None:
                res = res + up.ravel()[((n * Co + co) * (Ho // 2) + oy // 2)
                                       * (Wo // 2) + ox // 2]
            o = (n * out_sp + r) * Co + co if nhwc else (n * Co + co) * \
                out_sp + r
            assert np.isnan(out[o]).all(), "written twice"
            out[o] = res
    return out.reshape((N, Ho, Wo, Co) if nhwc else (N, Co, Ho, Wo))


def emulate_lateral(up, lat, wi, bi, w, mt, ntb, nhwc):
    """lateral_conv2d_tc: the lateral tile staged once, each 8-channel
    chunk of the sum formed in smem (fma over ci, + bi, + up), then the
    taps; lat [N, Cl, H, W], up [N, Cu, H/2, W/2]."""
    N, Cl, H, W = lat.shape
    Co, Cu = w.shape[:2]
    t = Tile(3, 1, mt, ntb)
    out = np.full((N, H, W, Co) if nhwc else (N, Co, H, W), np.nan)
    sws = prep_weights(w, t)
    s_wi = np.zeros((Cu, 8))
    s_wi[:, :Cl] = wi
    f32 = np.float32
    for n in range(N):
        for by0 in range(0, H, t.by):
            for bx0 in range(0, W, t.bx):
                s_lat = stage_tile(lat, n, 0, t, by0, bx0, W % 4 == 0)
                for g in range(-(-Co // t.nw)):
                    acc = np.zeros((8, t.mt, 16, t.nw))
                    sx = np.full(8 * t.ps, np.nan)
                    for ch in range(-(-Cu // 8)):
                        c0 = ch * 8
                        for c in range(8):
                            for ry in range(t.ey):
                                for rx in range(t.ex):
                                    gy, gx = by0 - 1 + ry, bx0 - 1 + rx
                                    off = ry * t.xs + t.xcol(rx)
                                    v = 0.0
                                    if (c0 + c < Cu and 0 <= gy < H
                                            and 0 <= gx < W):
                                        a = f32(0)
                                        for ci in range(8):
                                            a = f32(np.float64(s_lat[
                                                ci * t.ps + off])
                                                * s_wi[c0 + c, ci] + a)
                                        a = f32(a + f32(bi[c0 + c]))
                                        v = f32(a + up[n, c0 + c, gy // 2,
                                                       gx // 2])
                                    sx[c * t.ps + off] = v
                        chunk_mma(acc, sx, sws[g, ch], t)
                    store_tile(acc, out, n, by0, bx0, g * t.nw, t, nhwc)
    return out


# ---------------------------------------------------------------- 3xTF32

def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as cvt.rna does (bit masking)."""
    b = a.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split3(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


@pytest.mark.parametrize("ci,k,s", [(16, 5, 2), (32, 3, 1)])
def test_3xtf32_meets_the_gate_and_one_pass_does_not(ci, k, s):
    rng = np.random.default_rng(ci + k)
    x = torch.from_numpy(rng.standard_normal((1, ci, 24, 40))
                         .astype(np.float32))
    w = torch.from_numpy(0.1 * rng.standard_normal((16, ci, k, k))
                         .astype(np.float32))
    conv = lambda a, b: torch.nn.functional.conv2d(
        a.double(), b.double(), stride=s, padding=k // 2)
    exact = conv(x, w)
    (xh, xl), (wh, wl) = split3(x), split3(w)
    three = conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    scale = float(exact.abs().max())
    assert float((three - exact).abs().max()) <= 1e-6 * scale
    assert float((conv(xh, wh) - exact).abs().max()) > 1e-4 * scale


# ------------------------------------------------------ the kernel's plan

def _level_shape(level, N=2, H=20, W=36):
    return N, H >> level, W >> level


def _layer_inputs(layer, seed):
    name, ci, co, k, s, level, up, bn, layout = layer
    rng = np.random.default_rng(seed)
    N, H, W = _level_shape(level)
    x = rng.standard_normal((N, ci, H, W)).astype(np.float32)
    w = (0.2 * rng.standard_normal((co, ci, k, k))).astype(np.float32)
    scale = (0.5 + rng.random(co)).astype(np.float32) if bn else None
    shift = rng.standard_normal(co).astype(np.float32) if bn or up else None
    ho, wo = (H - 1) // s + 1, (W - 1) // s + 1
    u = (rng.standard_normal((N, co, ho // 2, wo // 2)).astype(np.float32)
         if up else None)
    return x, w, scale, shift, u


def _dtu_tile(layer):
    """The tile the card uses for this call at the DTU eval shape."""
    _, ci, co, k, s, level, *_ = layer
    n, H, W = DTU
    h, w = H >> level, W >> level
    return K5.tile(k, s, n, co, (h - 1) // s + 1, (w - 1) // s + 1)


@pytest.mark.parametrize("layer", LAYERS, ids=[lay[0] for lay in LAYERS])
def test_conv2d_tc_emulation_matches_plain(layer):
    name, ci, co, k, s, level, up, bn, layout = layer
    x, w, scale, shift, u = _layer_inputs(layer, len(name) * 7 + ci)
    if K5.route(k, s, k // 2, ci) == "tc":
        mt, ntb = _dtu_tile(layer)
        assert (mt, ntb) in K5.TILES[(k, s)]
        got = emulate_conv2d_tc(x, w, k, s, mt, ntb, scale, shift, bn, u,
                                layout == "warp")
    else:
        got = emulate_conv2d_direct(x, w, k, s, scale, shift, bn, u,
                                    layout == "warp")
    T = lambda a: None if a is None else torch.from_numpy(a).double()
    want = K5.conv2d_plain(T(x), T(w), T(scale), T(shift), stride=s,
                           padding=k // 2, relu=bn, up=T(u),
                           out_layout=layout).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("W,nhwc", [(36, True), (18, False)])
def test_lateral_emulation_matches_plain(W, nhwc):
    """The lateral head at the tile the card uses at the DTU shape; W 36
    stages the lateral input as 16-byte vectors, W 18 one float at a
    time."""
    rng = np.random.default_rng(W)
    N, H, Cu, Cl, Co = 2, 10, 32, 8, 8
    lat = rng.standard_normal((N, Cl, H, W)).astype(np.float32)
    up = rng.standard_normal((N, Cu, H // 2, W // 2)).astype(np.float32)
    wi = (0.3 * rng.standard_normal((Cu, Cl))).astype(np.float32)
    bi = rng.standard_normal(Cu).astype(np.float32)
    w = (0.1 * rng.standard_normal((Co, Cu, 3, 3))).astype(np.float32)
    n, Hd, Wd = DTU
    mt, ntb = K5.tile(3, 1, n, Co, Hd, Wd, K5.LATERAL_TILES)
    assert (mt, ntb) == (4, 1)
    got = emulate_lateral(up, lat, wi, bi, w, mt, ntb, nhwc)
    T = lambda a: torch.from_numpy(a).double()
    want = K5.lateral_conv2d_plain(T(up), T(lat), T(wi)[:, :, None, None],
                                   T(bi), T(w),
                                   "warp" if nhwc else "nchw").numpy()
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("shape", [DTU, TANKS])
def test_routes_and_tiles_are_built(shape):
    """Every call at the eval shapes has a route and, on the tensor cores,
    a tile the kernel is built for; the 3x3/5x5 convs with 8 or more
    input channels take the tensor cores."""
    n, H, W = shape
    for name, ci, co, k, s, level, *_ in LAYERS:
        h, w = H >> level, W >> level
        way = K5.route(k, s, k // 2, ci)
        assert way == ("tc" if k > 1 and ci >= 8 else "direct"), name
        if way == "tc":
            ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
            assert K5.tile(k, s, n, co, ho, wo) in K5.TILES[(k, s)]
        for mt, ntb in K5.TILES.get((k, s), ()):
            Tile(k, s, mt, ntb)
        for mt, ntb in K5.TILES_BF16.get((k, s), ()):
            TileB(k, s, mt, ntb, 8), TileB(k, s, mt, ntb, 16)
        if way == "tc":
            assert K5.tile(k, s, n, co, ho, wo, K5.TILES_BF16[(k, s)]) \
                in K5.TILES_BF16[(k, s)]
    for mt, ntb in K5.LATERAL_TILES:
        Tile(3, 1, mt, ntb), TileB(3, 1, mt, ntb, 16)


# ------------------------------------------------ K5-bf16 (conv2d_bf16.cu)
#
# The bf16 design at its own shared-memory addressing, in elements of a
# word array (word k of a position holds channels 2k, 2k + 1): the halo
# staged channels-last by (half, row, group) items, the fragments read by
# the kernel's 8-byte (CK = 16) or 4-byte (CK = 8) loads and placed where
# the PTX fragment layout puts them, the tensor cores' chains summed in
# float64 and flushed into float32 totals, the epilogue through the
# float32 tile, outputs rounded to bf16 once; the direct route's spans;
# the lateral head's up and lat tiles and its sum formed per (position,
# 8 channels). Cells nobody stages are NaN, so a read of one shows.

def _bf(a):
    """float32 rounded to bf16 (nearest even) and back."""
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).float().numpy()


class TileB:
    """conv2d_bf16.cu's Cfg<K, S, MT, NTB, CK>."""

    def __init__(self, k, s, mt, ntb, ck):
        self.k, self.s, self.mt, self.ntb, self.ck = k, s, mt, ntb, ck
        self.wy, self.wx = K5.warps(s)
        self.by, self.bx, self.pad = self.wy * mt, 16 * self.wx, k // 2
        self.ey, self.ex = s * (self.by - 1) + k, s * (self.bx - 1) + k
        self.xh = 0 if s == 1 else (self.ex + 1) // 2
        self.ng = s * self.bx // 8 + 2
        self.pw, self.hf = ck // 2, ck // 8
        self.rs = _pad_to(self.ex * self.pw, 4 * self.hf)
        self.nw = 8 * ntb
        self.cs = self.by * self.bx + 4
        assert self.rs % 32 == 4 * self.hf and self.ex * self.pw <= self.rs
        stage = self.ey * self.rs + k * k * self.nw * self.pw
        assert 4 * max(2 * stage, self.nw * self.cs) <= 227 * 1024

    def col(self, h):
        return h if self.s == 1 else (h & 1) * self.xh + (h >> 1)


def stage_cl(sm, x, n, c0, rows, y0, xg0, ng, hf_n, rs, pw, col_of):
    """stage_cl: items (half, row, group), each 8 channels x 8 inputs from
    x = xg0 + 8 group, the half of each stored input written once."""
    C, H, W = x.shape[1:]
    for e in range(hf_n * rows * ng):
        hf, row, gi = e % hf_n, (e // hf_n) % rows, e // (hf_n * rows)
        gy, cb = y0 + row, c0 + 8 * hf
        for p in range(8):
            col = col_of(8 * gi + p)
            if col < 0:
                continue
            gx = xg0 + 8 * gi + p
            v = np.zeros(8)
            for c in range(8):
                if cb + c < C and 0 <= gy < H and 0 <= gx < W:
                    v[c] = x[n, cb + c, gy, gx]
            at = 2 * (row * rs + col * pw + 4 * hf)
            assert np.isnan(sm[at:at + 8]).all(), "staged twice"
            sm[at:at + 8] = v
    return sm


def stage_x_b(x, n, c0, t, by0, bx0):
    sm = np.full(2 * t.ey * t.rs, np.nan)
    stage_cl(sm, x, n, c0, t.ey, t.s * by0 - t.pad, t.s * bx0 - 8, t.ng,
             t.hf, t.rs, t.pw,
             lambda rel: (t.col(rel - (8 - t.pad))
                          if 0 <= rel - (8 - t.pad) < t.ex else -1))
    # every position's CK channels staged once, the row pads never
    cells = sm.reshape(t.ey, 2 * t.rs)
    assert not np.isnan(cells[:, :2 * t.ex * t.pw]).any()
    assert np.isnan(cells[:, 2 * t.ex * t.pw:]).all()
    return sm


def frag_maps(ck):
    """(A, B): element offsets, from a tile's position 0 (A: [16 m][ck k])
    and from a weight column's first word (B: [ck k][8 n], in units of the
    column stride ck), of what lane (g, t)'s loads put in each register,
    placed by the PTX m16n8k16 / m16n8k8 fragment layout."""
    A, B = np.zeros((16, ck), int), np.zeros((ck, 8), int)
    pw = ck // 2
    for g in range(8):
        for t in range(4):
            for j in range(2):
                if ck == 16:     # lds64 at word 2t: (a0, a2), rows g, g+8
                    for r in (g, g + 8):
                        A[r, 2 * t + j] = 2 * (r * pw + 2 * t) + j
                        A[r, 2 * t + 8 + j] = 2 * (r * pw + 2 * t + 1) + j
                    B[2 * t + j, g] = 2 * (g * pw + 2 * t) + j
                    B[2 * t + 8 + j, g] = 2 * (g * pw + 2 * t + 1) + j
                else:            # 32-bit word t: a0, a1, b0
                    for r in (g, g + 8):
                        A[r, 2 * t + j] = 2 * (r * pw + t) + j
                    B[2 * t + j, g] = 2 * (g * pw + t) + j
    return A, B


def k_perm(ck):
    """tc_bf16.cuh's k-permutation: k = 2t + j -> element 4t + j, k = 2t +
    8 + j -> 4t + 2 + j (CK = 16); the identity at CK = 8."""
    if ck == 8:
        return np.arange(8)
    return np.array([4 * (k % 8 // 2) + k % 2 + (2 if k >= 8 else 0)
                     for k in range(16)])


def prep_weights_b(w, t):
    """conv2d_bf16_prep: per (group, chunk) the element image [tap][co
    NW][CK]."""
    Co, Ci, k, _ = w.shape
    groups, nch = -(-Co // t.nw), -(-Ci // t.ck)
    out = {}
    for g in range(groups):
        for ch in range(nch):
            sw = np.zeros((k * k, t.nw, t.ck))
            for col in range(t.nw):
                for c in range(t.ck):
                    co, ci = g * t.nw + col, ch * t.ck + c
                    if co < Co and ci < Ci:
                        sw[:, col, c] = w[co, ci].reshape(-1)
            out[g, ch] = sw.reshape(-1)
    return out


def chunk_mma_b(acc, sm, sw, t):
    """chunk_mma: acc [8, MT, 16, NW] float32 += the chains of one chunk
    (float64 within a chain; a chain: the K tap rows of a tap column at
    stride 1, the K tap columns of a tap row at stride 2)."""
    A, B = frag_maps(t.ck)

    def a_of(row, col):
        a = sm[2 * (row * t.rs + col * t.pw) + A]
        assert not np.isnan(a).any()
        return a

    def b_of(tap):
        cols = [sw[2 * ((tap * t.nw + nt * 8) * t.pw) + B]
                for nt in range(t.ntb)]
        return np.concatenate(cols, axis=1)

    for wp in range(8):
        wy, wx = wp // t.wx, wp % t.wx
        if t.s == 1:
            for kx in range(t.k):
                part = np.zeros((t.mt, 16, t.nw))
                for z in range(t.mt + t.k - 1):
                    a = a_of(wy * t.mt + z, 16 * wx + kx)
                    for ky in range(t.k):
                        if 0 <= z - ky < t.mt:
                            part[z - ky] += a @ b_of(ky * t.k + kx)
                acc[wp] = (acc[wp] + part).astype(np.float32)
        else:
            for ky in range(t.k):
                part = np.zeros((t.mt, 16, t.nw))
                for kx in range(t.k):
                    for mt in range(t.mt):
                        a = a_of(t.s * (wy * t.mt + mt) + ky, t.col(kx))
                        part[mt] += a @ b_of(ky * t.k + kx)
                acc[wp] = (acc[wp] + part).astype(np.float32)


def epilogue_b(acc, out, n, by0, bx0, co0, t, nhwc, shift=None, relu=False,
               up=None):
    """epilogue: fragments through ep[co][y][x] (float32), then each
    output written once, rounded to bf16 (+ up: rounded, + up, rounded)."""
    Co = out.shape[3] if nhwc else out.shape[1]
    Ho, Wo = out.shape[1:3] if nhwc else out.shape[2:]
    ep = np.full(t.nw * t.cs, np.nan, np.float32)
    for wp in range(8):
        wy, wx = wp // t.wx, wp % t.wx
        for mt in range(t.mt):
            for co in range(t.nw):
                cc = min(co0 + co, Co - 1)
                v = acc[wp, mt, :, co]
                if shift is not None:
                    v = (v + np.float32(shift[cc])).astype(np.float32)
                if relu:
                    v = np.maximum(v, 0)
                at = co * t.cs + (wy * t.mt + mt) * t.bx + 16 * wx
                ep[at:at + 16] = v
    for co in range(t.nw):
        for y in range(t.by):
            for x0 in range(t.bx):
                oy, ox, c = by0 + y, bx0 + x0, co0 + co
                if oy >= Ho or ox >= Wo or c >= Co:
                    continue
                v = ep[co * t.cs + y * t.bx + x0]
                if up is not None:
                    v = _bf(_bf(v) + up[n, c, oy // 2, ox // 2])
                idx = (n, oy, ox, c) if nhwc else (n, c, oy, ox)
                assert np.isnan(out[idx]), "written twice"
                out[idx] = _bf(v)


def emulate_conv2d_bf16_tc(x, w, k, s, mt, ntb, shift=None, relu=False,
                           up=None, nhwc=False):
    N, Ci, H, W = x.shape
    Co = w.shape[0]
    t = TileB(k, s, mt, ntb, 8 if Ci <= 8 else 16)
    Ho, Wo = (H + 2 * t.pad - k) // s + 1, (W + 2 * t.pad - k) // s + 1
    out = np.full((N, Ho, Wo, Co) if nhwc else (N, Co, Ho, Wo), np.nan)
    sws = prep_weights_b(w, t)
    for n in range(N):
        for by0 in range(0, Ho, t.by):
            for bx0 in range(0, Wo, t.bx):
                tiles = [stage_x_b(x, n, ch * t.ck, t, by0, bx0)
                         for ch in range(-(-Ci // t.ck))]
                for g in range(-(-Co // t.nw)):
                    acc = np.zeros((8, t.mt, 16, t.nw), np.float32)
                    for ch, sm in enumerate(tiles):
                        chunk_mma_b(acc, sm, sws[g, ch], t)
                    epilogue_b(acc, out, n, by0, bx0, g * t.nw, t, nhwc,
                               shift, relu, up)
    return out


def emulate_conv2d_bf16_direct(x, w, k, s, shift=None, relu=False, up=None,
                               nhwc=False):
    """conv2d_bf16_direct: a thread's 8 outputs from its span of whole
    8-element groups (element OFF + j S + kx), the sum in (c, ky, kx)
    order, float32 fused multiply-adds (bf16 products are exact)."""
    N, Ci, H, W = x.shape
    Co, pad = w.shape[0], k // 2
    Ho, Wo = (H + 2 * pad - k) // s + 1, (W + 2 * pad - k) // s + 1
    off = (8 - pad) % 8
    ng = (off + 8 * s + k - 1 + 7) // 8
    out = np.full((N, Ho, Wo, Co) if nhwc else (N, Co, Ho, Wo), np.nan)
    xg = np.arange(-(-Wo // 8))
    for n in range(N):
        for oy in range(Ho):
            acc = np.zeros((len(xg), 8, Co), np.float32)
            for c in range(Ci):
                for ky in range(k):
                    yi = oy * s - pad + ky
                    if not 0 <= yi < H:
                        continue
                    xb = xg * 8 * s - pad - off            # span element 0
                    e = xb[:, None] + np.arange(8 * ng)[None]
                    assert (xb % 8 == 0).all()             # whole groups
                    span = np.where((e >= 0) & (e < W),
                                    x[n, c, yi, np.clip(e, 0, W - 1)], 0.0)
                    for kx in range(k):
                        v = span[:, off + s * np.arange(8) + kx]
                        acc = (acc + v[..., None] * w[None, None, :, c, ky,
                                                       kx]).astype(np.float32)
            for co in range(Co):
                r = acc[..., co].ravel()[:Wo]
                if shift is not None:
                    r = (r + np.float32(shift[co])).astype(np.float32)
                if relu:
                    r = np.maximum(r, 0)
                if up is not None:
                    r = _bf(_bf(r) + up[n, co, oy // 2,
                                        np.arange(Wo) // 2])
                if nhwc:
                    assert np.isnan(out[n, oy, :, co]).all()
                    out[n, oy, :, co] = _bf(r)
                else:
                    assert np.isnan(out[n, co, oy]).all()
                    out[n, co, oy] = _bf(r)
    return out


def emulate_lateral_bf16(up, lat, wi, bi, w, mt, nhwc):
    """lateral_conv2d_bf16_tc: lat (CK = 8 layout) and up (all Cu channels,
    UX positions a row) staged channels-last once, thread q's 8 sum
    channels of every halo position formed (fma over the 8 ci in order, +
    b, rounded, + up, rounded) and stored into chunk q // 2, half q % 2;
    then every chunk's chains and the epilogue."""
    N, Cl, H, W = lat.shape
    Co, Cu = w.shape[:2]
    t, tl = TileB(3, 1, mt, 1, 16), TileB(3, 1, mt, 1, 8)
    nch = -(-Cu // 16)
    uy, ux, ung = t.by // 2 + 2, t.bx // 2 + 2, t.bx // 16 + 2
    upw = 8 * nch
    urs = _pad_to(ux * upw, (4 * 2 * nch) % 32)
    xc = _pad_to(t.ey * t.rs, 16)
    assert xc % 32 == 16               # a quarter warp's stores: see kernel
    out = np.full((N, H, W, Co) if nhwc else (N, Co, H, W), np.nan)
    sws = prep_weights_b(w, t)
    wq = np.zeros((8 * (2 * nch), 8), np.float32)
    wq[:Cu, :Cl] = wi
    bq = np.zeros(8 * 2 * nch, np.float32)
    bq[:Cu] = bi
    for n in range(N):
        for by0 in range(0, H, t.by):
            for bx0 in range(0, W, t.bx):
                s_lat = np.full(2 * tl.ey * tl.rs, np.nan)
                stage_cl(s_lat, lat, n, 0, tl.ey, by0 - 1, bx0 - 8, tl.ng, 1,
                         tl.rs, tl.pw,
                         lambda rel: rel - 7 if 0 <= rel - 7 < tl.ex else -1)
                s_up = np.full(2 * uy * urs, np.nan)
                stage_cl(s_up, up, n, 0, uy, by0 // 2 - 1, bx0 // 2 - 8, ung,
                         2 * nch, urs, upw,
                         lambda rel: rel - 7 if 0 <= rel - 7 < ux else -1)
                s_sum = np.full(2 * nch * xc, np.nan)
                for e in range(t.ey * t.ex):
                    ry, rx = divmod(e, t.ex)
                    gy, gx = by0 - 1 + ry, bx0 - 1 + rx
                    for q in range(2 * nch):
                        v = np.zeros(8, np.float32)
                        if 0 <= gy < H and 0 <= gx < W:
                            la = 2 * (ry * tl.rs + rx * tl.pw)
                            lv = s_lat[la:la + 8].astype(np.float32)
                            ua = 2 * (((gy >> 1) - by0 // 2 + 1) * urs +
                                      ((gx >> 1) - bx0 // 2 + 1) * upw +
                                      4 * q)
                            uv = s_up[ua:ua + 8].astype(np.float32)
                            assert not np.isnan(lv).any()
                            assert not np.isnan(uv).any()
                            a = np.zeros(8, np.float32)
                            for ci in range(8):
                                a = (a + lv[ci] * wq[8 * q:8 * q + 8, ci]) \
                                    .astype(np.float32)
                            a = (a + bq[8 * q:8 * q + 8]).astype(np.float32)
                            v = _bf(_bf(a) + uv)
                        at = 2 * ((q >> 1) * xc + ry * t.rs + rx * t.pw +
                                  4 * (q & 1))
                        assert np.isnan(s_sum[at:at + 8]).all()
                        s_sum[at:at + 8] = v
                acc = np.zeros((8, t.mt, 16, t.nw), np.float32)
                for ch in range(nch):
                    chunk_mma_b(acc, s_sum[2 * ch * xc:2 * (ch + 1) * xc],
                                sws[0, ch], t)
                epilogue_b(acc, out, n, by0, bx0, 0, t, nhwc)
    return out


def _close_bf16(got, want):
    """The bf16 gate: one bf16 ulp of each element + 1e-4 of the largest."""
    tol = np.abs(want) * 2.0 ** -7 + 1e-4 * np.abs(want).max()
    assert not np.isnan(got).any() and (np.abs(got - want) <= tol).all(), \
        float(np.abs(got - want).max())


# the bf16 eval path's 12 calls: the trunk, out1 and out2 in the warp
# layout, inner1+up, and stage 3's lateral head (its own test)
BF16_LAYERS = [lay for lay in LAYERS if lay[0] not in ("inner2+up", "out3")]


@pytest.mark.parametrize("ck", [8, 16])
def test_bf16_fragment_maps_are_the_k_permutation(ck):
    """Each k of an A row and of a B column reads channel k_perm(k) of its
    position (column): A and B agree, and every channel is read once."""
    A, B = frag_maps(ck)
    perm = k_perm(ck)
    for m in range(16):
        assert (A[m] - m * ck == perm).all()
    for n in range(8):
        assert (B[:, n] - n * ck == perm).all()
    assert sorted(perm) == list(range(ck))


@pytest.mark.parametrize("k,s,mt,ntb", [
    (k, s, mt, ntb) for (k, s), tiles in K5.TILES_BF16.items()
    for mt, ntb in tiles])
@pytest.mark.parametrize("ck", [8, 16])
def test_bf16_fragment_reads_fall_on_distinct_banks(k, s, mt, ntb, ck):
    """Every A load of a warp (all taps and rows; stride 2 reading the
    parity halves) and every B load: 8-byte loads a half warp, 4-byte
    loads a warp, each on 32 distinct banks."""
    t = TileB(k, s, mt, ntb, ck)
    lanes = [(g, tt) for g in range(8) for tt in range(4)]

    def distinct(words, width):
        banks = [(w + i) % 32 for w in words for i in range(width)]
        return len(set(banks)) == len(banks)

    def check(word_of):
        if ck == 16:
            for h in (lanes[:16], lanes[16:]):
                assert distinct([word_of(g, tt) for g, tt in h], 2)
        else:
            assert distinct([word_of(g, tt) for g, tt in lanes], 1)

    for row in range(t.ey):
        cols = (range(16 * t.wx + k) if s == 1 else
                [t.col(kx) for kx in range(k)])
        for col in cols:
            at = row * t.rs + col * t.pw
            check(lambda g, tt: at + g * t.pw + (2 * tt if ck == 16 else tt))
    for tap in range(k * k):
        for nt in range(ntb):
            at = (tap * t.nw + nt * 8) * t.pw
            check(lambda g, tt: at + g * t.pw + (2 * tt if ck == 16 else tt))


@pytest.mark.parametrize("layer", BF16_LAYERS,
                         ids=[lay[0] for lay in BF16_LAYERS])
def test_conv2d_bf16_emulation_within_the_gate(layer):
    """Each of the bf16 eval path's calls at a small shape, on the route and
    the DTU tile the card uses, within the bf16 gate of conv2d_plain (bf16
    inputs, folded scale: shift only)."""
    name, ci, co, k, s, level, up, bn, layout = layer
    x, w, _, shift, u = _layer_inputs(layer, len(name) * 5 + ci)
    x, w = _bf(x[:1]), _bf(w)
    u = None if u is None else _bf(u[:1])
    nhwc = layout == "warp" and name != "inner1+up"
    if K5.route(k, s, k // 2, ci) == "tc":
        n, H, W = DTU
        h, w_ = H >> level, W >> level
        mt, ntb = K5.tile(k, s, n, co, (h - 1) // s + 1, (w_ - 1) // s + 1,
                          K5.TILES_BF16[(k, s)])
        got = emulate_conv2d_bf16_tc(x, w, k, s, mt, ntb, shift, bn, u, nhwc)
    else:
        got = emulate_conv2d_bf16_direct(x, w, k, s, shift, bn, u, nhwc)
    T = lambda a: None if a is None else torch.from_numpy(a)
    want = K5.conv2d_plain(T(x).bfloat16(), T(w).bfloat16(), None, T(shift),
                           stride=s, padding=k // 2, relu=bn,
                           up=None if u is None else T(u).bfloat16(),
                           out_layout="warp" if nhwc else "nchw")
    assert got.shape == tuple(want.shape)
    _close_bf16(got, want.float().numpy())


@pytest.mark.parametrize("W,nhwc", [(36, True), (18, False)])
def test_lateral_bf16_emulation_within_the_gate(W, nhwc):
    """The lateral head at the DTU tile: W 36 stages rows of whole groups,
    W 18 partial ones (up rows of 9)."""
    rng = np.random.default_rng(W + 1)
    N, H, Cu, Cl, Co = 1, 10, 32, 8, 8
    lat = _bf(rng.standard_normal((N, Cl, H, W)))
    up = _bf(rng.standard_normal((N, Cu, H // 2, W // 2)))
    wi = _bf(0.3 * rng.standard_normal((Cu, Cl)))
    bi = rng.standard_normal(Cu).astype(np.float32)
    w = _bf(0.1 * rng.standard_normal((Co, Cu, 3, 3)))
    n, Hd, Wd = DTU
    mt, _ = K5.tile(3, 1, n, Co, Hd, Wd, K5.LATERAL_TILES)
    got = emulate_lateral_bf16(up, lat, wi, bi, w, mt, nhwc)
    T = lambda a: torch.from_numpy(a).bfloat16()
    want = K5.lateral_conv2d_plain(T(up), T(lat), T(wi)[:, :, None, None],
                                   torch.from_numpy(bi), T(w),
                                   "warp" if nhwc else "nchw")
    _close_bf16(got, want.float().numpy())
