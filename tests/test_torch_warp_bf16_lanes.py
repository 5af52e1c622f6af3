"""The lane maps of K1-bf16 and K6-bf16 (`ops/csrc/warp_variance_bf16.cu`),
K7-bf16 and K7bwd-bf16 (`ops/csrc/warp_volume_bf16.cu`), checked on the
CPU.

CUDA cannot run here, so these tests hold the kernels' mapping of lanes,
pixels, channels and views in plain numpy:
  * K6-bf16 gives a reference pixel L = C/4 lanes, lane q channels
    4q..4q+3, and a block P = 256/L pixels; K1-bf16 L = C/8 lanes, lane q
    channels 8q..8q+7. Every (pixel, channel) of every block plan belongs
    to exactly one live lane, and K1-bf16's store loop (16-byte vectors of
    8 pixels, or element by element where h·w % 8 != 0) and K6-bf16's
    staging of g put every element in exactly one place;
  * the projection hand-off: lane q projects views q, q + L, ... (S =
    ceil(NV / L) of them); view v's taps come from lane v % L, slot
    v // L, of the same pixel's group, so every view is projected once;
  * K6-bf16's staged g rows (P + 64/C bf16) put the lanes' reads of one
    instruction on distinct banks (two lanes share a word at most);
  * K6-bf16 emulated lane by lane (4 channels a lane, the taps handed on,
    runs of planes per pixel and view, each flush handed over through the
    group's shared buffer so that lane q adds channels q, q + L, ...):
    runs merge planes, and the result is within the bf16 gate (one bf16
    ulp + 1e-4 of the largest value) of `warp_variance_bwd_plain`. That
    the kernel's bits equal the template instance's it replaces is held
    on the card (`tools/ab_warp_bwd`, against a build of the parent);
  * K7bwd-bf16 (`ops/csrc/warp_volume_bf16.cu`) on K6-bf16's lanes: the
    image lane (view v's 3 image channels kept and flushed by lane v % L,
    slot v // L, into words 0..2 of the pixel's 4) covers every (pixel,
    view, image channel) once; the three cotangents staged into rows of PG
    bf16 (g_img's rows past 3 (V-1) zero) put every element in one place;
    and the kernel emulated lane by lane (features through the group's
    hand-over flush, images through the owning lane's) is within the bf16
    gate of `warp_volume_bwd_plain`;
  * K7-bf16 on K1-bf16's lanes (8 channels a lane): its staging (two
    buffers of 2C + 3 NV rows of P + 32/L bf16) fits a block's shared
    memory at every instance up to MAX_VIEWS; channel 8q + i staged at row
    i L + q puts the lanes of one store instruction on distinct banks
    (the channel order would not, at L > 1); the lane that projected view
    v stages its RGB, every (pixel, view, channel) once; the store loop
    (16-byte vectors, or element by element where h·w % 8 != 0) writes
    every element of var and vol once; and the kernel emulated lane by
    lane (the images from a [V, h, w, 4] copy whose fourth channel is NaN)
    is within the bf16 gate of `warp_volume_plain`.
"""
import numpy as np
import pytest
import torch

from rcmvsnet_tpu_torch.ops import warp_variance as K1
from rcmvsnet_tpu_torch.ops import warp_volume as K7

torch.set_num_threads(2)
f32 = np.float32
THREADS = 256
CHANNELS = (8, 16, 32)
BWD_CH, FWD_CH = 4, 8          # kBwdCh, kFwdCh
# (h, w) of the train and DTU stages and odd sizes
SHAPES = ((128, 160), (256, 320), (512, 640), (216, 288), (9, 7),
          (13, 21), (11, 29))


def lanes(C, n):
    """(L lanes a pixel, P pixels a block) at n channels a lane."""
    L = C // n
    return L, THREADS // L


@pytest.mark.parametrize("n", [BWD_CH, FWD_CH])
@pytest.mark.parametrize("C", CHANNELS)
def test_lanes_cover_every_pixel_channel_once(C, n):
    L, P = lanes(C, n)
    tid = np.arange(THREADS)
    j, q = tid // L, tid % L
    chans = n * q[:, None] + np.arange(n)[None]            # [256, n]
    for h, w in SHAPES:
        HW = h * w
        nx = -(-HW // P)
        pix = (np.arange(nx)[:, None] * P + j[None]).ravel()   # per lane
        live = pix < HW
        cell = (pix[:, None] * C + np.tile(chans, (nx, 1)))[live].ravel()
        assert np.array_equal(np.bincount(cell, minlength=HW * C),
                              np.ones(HW * C))


@pytest.mark.parametrize("C", CHANNELS)
def test_k1_bf16_stores_every_element_once(C):
    """The store loop of a plane: rows r < C of P pixels, as 16-byte
    vectors (8 pixels) where h·w % 8 == 0, else element by element; each
    (row, pixel) of every block written once, none past the image."""
    L, P = lanes(C, FWD_CH)
    for h, w in SHAPES:
        HW = h * w
        vec = HW % 8 == 0
        nx = -(-HW // P)
        hits = np.zeros(C * HW, int)
        for bx in range(nx):
            p0 = bx * P
            if vec:
                i = np.arange(C * (P // 8))
                r, jj = i // (P // 8), 8 * (i % (P // 8))
                keep = p0 + jj < HW
                r, jj = r[keep], jj[keep]
                r = np.repeat(r, 8)
                jj = (jj[:, None] + np.arange(8)).ravel()
                assert (p0 + jj < HW).all()        # whole vectors inside
            else:
                i = np.arange(C * P)
                r, jj = i // P, i % P
                keep = p0 + jj < HW
                r, jj = r[keep], jj[keep]
            np.add.at(hits, r * HW + p0 + jj, 1)
        assert (hits == 1).all()


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("C", CHANNELS)
def test_k6_bf16_stages_every_g_element_once(C, vec):
    """A chunk of 8 planes of g staged into s_g[dd][c][jj] (rows of PG =
    P + 64/C bf16), in 16-byte chunks of 8 pixels (h·w % 8 == 0) or
    element by element: every (plane, channel, pixel) of the block once,
    each in a slot of its own; a 16-byte chunk lies wholly inside the
    image or wholly outside it."""
    L, P = lanes(C, BWD_CH)
    PG = P + 64 // C
    if vec:
        i = np.arange(8 * C * (P // 8))
        ch, row = i % (P // 8), i // (P // 8)
        c, dd = np.repeat(row % C, 8), np.repeat(row // C, 8)
        jj = (8 * ch[:, None] + np.arange(8)).ravel()
        HW = 20480                                     # train stage 1
        for p0 in range(0, HW, P):
            first = p0 + 8 * ch < HW
            assert np.array_equal(first, p0 + 8 * ch + 7 < HW)
    else:
        i = np.arange(8 * C * P)
        jj, c, dd = i % P, (i // P) % C, i // (P * C)
    slot = (dd * C + c) * PG + jj
    assert len(np.unique(slot)) == len(slot) == 8 * C * P
    assert slot.max() < 8 * C * PG and (jj < P).all()
    cell = (dd * C + c) * P + jj
    assert np.array_equal(np.sort(cell), np.arange(8 * C * P))


@pytest.mark.parametrize("C", CHANNELS)
def test_k6_bf16_g_reads_on_distinct_banks(C):
    """Lane (j, q) reads s_g[dd][4q + i][j] (bf16) for i < 4: in each read
    instruction the 32 lanes of a warp touch distinct banks, two lanes of
    neighbouring pixels sharing one word at most."""
    L, P = lanes(C, BWD_CH)
    PG = P + 64 // C
    for wp in range(THREADS // 32):
        tid = np.arange(32 * wp, 32 * wp + 32)
        j, q = tid // L, tid % L
        for i in range(BWD_CH):
            word = ((BWD_CH * q + i) * PG + j) // 2
            words = np.unique(word)
            assert len(np.unique(words % 32)) == len(words)


@pytest.mark.parametrize("n", [BWD_CH, FWD_CH])
@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("nv", [2, 3, 4, 6, 7, 14, 15])
def test_projection_hand_off_covers_every_view_once(C, n, nv):
    """Lane q projects views s·L + q for s < S (a lane past the last view
    projects view 0, unused); view v's taps are read from lane v % L at
    slot v // L of the same group: each view once, by a lane of the
    group."""
    L, _ = lanes(C, n)
    S = -(-nv // L)
    projected = {}
    for q in range(L):
        for s in range(S):
            v = s * L + q
            if v < nv:
                assert (q, s) not in projected.values()
                projected[v] = (q, s)
    assert sorted(projected) == list(range(nv))
    for v in range(nv):
        assert projected[v] == (v % L, v // L) and v % L < L


# ------------------------------------------------------------ K6-bf16 values

def _rnd(a):
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, f32)).to(
        torch.bfloat16).float().numpy()


def _fma(a, b, c):
    """a·b + c rounded once to float32 (the product is exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def _inputs(V, h, w, C, D, seed):
    rng = np.random.default_rng(seed)
    feats = _rnd(rng.standard_normal((V, h, w, C)))
    g = _rnd(rng.standard_normal((C, D, h, w)))
    f = 1.2 * max(h, w)
    projs = np.zeros((V, 4, 4), f32)
    for v in range(V):
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
        E = np.eye(4)
        E[0, 3], E[1, 3] = -4.0 * v, 1.5 * (v % 2)
        projs[v, :3] = K @ E[:3]
        projs[v, 3] = E[3]
    lo = (560 + 10 * rng.random((h, w))).astype(f32)
    step = (0.4 + 0.2 * rng.random((h, w))).astype(f32)  # runs of planes
    return feats, projs, lo, step, g


def _taps(rel_v, fx, fy, dv, h, w):
    """warp::rot_row / depth_row / taps_of_rows: (x0, y0, wx, wy)."""
    rr = [f32(f32(rel_v[r, 0] * fx) + f32(rel_v[r, 1] * fy)) + rel_v[r, 2]
          for r in range(3)]
    X, Y, Z = (f32(rr[r] * dv) + rel_v[r, 3] for r in range(3))
    Z = np.where(np.abs(Z) < f32(1e-6),
                 np.where(Z < 0, f32(-1e-6), f32(1e-6)), Z).astype(f32)
    px = np.clip(X / Z, f32(-2), f32(w + 1)).astype(f32)
    py = np.clip(Y / Z, f32(-2), f32(h + 1)).astype(f32)
    x0f, y0f = np.floor(px), np.floor(py)
    return (x0f.astype(int), y0f.astype(int), (px - x0f).astype(f32),
            (py - y0f).astype(f32))


def emulate_k6_bf16(feats, rel, lo, step, g):
    """K6-bf16 (BWD_CH channels a lane), all pixels at once. Returns the
    int64 fixed-point sums [V-1, h*w, C], dref [h*w, C] float32, the
    quantum's inverse and the number of integer adds."""
    V, h, w, C = feats.shape
    n = BWD_CH
    D, HW, nv = g.shape[1], h * w, V - 1
    L = C // n
    S = -(-nv // L)
    src = feats.reshape(V, HW, C)
    gg = g.reshape(C, D, HW)
    pix = np.arange(HW)
    fy, fx = (pix // w).astype(f32), (pix % w).astype(f32)
    bound = D * HW * (2.0 / V) * float(np.abs(g).max()) * 2.0 * float(
        np.abs(feats).max())
    k = np.frexp(bound)[1]
    to_q, from_q = 2.0 ** (62 - k), 2.0 ** (k - 62)
    V32 = f32(V)
    scale = f32(f32(2) / V32)
    ref = src[0]
    acc = np.zeros((nv, HW, C), np.int64)
    adds = 0
    run_xy = [(np.full(HW, -(1 << 30)), np.full(HW, -(1 << 30)))
              for _ in range(nv)]
    run_acc = [np.zeros((4, HW, C), f32) for _ in range(nv)]
    dref = np.zeros((HW, C), f32)

    def flush(v, where):
        nonlocal adds
        x0, y0 = run_xy[v]
        for kk in range(4):
            xi, yi = x0 + (kk & 1), y0 + (kk >> 1)
            ok = where & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            # the group's hand-over: lane q' stores channels n·q' + i' to
            # fl[n·q' + i'], then lane q adds channel i·L + q
            fl = np.empty((HW, C), f32)
            for qq in range(L):
                for i in range(n):
                    fl[:, n * qq + i] = run_acc[v][kk][:, n * qq + i]
            for qq in range(L):
                for i in range(n):
                    c = i * L + qq
                    val = np.rint(fl[ok, c].astype(np.float64) * to_q)
                    np.add.at(acc[v], ((yi * w + xi)[ok], c),
                              val.astype(np.int64))
                    adds += int(ok.sum())

    for d in range(D):
        dv = (lo.reshape(-1) + f32(f32(d) * step.reshape(-1))).astype(f32)
        # lane q's projections, then the hand-off: view v from lane v % L
        mine = {(q, s): _taps(rel[s * L + q + 1 if s * L + q < nv else 0],
                              fx, fy, dv, h, w)
                for q in range(L) for s in range(S)}
        taps = [mine[(v % L, v // L)] for v in range(nv)]
        xs, total = [], ref.copy()
        for v, (x0, y0, wx, wy) in enumerate(taps):
            val = np.zeros((HW, C), f32)
            for kk in range(4):
                xi, yi = x0 + (kk & 1), y0 + (kk >> 1)
                ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                wxk = _rnd(wx if kk & 1 else f32(1) - wx)
                wyk = wy if kk >> 1 else (f32(1) - wy).astype(f32)
                wgt = (wxk * wyk).astype(f32)
                s = src[v + 1][np.where(ok, yi * w + xi, 0)]
                val = np.where(ok[:, None], _fma(wgt[:, None], s, val), val)
            xs.append(val)
            total = (total + val).astype(f32)
        mean = (total / V32).astype(f32)
        gs = (scale * gg[:, d].T).astype(f32)
        dref = _fma(gs, (ref - mean).astype(f32), dref)
        for v, (x0, y0, wx, wy) in enumerate(taps):
            new = (run_xy[v][0] != x0) | (run_xy[v][1] != y0)
            flush(v, new)
            run_xy[v] = (np.where(new, x0, run_xy[v][0]),
                         np.where(new, y0, run_xy[v][1]))
            run_acc[v][:, new] = 0
            cot = (gs * (xs[v] - mean).astype(f32)).astype(f32)
            for kk in range(4):
                wyk = wy if kk >> 1 else (f32(1) - wy).astype(f32)
                wxk = _rnd(wx if kk & 1 else f32(1) - wx)
                ty = _rnd((cot * wyk[:, None]).astype(f32))
                run_acc[v][kk] = _fma(wxk[:, None], ty, run_acc[v][kk])
    for v in range(nv):
        flush(v, np.ones(HW, bool))
    return acc, dref, from_q, adds


@pytest.mark.parametrize("V,h,w,C,D", [
    (4, 7, 9, 8, 9), (3, 5, 6, 16, 5), (5, 4, 5, 32, 4)])
def test_k6_bf16_emulation_matches_plain_within_the_bf16_gate(V, h, w, C, D):
    feats, projs, lo, step, g = _inputs(V, h, w, C, D, 7 * C + V)
    T = torch.from_numpy
    rel = K1.relative_projections(T(projs)).reshape(V, 4, 4).numpy()
    acc4, dref4, from_q, adds4 = emulate_k6_bf16(feats, rel, lo, step, g)
    # runs merged planes: fewer adds than one flush a plane would make
    assert 0 < adds4 < 4 * (V - 1) * D * h * w * C
    got = np.concatenate([dref4[None],
                          (acc4.astype(np.float64) * from_q).astype(f32)])
    got = _rnd(got).reshape(V, h, w, C)
    want = K1.warp_variance_bwd_plain(
        T(feats).to(torch.bfloat16), T(projs), T(lo), T(step),
        T(g).to(torch.bfloat16)).float().numpy()
    tol = np.abs(want) * 2.0 ** -7 + 1e-4 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


# ------------------------------------------------------------ K7bwd-bf16

@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("nv", [1, 3, 7, 15])
def test_k7bwd_bf16_image_lane_covers_every_image_channel_once(C, nv):
    """Lane q of a pixel keeps the image runs of views q, q + L, ... (slot
    s = v // L) and adds channels 0..2 of each into words 4 p + c of the
    image quanta [V-1, h, w, 4]: over all pixels of a block, every (pixel,
    view, channel < 3) once, word 3 never."""
    L, P = lanes(C, BWD_CH)
    S = -(-nv // L)
    hits = np.zeros((nv, P, 4), int)
    for tid in range(THREADS):
        j, q = tid // L, tid % L
        for s_ in range(S):
            v = s_ * L + q
            if v < nv:                  # the lane's `v % L == q` branch
                assert v % L == q and v // L == s_
                hits[v, j, :3] += 1
    assert (hits[..., :3] == 1).all() and (hits[..., 3] == 0).all()


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("C,NV,nv", [(32, 3, 3), (16, 7, 4), (8, 15, 9)])
def test_k7bwd_bf16_stages_every_cotangent_once(C, NV, nv, vec):
    """g_var and g_nr into [8][C][PG], g_img into [8][3 NV][PG] (rows past
    3 nv zero-filled): each (plane, row, pixel) of the block in a slot of
    its own, the three regions disjoint (the kernel's Smem offsets)."""
    L, P = lanes(C, BWD_CH)
    PG = P + 64 // C
    RI = 3 * NV
    GN = 8 * C * PG * 2
    GI = GN + 8 * C * PG * 2
    FL = GI + 8 * RI * PG * 2
    assert FL % 16 == 0
    slots = []
    for base, R, rows in ((0, C, C), (GN, C, C), (GI, RI, 3 * nv)):
        if vec:
            i = np.arange(8 * R * (P // 8))
            ch, row = i % (P // 8), i // (P // 8)
            c, dd = np.repeat(row % R, 8), np.repeat(row // R, 8)
            jj = (8 * ch[:, None] + np.arange(8)).ravel()
        else:
            i = np.arange(8 * R * P)
            jj, c, dd = i % P, (i // P) % R, i // (P * R)
        slot = base + 2 * ((dd * R + c) * PG + jj)
        assert len(np.unique(slot)) == 8 * R * P
        assert slot.max() < base + 8 * R * PG * 2
        # the rows a lane reads (its 4 channels, or its views' 3 image
        # rows) are staged; rows past `rows` hold zeros (read by no lane)
        assert set(np.unique(c)) == set(range(R)) and rows <= R
        slots.append(slot)
    allslots = np.concatenate(slots)
    assert len(np.unique(allslots)) == len(allslots) and allslots.max() < FL


def _vol_inputs(V, h, w, C, D, seed):
    feats, projs, lo, step, g_var = _inputs(V, h, w, C, D, seed)
    rng = np.random.default_rng(seed + 1)
    imgs = _rnd(rng.random((V, h, w, 3)))
    g_vol = _rnd(rng.standard_normal((3 * (V - 1) + C, D, h, w)))
    return feats, imgs, projs, lo, step, g_var, g_vol


def emulate_k7bwd_bf16(feats, rel, lo, step, g_var, g_vol):
    """K7bwd-bf16 (4 channels a lane), all pixels at once: the sources'
    sum from zero in view order, mean = (sum + ref) / V, mean_nr = sum /
    V, e = (2/V) g_var (x - mean) + (2/V) g_nr (x - mean_nr), image
    cotangent g_img of the view, each tap receiving bf16(e wy) bf16(wx);
    features flushed through the group's hand-over, images by the lane
    that projects the view. Returns dfeat [V, h, w, C] and dimg [V, h, w,
    3], each rounded to bf16, and the integer adds."""
    V, h, w, C = feats.shape
    D, HW, nv = g_var.shape[1], h * w, V - 1
    n, L = BWD_CH, C // BWD_CH
    S = -(-nv // L)
    src = feats.reshape(V, HW, C)
    gv_all = g_var.reshape(C, D, HW)
    gi_all = g_vol[:3 * nv].reshape(3 * nv, D, HW)
    gn_all = g_vol[3 * nv:].reshape(C, D, HW)
    pix = np.arange(HW)
    fy, fx = (pix // w).astype(f32), (pix % w).astype(f32)
    mx = lambda a: float(np.abs(a).max())
    qf = np.frexp(D * HW * (2.0 / V) * (mx(g_var) + mx(gn_all)) * 2.0 *
                  mx(feats))[1]
    qi = np.frexp(D * HW * mx(gi_all))[1]
    V32 = f32(V)
    scale = f32(f32(2) / V32)
    ref = src[0]
    acc_f = np.zeros((nv, HW, C), np.int64)
    acc_i = np.zeros((nv, HW, 4), np.int64)
    adds = 0
    run_xy = [(np.full(HW, -(1 << 30)), np.full(HW, -(1 << 30)))
              for _ in range(nv)]
    run_f = [np.zeros((4, HW, C), f32) for _ in range(nv)]
    run_i = [np.zeros((4, HW, 3), f32) for _ in range(nv)]
    dref = np.zeros((HW, C), f32)

    def flush(v, where):
        nonlocal adds
        x0, y0 = run_xy[v]
        for kk in range(4):
            xi, yi = x0 + (kk & 1), y0 + (kk >> 1)
            ok = where & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            at = (yi * w + xi)[ok]
            fl = run_f[v][kk].copy()            # the group's hand-over
            for qq in range(L):
                for i in range(n):
                    c = i * L + qq
                    np.add.at(acc_f[v], (at, c), np.rint(
                        fl[ok, c].astype(np.float64) * 2.0 ** (62 - qf))
                        .astype(np.int64))
                    adds += int(ok.sum())
            for c in range(3):                  # lane v % L, words 0..2
                np.add.at(acc_i[v], (at, c), np.rint(
                    run_i[v][kk][ok, c].astype(np.float64) *
                    2.0 ** (62 - qi)).astype(np.int64))
                adds += int(ok.sum())

    for d in range(D):
        dv = (lo.reshape(-1) + f32(f32(d) * step.reshape(-1))).astype(f32)
        mine = {(q, s_): _taps(rel[s_ * L + q + 1 if s_ * L + q < nv else 0],
                               fx, fy, dv, h, w)
                for q in range(L) for s_ in range(S)}
        taps = [mine[(v % L, v // L)] for v in range(nv)]
        xs, total = [], np.zeros((HW, C), f32)
        for v, (x0, y0, wx, wy) in enumerate(taps):
            val = np.zeros((HW, C), f32)
            for kk in range(4):
                xi, yi = x0 + (kk & 1), y0 + (kk >> 1)
                ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                wxk = _rnd(wx if kk & 1 else f32(1) - wx)
                wyk = wy if kk >> 1 else (f32(1) - wy).astype(f32)
                s = src[v + 1][np.where(ok, yi * w + xi, 0)]
                val = np.where(ok[:, None],
                               _fma((wxk * wyk).astype(f32)[:, None], s, val),
                               val)
            xs.append(val)
            total = (total + val).astype(f32)
        m = ((total + ref).astype(f32) / V32).astype(f32)
        m_nr = (total / V32).astype(f32)
        gv = (scale * gv_all[:, d].T).astype(f32)
        gn = (scale * gn_all[:, d].T).astype(f32)
        dref = _fma(gv, (ref - m).astype(f32), dref)
        for v, (x0, y0, wx, wy) in enumerate(taps):
            new = (run_xy[v][0] != x0) | (run_xy[v][1] != y0)
            flush(v, new)
            run_xy[v] = (np.where(new, x0, run_xy[v][0]),
                         np.where(new, y0, run_xy[v][1]))
            run_f[v][:, new] = 0
            run_i[v][:, new] = 0
            cot = _fma(gv, (xs[v] - m).astype(f32),
                       (gn * (xs[v] - m_nr).astype(f32)).astype(f32))
            gi = gi_all[3 * v:3 * v + 3, d].T
            for kk in range(4):
                wyk = wy if kk >> 1 else (f32(1) - wy).astype(f32)
                wxk = _rnd(wx if kk & 1 else f32(1) - wx)[:, None]
                run_f[v][kk] = _fma(wxk, _rnd((cot * wyk[:, None])
                                              .astype(f32)), run_f[v][kk])
                run_i[v][kk] = _fma(wxk, _rnd((gi * wyk[:, None])
                                              .astype(f32)), run_i[v][kk])
    for v in range(nv):
        flush(v, np.ones(HW, bool))
    dfeat = np.concatenate([dref[None], (acc_f.astype(np.float64) *
                                         2.0 ** (qf - 62)).astype(f32)])
    dimg = np.concatenate([np.zeros((1, HW, 3), f32),
                           (acc_i[..., :3].astype(np.float64) *
                            2.0 ** (qi - 62)).astype(f32)])
    return (_rnd(dfeat).reshape(V, h, w, C), _rnd(dimg).reshape(V, h, w, 3),
            adds)


@pytest.mark.parametrize("V,h,w,C,D", [
    (4, 7, 9, 8, 9), (3, 5, 6, 16, 5), (5, 4, 5, 32, 4)])
def test_k7bwd_bf16_emulation_matches_plain_within_the_bf16_gate(V, h, w, C,
                                                                   D):
    feats, imgs, projs, lo, step, g_var, g_vol = _vol_inputs(
        V, h, w, C, D, 3 * C + V)
    T = torch.from_numpy
    rel = K1.relative_projections(T(projs)).reshape(V, 4, 4).numpy()
    dfeat, dimg, adds = emulate_k7bwd_bf16(feats, rel, lo, step, g_var,
                                           g_vol)
    assert 0 < adds < 4 * (V - 1) * D * h * w * (C + 3)    # runs merged
    bf = lambda a: T(a).to(torch.bfloat16)
    want = K7.warp_volume_bwd_plain(bf(feats), bf(imgs), T(projs), T(lo),
                                    T(step), bf(g_var), bf(g_vol))
    for got, ref in zip((dfeat, dimg), want):
        ref = ref.float().numpy()
        tol = np.abs(ref) * 2.0 ** -7 + 1e-4 * np.abs(ref).max()
        assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


# ------------------------------------------------------------ K7-bf16

SMEM_BLOCK = 232448               # shared memory a block can use (bytes)
NV_BUCKETS = (3, 7, 15)           # the instances' bounds on source views


def fwd_smem(C, NV):
    """K7-bf16's FwdSmem: (L, P, PS, staged rows, bytes of the two
    buffers)."""
    L, P = lanes(C, FWD_CH)
    PS = P + (32 // L if L > 1 else 8)
    rows = 2 * C + 3 * NV
    return L, P, PS, rows, 2 * rows * PS * 2


def staged_row(L, q, i):
    """The staged row of channel 8q + i (var's, and the no-ref
    variance's from row C + 3 nv)."""
    return i * L + q


def channel_of(L, r):
    return (r % L) * FWD_CH + r // L


def k7_rows(C, nv):
    """Staged row r -> (0: var, 1: vol; the output row)."""
    L = C // FWD_CH
    nr0 = C + 3 * nv
    return [(0, channel_of(L, r)) if r < C else
            (1, r - C) if r < nr0 else (1, 3 * nv + channel_of(L, r - nr0))
            for r in range(2 * C + 3 * nv)]


@pytest.mark.parametrize("C", CHANNELS)
def test_k7_bf16_staging_fits_shared_memory(C):
    """Every instance (at most 3, 7 or 15 source views: every V up to
    MAX_VIEWS) fits the shared memory of a block, its staged rows start on
    16 bytes, and the staged rows of each view count are those of var, the
    images and the no-ref variance, each once."""
    assert K1.MAX_VIEWS - 1 == NV_BUCKETS[-1]
    for NV in NV_BUCKETS:
        L, P, PS, rows, nbytes = fwd_smem(C, NV)
        assert nbytes <= SMEM_BLOCK and PS % 8 == 0 and PS >= P
        for nv in range(1, NV + 1):
            out = k7_rows(C, nv)
            assert len(out) <= rows
            assert sorted(r for t, r in out if t == 0) == list(range(C))
            assert sorted(r for t, r in out if t == 1) == list(
                range(3 * nv + C))
    # the largest: C = 8 at 15 source views
    assert max(fwd_smem(c, 15)[4] for c in CHANNELS) == fwd_smem(8, 15)[4]


@pytest.mark.parametrize("C", CHANNELS)
def test_k7_bf16_staged_rows_fall_on_distinct_banks(C):
    """Lane (j, q) stages channel 8q + i of var and of the no-ref variance
    at row i L + q, column j, and the RGB of its views v = s L + q at rows
    C + 3v + c: in each store instruction the 32 lanes of a warp touch
    distinct banks (neighbouring pixels share a word at most). Rows 8q + i
    (the channel order) would put the L lanes of a pixel on one bank."""
    nv = 3
    L, P, PS, _, _ = fwd_smem(C, nv)
    assert sorted(staged_row(L, q, i) for q in range(L)
                  for i in range(FWD_CH)) == list(range(C))
    assert all(channel_of(L, staged_row(L, q, i)) == FWD_CH * q + i
               for q in range(L) for i in range(FWD_CH))

    def distinct(rows, j):
        words = np.unique((rows * PS + j) // 2)
        return len(np.unique(words % 32)) == len(words)

    naive = True
    for wp in range(THREADS // 32):
        tid = np.arange(32 * wp, 32 * wp + 32)
        j, q = tid // L, tid % L
        for i in range(FWD_CH):
            for base in (0, C + 3 * nv):
                assert distinct(base + staged_row(L, q, i), j)
            naive &= distinct(FWD_CH * q + i, j)
        for s_ in range(-(-nv // L)):
            v = s_ * L + q
            for c in range(3):
                live = v < nv
                assert distinct((C + 3 * v + c)[live], j[live])
    assert naive == (L == 1)


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("nv", [1, 3, 7, 15])
def test_k7_bf16_image_lanes_cover_every_view_channel_once(C, nv):
    """Lane q of a pixel samples the images of the views it projected, v =
    s L + q (slot s < S), and stages channel c < 3 of view v at row C + 3v
    + c: over a block, every (pixel, view, channel) once, the image rows
    [C, C + 3 nv) each once a pixel."""
    L, P = lanes(C, FWD_CH)
    S = -(-nv // L)
    hits = np.zeros((nv, P, 3), int)
    rows = np.zeros((C + 3 * nv, P), int)
    for tid in range(THREADS):
        j, q = tid // L, tid % L
        for s_ in range(S):
            v = s_ * L + q
            if v >= nv:
                break
            hits[v, j] += 1
            rows[C + 3 * v + np.arange(3), j] += 1
    assert (hits == 1).all()
    assert (rows[C:] == 1).all() and (rows[:C] == 0).all()


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("C,nv", [(32, 3), (16, 4), (8, 15)])
def test_k7_bf16_stores_every_element_once(C, nv, vec):
    """A plane's store loop (warpb::store_rows): staged row r of P pixels
    to its var or vol row, as 16-byte vectors (8 pixels) where vec (h·w %
    8 == 0), else element by element: every (row, pixel) of var and vol
    written once, none past the image, a vector wholly inside it."""
    L, P = lanes(C, FWD_CH)
    out = k7_rows(C, nv)
    R = len(out)
    kind = np.array([t for t, _ in out])
    row = np.array([r for _, r in out])
    for h, w in ((128, 160), (216, 288), (9, 7), (13, 21), (11, 29)):
        HW = h * w
        if vec and HW % 8:
            continue                       # the kernel stores these scalar
        nx = -(-HW // P)
        p0 = (np.arange(nx) * P)[:, None]
        if vec:
            i = np.arange(R * (P // 8))[None]
            r, jj = i // (P // 8), 8 * (i % (P // 8))
            keep = p0 + jj < HW
            r, pix = np.broadcast_to(r, keep.shape)[keep], (p0 + jj)[keep]
            r = np.repeat(r, 8)
            pix = (pix[:, None] + np.arange(8)).ravel()
            assert (pix < HW).all()
        else:
            i = np.arange(R * P)[None]
            r, jj = i // P, i % P
            keep = p0 + jj < HW
            r, pix = np.broadcast_to(r, keep.shape)[keep], (p0 + jj)[keep]
        for t, n in ((0, C), (1, 3 * nv + C)):
            sel = kind[r] == t
            hits = np.bincount(row[r[sel]] * HW + pix[sel], minlength=n * HW)
            assert len(hits) == n * HW and (hits == 1).all()


def _sample_bf16(src_v, x0, y0, wx, wy, h, w):
    """A bilinear sample of map src_v [h*w, n] with bf16 x weights: taps
    0..3, one fused multiply-add each, a tap outside the image adding
    nothing (warpb::fma_taps)."""
    val = np.zeros((len(x0), src_v.shape[1]), f32)
    for kk in range(4):
        xi, yi = x0 + (kk & 1), y0 + (kk >> 1)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        wxk = _rnd(wx if kk & 1 else f32(1) - wx)
        wyk = wy if kk >> 1 else (f32(1) - wy).astype(f32)
        s = src_v[np.where(ok, yi * w + xi, 0)]
        val = np.where(ok[:, None],
                       _fma((wxk * wyk).astype(f32)[:, None], s, val), val)
    return val


def emulate_k7_bf16(feats, imgs, rel, lo, step, D):
    """K7-bf16 (8 channels a lane), all pixels at once: the taps handed
    on, the source views' sums from zero in view order (x^2 by one FMA),
    each view's RGB sampled by the lane that projected it from the [V, h,
    w, 4] copy (channel 3 NaN: never read into an output), the division by
    V (x · (1/V) for V a power of two), the reference last, each value
    rounded to bf16 into its staged row and stored to its output row.
    Returns var [C, D, h, w] and vol [3 (V-1) + C, D, h, w]."""
    V, h, w, C = feats.shape
    HW, nv = h * w, V - 1
    L = C // FWD_CH
    S = -(-nv // L)
    src = feats.reshape(V, HW, C)
    im4 = np.full((V, HW, 4), np.nan, f32)
    im4[..., :3] = imgs.reshape(V, HW, 3)
    pix = np.arange(HW)
    fy, fx = (pix // w).astype(f32), (pix % w).astype(f32)
    V32 = f32(V)
    inv_v = f32(f32(1) / V32)
    over_v = ((lambda x: (x * inv_v).astype(f32)) if V & (V - 1) == 0
              else (lambda x: (x / V32).astype(f32)))
    ref = src[0]
    rows = k7_rows(C, nv)
    var = np.zeros((C, D, HW), f32)
    vol = np.zeros((3 * nv + C, D, HW), f32)
    for d in range(D):
        dv = (lo.reshape(-1) + f32(f32(d) * step.reshape(-1))).astype(f32)
        mine = {(q, s_): _taps(rel[s_ * L + q + 1 if s_ * L + q < nv else 0],
                               fx, fy, dv, h, w)
                for q in range(L) for s_ in range(S)}
        total, sq = np.zeros((HW, C), f32), np.zeros((HW, C), f32)
        for v in range(nv):
            val = _sample_bf16(src[v + 1], *mine[(v % L, v // L)], h, w)
            total = (total + val).astype(f32)
            sq = _fma(val, val, sq)
        staged = np.zeros((len(rows), HW), f32)
        for q in range(L):
            for s_ in range(S):
                v = s_ * L + q
                if v >= nv:
                    break
                rgb = _sample_bf16(im4[v + 1], *mine[(q, s_)], h, w)
                staged[C + 3 * v:C + 3 * v + 3] = _rnd(rgb[:, :3].T)
        m_nr = over_v(total)
        nr = _fma(-m_nr, m_nr, over_v(sq))
        m = over_v((total + ref).astype(f32))
        vr = _fma(-m, m, over_v(_fma(ref, ref, sq)))
        for q in range(L):
            for i in range(FWD_CH):
                r = staged_row(L, q, i)
                staged[r] = _rnd(vr[:, FWD_CH * q + i])
                staged[C + 3 * nv + r] = _rnd(nr[:, FWD_CH * q + i])
        for r, (t, o) in enumerate(rows):
            (var if t == 0 else vol)[o, d] = staged[r]
    return var.reshape(C, D, h, w), vol.reshape(3 * nv + C, D, h, w)


@pytest.mark.parametrize("V,h,w,C,D", [
    (4, 7, 9, 8, 9), (3, 5, 6, 16, 5), (5, 4, 5, 32, 4)])
def test_k7_bf16_emulation_matches_plain_within_the_bf16_gate(V, h, w, C, D):
    feats, imgs, projs, lo, step, _, _ = _vol_inputs(V, h, w, C, D,
                                                     5 * C + V)
    T = torch.from_numpy
    rel = K1.relative_projections(T(projs)).reshape(V, 4, 4).numpy()
    got = emulate_k7_bf16(feats, imgs, rel, lo, step, D)
    bf = lambda a: T(a).to(torch.bfloat16)
    want = K7.warp_volume_plain(bf(feats), bf(imgs), T(projs), T(lo),
                                T(step), D)
    for g, ref in zip(got, want):
        ref = ref.float().numpy()
        assert g.shape == ref.shape and np.isfinite(g).all()
        tol = np.abs(ref) * 2.0 ** -7 + 1e-4 * np.abs(ref).max()
        assert (np.abs(g - ref) <= tol).all(), np.abs(g - ref).max()
