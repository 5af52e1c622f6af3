"""The port's hand-written kernels against their plain PyTorch versions, on
a CUDA card (marker `gpu`; each test skips where there is no card).

Small shapes that still cover every code path: K1 at C 8/16/32 with
out-of-image taps, and at odd sizes (h·w not a multiple of a block's
pixels, D not a multiple of its plane chunk, 2 to 9 source views) against
the plain version and the K10 route, with the grid the built kernel
reports equal to `plan`'s; K2 in each mode (stride 1, stride 2, transposed with
skip, the 1-channel prob head, 41 output channels as in the render
U-Net's conv0 dx, one input channel as in the prob head's dx, 64→64 and
odd sizes in each mode), K4 at D 2/8/13/32/48/64 (its register
instances) and 65/96/192 (its streaming instance), K5 at k 1/3/5, stride 1/2
and the upsample-add epilogue, on both routes (tensor cores and direct),
in both output layouts, at widths that stage 16-byte row vectors and at
widths that do not, and K5's lateral head; and the train kernels, forward and
gradients from a fixed random cotangent against autograd through the plain
versions: K6 (K1's backward) at C 8/16/32, K7 (volume forward and
backward at C 8/16/32, V 2/4/5 and odd sizes; the cascade's B=1
volume_feature shares K7's storage), K8 in each mode (forward and dx
through K2, dw through its own kernel, the 41-channel input, 1-channel
prob head, 64→64, 128 output channels (two Co groups of the dw kernel)
and odd sizes in each mode included), dw, K6 and K7's
backward each repeated bit for bit (K6 and K7 also at odd sizes); K9
(K2's kernel as the raw conv) in every mode at odd and non-multiple-of-8
sizes; K10 at C 3/8/16/32 (the scalar path and the lane path), at odd
sizes (C 3/4/8/12/16/32, D = 1, sample counts that no block or warp
divides, coordinates on the clip bounds, whole rows out of the image),
repeated bit for bit, and the K10 route's variance against K1's,
within 1e-5 of its largest value. The bf16 instances of K1, K2 and K5
(the bf16 eval path) against their bf16 plain versions, to one bf16 ulp
of each element plus 1e-4 of the largest value, at the same kinds of
shapes (every K2 mode, the float32 prob head, K5's two routes, the
upsample-add and the lateral head), and the bf16 cascade on the card
launching only the bf16 instances of the three, and K4. The bf16 train
instances (the bf16 train path) likewise: K6-bf16 under autograd and
repeated bit for bit, K7-bf16 forward and backward (repeated bit for
bit), K8's bf16 pair in every mode (odd sizes, 41 input channels, two
Co groups of dw, the prob head's float32 output), the bf16 dw repeated
bit for bit, and one bf16 train step launching only the bf16 instances;
K1-bf16 and K6-bf16's own designs (`csrc/warp_variance_bf16.cu`) at every
C and view-count instance, odd sizes and D = 96, K6-bf16 repeated bit for
bit; K5-bf16's own design
(`csrc/conv2d_bf16.cu`) on every route and layout, Ci 3/8/16/24/32,
aligned, unaligned and shifted rows, and its lateral head; K7bwd-bf16's
own design (`csrc/warp_volume_bf16.cu`) at every C and view-count
instance, odd sizes, D 5-13 and 48, repeated bit for bit; K7-bf16's
own design (the same source) likewise; and a misaligned source refused by
K1-bf16, K7-bf16 and K7bwd-bf16. The backward
kernels sum in another order than autograd (K8 dw in per-block
partials, K6 and K7 in 64-bit fixed point, rounded once per flushed run
of planes), so they are held to 1e-4 of the largest value, and to
themselves bit for bit. Run on the card
without the JAX test configuration (its host has no jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from rcmvsnet_tpu_torch.ops import conv2d as K5
from rcmvsnet_tpu_torch.ops import conv3d as K2
from rcmvsnet_tpu_torch.ops import conv3d_train as K8
from rcmvsnet_tpu_torch.ops import depth_tail as K4
from rcmvsnet_tpu_torch.ops import warp_variance as K1
from rcmvsnet_tpu_torch.ops import warp_view as K10
from rcmvsnet_tpu_torch.ops import warp_volume as K7

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rcmvsnet_tpu_torch.core.geometry import set_full_precision
    set_full_precision()
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _projs(V, h, w, dev):
    """K-folded projections of cameras translated along x, looking at a
    plane ~600 away (a few pixels of disparity per view)."""
    f = 1.2 * max(h, w)
    P = torch.zeros(V, 4, 4)
    for v in range(V):
        K = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
        E = torch.eye(4)
        E[0, 3] = -4.0 * v
        P[v, :3] = K @ E[:3]
        P[v, 3] = E[3]
    return P.to(dev)


@pytest.mark.parametrize("C,D", [(8, 8), (16, 32), (32, 48)])
def test_warp_variance_matches_plain(dev, C, D):
    V, h, w = 4, 24, 40
    g = _gen(dev, C)
    feats = torch.randn(V, h, w, C, device=dev, generator=g)
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = torch.full((h, w), 4.0, device=dev)
    projs = _projs(V, h, w, dev)
    n0 = K1.warp_variance.launches
    got = K1.warp_variance(feats, projs, lo, step, D)
    want = K1.warp_variance_plain(feats, projs, lo, step, D)
    torch.cuda.synchronize()
    assert K1.warp_variance.launches == n0 + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 8, 16, None), ("s2", 16, 32, None), ("t2", 64, 32, None),
    ("s1", 8, 1, None), ("s1", 8, 41, (6, 10, 20)), ("s1", 1, 8, None),
    ("s1", 64, 64, None), ("s2", 64, 64, None), ("t2", 64, 64, None),
    ("s1", 16, 8, (5, 9, 7)), ("s2", 16, 8, (7, 13, 11)),
    ("t2", 16, 8, (3, 5, 6))])
def test_conv3d_matches_plain(dev, mode, ci, co, shape):
    g = _gen(dev, ci + co)
    d, h, w = shape or ((4, 6, 10) if mode == "t2" else (8, 12, 20))
    x = torch.randn(1, ci, d, h, w, device=dev, generator=g)
    shape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    wgt = 0.1 * torch.randn(*shape, device=dev, generator=g)
    b = torch.randn(co, device=dev, generator=g)
    skip = None
    if mode == "t2":
        skip = torch.randn(1, co, 2 * d, 2 * h, 2 * w, device=dev,
                           generator=g)
    relu = co != 1
    got = K2.conv3d(x, wgt, b, mode, relu=relu, skip=skip)
    want = K2.conv3d_plain(x, wgt, b, mode, relu=relu, skip=skip)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", [2, 8, 13, 32, 48, 64, 65, 96, 192])
def test_depth_tail_matches_plain(dev, D):
    """The kernel's instances (8, 32, 48), its generic one (2, 13, 64) and
    its streaming one (65, 96, 192), on 40·52 = 2080 pixels (not a
    multiple of the 128-thread block)."""
    g = _gen(dev, D)
    h, w = 40, 52
    cost = 3 * torch.randn(D, h, w, device=dev, generator=g)
    lo = 425 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 2.5 + torch.rand(h, w, device=dev, generator=g)
    n0 = K4.depth_tail.launches
    depth, conf = K4.depth_tail(cost, lo, step)
    d_p, c_p = K4.depth_tail_plain(cost, lo, step)
    torch.cuda.synchronize()
    assert K4.depth_tail.launches == n0 + 1
    torch.testing.assert_close(depth, d_p, rtol=1e-5, atol=0)
    assert float(((conf - c_p).abs() > 1e-4).float().mean()) <= 1e-3


@pytest.mark.parametrize("k,stride,ci,co,up", [
    (3, 1, 3, 8, False), (5, 2, 8, 16, False), (1, 1, 32, 32, False),
    (3, 1, 32, 16, False), (1, 1, 16, 32, True)])
def test_conv2d_matches_plain(dev, k, stride, ci, co, up):
    g = _gen(dev, k * 100 + ci)
    x = torch.randn(3, ci, 24, 40, device=dev, generator=g)
    wgt = 0.2 * torch.randn(co, ci, k, k, device=dev, generator=g)
    scale = 0.5 + torch.rand(co, device=dev, generator=g)
    shift = torch.randn(co, device=dev, generator=g)
    ho, wo = (24 - 1) // stride + 1, (40 - 1) // stride + 1
    u = (torch.randn(3, co, ho // 2, wo // 2, device=dev, generator=g)
         if up else None)
    kw = dict(stride=stride, padding=k // 2, relu=not up, up=u)
    got = K5.conv2d(x, wgt, scale, shift, **kw)
    want = K5.conv2d_plain(x, wgt, scale, shift, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _close(got, want, tol=1e-4):
    """|got − want| ≤ tol · max|want| (+ tol)."""
    err = float((got - want).abs().max())
    assert err <= tol * (1.0 + float(want.abs().max())), err


@pytest.mark.parametrize("V,h,w,C,D", [
    (5, 81, 95, 32, 48), (3, 9, 7, 8, 5), (4, 5, 7, 16, 3),
    (8, 24, 40, 16, 8), (10, 12, 20, 32, 6)])
def test_warp_variance_odd_sizes_match_plain(dev, V, h, w, C, D):
    g = _gen(dev, h * w + C)
    feats = torch.randn(V, h, w, C, device=dev, generator=g)
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 3 + torch.rand(h, w, device=dev, generator=g)
    projs = _projs(V, h, w, dev)
    got = K1.warp_variance(feats, projs, lo, step, D)
    want = K1.warp_variance_plain(feats, projs, lo, step, D)
    dv = lo[None] + torch.arange(D, device=dev)[:, None, None] * step[None]
    route = K10.plane_sweep_variance_views(
        feats[:1], [feats[v:v + 1] for v in range(1, V)],
        [projs[v:v + 1] for v in range(1, V)], projs[:1],
        dv[None])[0].permute(3, 0, 1, 2)
    torch.cuda.synchronize()
    _close(got, want)
    assert float((got - route).abs().max()) <= 1e-5 * float(
        route.abs().max())


@pytest.mark.parametrize("k,stride,ci,co,h,w,layout,way", [
    (3, 1, 8, 8, 24, 40, "nchw", "tc"), (3, 1, 16, 16, 19, 38, "warp", "tc"),
    (3, 1, 32, 32, 9, 18, "nchw", "tc"), (3, 1, 32, 8, 24, 40, "warp", "tc"),
    (5, 2, 8, 16, 24, 40, "nchw", "tc"), (5, 2, 16, 32, 17, 30, "warp", "tc"),
    (1, 1, 32, 32, 12, 20, "warp", "direct"),
    (1, 1, 16, 32, 12, 20, "nchw", "direct"),
    (1, 1, 32, 16, 19, 38, "warp", "direct"),
    (3, 1, 3, 8, 24, 40, "nchw", "direct"),
    (3, 1, 3, 8, 19, 38, "warp", "direct")])
def test_conv2d_routes_match_plain(dev, k, stride, ci, co, h, w, layout,
                                   way):
    """Each route on shapes `route` gives it: the tensor cores for 3×3
    and 5×5 with 8 or more input channels, the direct kernel for the 1×1
    heads and 3 input channels; both layouts, aligned and unaligned
    widths."""
    assert K5.route(k, stride, k // 2, ci) == way
    g = _gen(dev, k * 1000 + ci * 10 + co)
    x = torch.randn(2, ci, h, w, device=dev, generator=g)
    wgt = 0.2 * torch.randn(co, ci, k, k, device=dev, generator=g)
    scale = 0.5 + torch.rand(co, device=dev, generator=g)
    shift = torch.randn(co, device=dev, generator=g)
    kw = dict(stride=stride, padding=k // 2, relu=True, out_layout=layout)
    got = K5.conv2d(x, wgt, scale, shift, **kw)
    want = K5.conv2d_plain(x, wgt, scale, shift, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("n,h,w,layout", [
    (3, 24, 40, "warp"), (2, 18, 38, "nchw"), (1, 40, 72, "warp")])
def test_lateral_conv2d_matches_plain(dev, n, h, w, layout):
    g = _gen(dev, h * w)
    up = torch.randn(n, 32, h // 2, w // 2, device=dev, generator=g)
    lat = torch.randn(n, 8, h, w, device=dev, generator=g)
    wi = 0.3 * torch.randn(32, 8, 1, 1, device=dev, generator=g)
    bi = torch.randn(32, device=dev, generator=g)
    wgt = 0.1 * torch.randn(8, 32, 3, 3, device=dev, generator=g)
    n0 = K5.conv2d.launches
    got = K5.lateral_conv2d(up, lat, wi, bi, wgt, layout)
    want = K5.lateral_conv2d_plain(up, lat, wi, bi, wgt, layout)
    torch.cuda.synchronize()
    assert K5.conv2d.launches == n0 + 1
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("C,D", [(8, 8), (16, 32), (32, 48)])
def test_warp_variance_train_matches_plain(dev, C, D):
    V, h, w = 4, 24, 40
    g = _gen(dev, 7 * C)
    feats = torch.randn(V, h, w, C, device=dev, generator=g)
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = torch.full((h, w), 4.0, device=dev)
    projs = _projs(V, h, w, dev)
    cot = torch.randn(C, D, h, w, device=dev, generator=g)
    x = feats.clone().requires_grad_(True)
    n0 = K1.warp_variance_bwd.launches
    var = K1.warp_variance_train(x, projs, lo, step, D)
    var.backward(cot)
    torch.cuda.synchronize()
    assert K1.warp_variance_bwd.launches == n0 + 1
    _close(var.detach(), K1.warp_variance_plain(feats, projs, lo, step, D))
    _close(x.grad, K1.warp_variance_bwd_plain(feats, projs, lo, step, cot))


@pytest.mark.parametrize("V,h,w,C,D", [
    (4, 32, 40, 32, 48), (2, 9, 7, 8, 5), (5, 13, 21, 16, 7),
    (4, 81, 95, 32, 48), (5, 11, 9, 32, 3), (2, 24, 40, 16, 32),
    (4, 7, 5, 8, 9)])
def test_warp_volume_matches_plain(dev, V, h, w, C, D):
    """K7 forward and backward at C 8/16/32, V 2/4/5, odd h, w and D (h·w
    not a multiple of a block's pixels, D not a multiple of the plane
    chunk): (var, vol) within 1e-4 of the plain version, vol in the
    render volume's layout, the gradients of both outputs' cotangents
    within 1e-4 of autograd through the plain version."""
    g = _gen(dev, h * w + C + V)
    feats = torch.randn(V, h, w, C, device=dev, generator=g)
    imgs = torch.rand(V, h, w, 3, device=dev, generator=g)
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 3 + torch.rand(h, w, device=dev, generator=g)
    projs = _projs(V, h, w, dev)
    x = feats.clone().requires_grad_(True)
    im = imgs.clone().requires_grad_(True)
    n0 = (K7.warp_volume.launches, K7.warp_volume_bwd.launches)
    outs = K7.warp_volume_train(x, im, projs, lo, step, D)
    want = K7.warp_volume_plain(feats, imgs, projs, lo, step, D)
    assert [tuple(o.shape) for o in outs] == [(C, D, h, w),
                                              (3 * (V - 1) + C, D, h, w)]
    cots = [torch.randn(o.shape, device=dev, generator=g) for o in outs]
    torch.autograd.backward(outs, cots)
    torch.cuda.synchronize()
    assert (K7.warp_volume.launches,
            K7.warp_volume_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    for got, ref in zip(outs, want):
        _close(got.detach(), ref)
    gf, gi = K7.warp_volume_bwd_plain(feats, imgs, projs, lo, step, *cots)
    _close(x.grad, gf)
    _close(im.grad, gi)


def test_forward_train_volume_is_k7_output(dev):
    """At B=1 forward_train returns K7's vol itself as volume_feature (a
    view of the same storage): no concatenation and no stack copies it."""
    from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet
    g = _gen(dev, 17)
    V, H, W = 3, 64, 96             # each stage's h, w divisible by 8
    model = CascadeMVSNet().to(dev).train()
    imgs = torch.randn(1, V, H, W, 3, device=dev, generator=g)
    projs = {}
    for s, sc in enumerate((4, 2, 1)):
        p = torch.zeros(1, V, 2, 4, 4, device=dev)
        p[0, :, 0] = torch.eye(4, device=dev)
        p[0, :, 0, 0, 3] = -4.0 * torch.arange(V, device=dev)
        f = 1.2 * max(H, W) / sc
        p[0, :, 1, :3, :3] = torch.tensor(
            [[f, 0, W / sc / 2], [0, f, H / sc / 2], [0, 0, 1.0]],
            device=dev)
        projs[f"stage{s + 1}"] = p
    dvals = torch.linspace(425, 935, 192, device=dev)[None]
    seen = []
    orig = K7.warp_volume

    def spy(*a):
        out = orig(*a)
        seen.append(out[1])
        return out
    spy.launches = 0           # the wrapper counts on the name it is bound to
    try:
        K7.warp_volume = spy
        _, vol = model.forward_train(imgs, projs, dvals, return_volume=True)
    finally:
        K7.warp_volume = orig
    torch.cuda.synchronize()
    assert len(seen) == 1
    assert vol.shape == (1, *seen[0].shape)
    assert vol.data_ptr() == seen[0].data_ptr()
    assert vol.untyped_storage().data_ptr() == \
        seen[0].untyped_storage().data_ptr()


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 8, 16, (8, 12, 20)), ("s2", 16, 32, (8, 12, 20)),
    ("t2", 64, 32, (4, 6, 10)), ("s1", 8, 1, (8, 12, 20)),
    ("s1", 41, 8, (16, 16, 20)), ("s1", 1, 8, (8, 12, 20)),
    ("s1", 64, 64, (4, 6, 10)), ("s2", 64, 64, (4, 6, 10)),
    ("t2", 64, 64, (2, 3, 5)), ("s1", 16, 8, (5, 9, 7)),
    ("s2", 16, 8, (7, 13, 11)), ("t2", 16, 8, (3, 5, 6)),
    ("s1", 64, 128, (4, 6, 10)), ("s2", 64, 128, (4, 6, 10)),
    ("t2", 128, 128, (2, 3, 5)), ("s1", 16, 72, (5, 9, 7))])
def test_conv3d_train_matches_plain(dev, mode, ci, co, shape):
    g = _gen(dev, ci * co)
    x = torch.randn(1, ci, *shape, device=dev, generator=g)
    wshape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    wgt = 0.1 * torch.randn(*wshape, device=dev, generator=g)
    xk, wk = x.clone().requires_grad_(True), wgt.clone().requires_grad_(True)
    xp, wp = x.clone().requires_grad_(True), wgt.clone().requires_grad_(True)
    n0 = (K2.conv3d.launches, K8.conv3d_dw.launches)
    yk = K8.conv3d_train(xk, wk, mode)
    yp = K8.conv3d_train_plain(xp, wp, mode)
    cot = torch.randn(yk.shape, device=dev, generator=g)
    yk.backward(cot)
    yp.backward(cot)
    torch.cuda.synchronize()
    assert (K2.conv3d.launches, K8.conv3d_dw.launches) == (n0[0] + 2,
                                                            n0[1] + 1)
    _close(yk.detach(), yp.detach())
    _close(xk.grad, xp.grad)
    _close(wk.grad, wp.grad)
    _close(K8.conv3d_dw(x, cot, mode), K8.conv3d_dw_plain(x, cot, mode))


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 41, 8, (16, 16, 20)), ("s2", 32, 64, (8, 12, 20)),
    ("t2", 16, 8, (4, 6, 10)), ("s1", 64, 128, (4, 6, 10))])
def test_conv3d_dw_repeats_bit_for_bit(dev, mode, ci, co, shape):
    """No atomics: two calls on the same inputs agree in every bit."""
    g = _gen(dev, ci + 3 * co)
    x = torch.randn(1, ci, *shape, device=dev, generator=g)
    cot = torch.randn(1, co, *K2.out_shape(mode, *shape), device=dev,
                      generator=g)
    first = K8.conv3d_dw(x, cot, mode)
    second = K8.conv3d_dw(x, cot, mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("kernel,C,D", [("k6", 8, 8), ("k6", 16, 32),
                                         ("k6", 32, 48), ("k7", 32, 48)])
def test_warp_backward_repeats_bit_for_bit(dev, kernel, C, D):
    """K6 and K7's backward sum in fixed point: two calls on the same
    inputs agree in every bit. A failure reports how many elements differ
    and by how much."""
    V, h, w = 4, 24, 40
    g = _gen(dev, 5 * C + D)
    feats = torch.randn(V, h, w, C, device=dev, generator=g)
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = torch.full((h, w), 4.0, device=dev)
    projs = _projs(V, h, w, dev)
    if kernel == "k6":
        cot = torch.randn(C, D, h, w, device=dev, generator=g)
        run = lambda: (K1.warp_variance_bwd(feats, projs, lo, step, cot),)
    else:
        imgs = torch.rand(V, h, w, 3, device=dev, generator=g)
        cots = [torch.randn(c, D, h, w, device=dev, generator=g)
                for c in (C, 3 * (V - 1) + C)]
        run = lambda: K7.warp_volume_bwd(feats, imgs, projs, lo, step, *cots)
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        n_diff = int((a != b).sum())
        delta = float((a - b).abs().max())
        print(f"{kernel} C{C} D{D} {tuple(a.shape)}: {n_diff} of "
              f"{a.numel()} elements differ, max |delta| {delta:.3e} "
              f"(max |value| {float(a.abs().max()):.3e})")
        assert torch.equal(a, b), (n_diff, delta)


@pytest.mark.parametrize("kernel,C,D,h,w", [
    ("k6", 8, 5, 13, 21), ("k6", 32, 3, 7, 9), ("k6", 16, 11, 9, 30),
    ("k7", 16, 6, 11, 13), ("k7", 8, 9, 5, 27)])
def test_warp_backward_odd_sizes_match_plain(dev, kernel, C, D, h, w):
    """K6 and K7's backward where the planes do not fill the staged chunks
    and the pixels do not fill the last block (h·w not a multiple of
    256 / C): within 1e-4 of autograd through the plain versions, and
    repeated bit for bit."""
    V = 4
    g = _gen(dev, C * D + h)
    feats = torch.randn(V, h, w, C, device=dev, generator=g)
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = torch.full((h, w), 4.0, device=dev)
    projs = _projs(V, h, w, dev)
    if kernel == "k6":
        cot = torch.randn(C, D, h, w, device=dev, generator=g)
        args = (feats, projs, lo, step, cot)
        run = lambda: (K1.warp_variance_bwd(*args),)
        want = (K1.warp_variance_bwd_plain(*args),)
    else:
        imgs = torch.rand(V, h, w, 3, device=dev, generator=g)
        cots = [torch.randn(c, D, h, w, device=dev, generator=g)
                for c in (C, 3 * (V - 1) + C)]
        args = (feats, imgs, projs, lo, step, *cots)
        run = lambda: K7.warp_volume_bwd(*args)
        want = K7.warp_volume_bwd_plain(*args)
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b, p in zip(first, second, want):
        assert torch.equal(a, b)
        _close(a, p)


@pytest.mark.parametrize("mode", ["s1", "s2", "t2"])
@pytest.mark.parametrize("shape", [(5, 9, 7), (3, 5, 6), (7, 13, 11)])
def test_conv3d_lanewise_odd_sizes_match_plain(dev, mode, shape):
    g = _gen(dev, sum(shape))
    ci, co = 16, 8
    x = torch.randn(1, ci, *shape, device=dev, generator=g)
    wshape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    wgt = 0.1 * torch.randn(*wshape, device=dev, generator=g)
    n0 = (K2.conv3d_lanewise.launches, K2.conv3d.launches)
    got = K2.conv3d_lanewise(x, wgt, mode)
    want = K2.conv3d_lanewise_plain(x, wgt, mode)
    torch.cuda.synchronize()
    assert (K2.conv3d_lanewise.launches, K2.conv3d.launches) == (n0[0] + 1,
                                                                  n0[1])
    assert got.shape == want.shape
    _close(got, want)


def _view_inputs(dev, V, h, w, C, D, seed):
    g = _gen(dev, seed)
    feats = torch.randn(V, h, w, C, device=dev, generator=g)
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = torch.full((h, w), 4.0, device=dev)
    projs = _projs(V, h, w, dev)
    return feats, projs, lo, step


@pytest.mark.parametrize("C", [3, 8, 16, 32])
def test_warp_view_matches_plain(dev, C):
    h, w, D = 24, 40, 8
    feats, projs, lo, step = _view_inputs(dev, 2, h, w, C, D, C)
    dv = lo[None] + torch.arange(D, device=dev)[:, None, None] * step[None]
    rel = K1.relative_projections(projs).reshape(-1, 4, 4)
    px, py = (c[0].contiguous()
              for c in K10.pixel_coords(rel[1:], dv[None], h, w))
    assert float(px.max()) > w - 1 or float(px.min()) < 0  # edge taps
    n0 = K10.warp_view.launches
    got = K10.warp_view(feats[1], px, py)
    want = K10.warp_view_plain(feats[1], px, py)
    torch.cuda.synchronize()
    assert K10.warp_view.launches == n0 + 1
    _close(got, want, 1e-5)


def test_warp_view_route_matches_k1(dev):
    V, h, w, C, D = 4, 24, 40, 16, 32
    feats, projs, lo, step = _view_inputs(dev, V, h, w, C, D, 11)
    dv = lo[None] + torch.arange(D, device=dev)[:, None, None] * step[None]
    route = K10.plane_sweep_variance_views(
        feats[:1], [feats[v:v + 1] for v in range(1, V)],
        [projs[v:v + 1] for v in range(1, V)], projs[:1], dv[None])[0]
    k1 = K1.warp_variance(feats, projs, lo, step, D).permute(1, 2, 3, 0)
    torch.cuda.synchronize()
    err = float((route - k1).abs().max())
    assert err <= 1e-5 * float(k1.abs().max()), err


def _edge_coords(h, w, D, dev, seed):
    """px, py [D, h, w] in pixel_coords' clip range, with samples on the
    clip bounds (−2, w+1, h+1) and whole rows out of the image."""
    g = _gen(dev, seed)
    px = torch.rand(D, h, w, device=dev, generator=g) * (w + 5.0) - 3.0
    py = torch.rand(D, h, w, device=dev, generator=g) * (h + 5.0) - 3.0
    px[:, :, 0], py[:, 0, :] = -2.0, h + 1.0
    px[:, :, -1] = w + 1.0
    px[0, h // 2, :] = -1.5                     # a row left of the image
    py[-1, h - 1, :] = h + 1.0                  # a row below it
    return px.clamp(-2.0, w + 1.0), py.clamp(-2.0, h + 1.0)


# (h, w, C, D): D·h·w not a multiple of a block's or a warp's samples,
# D = 1, C 3 and 12 (the scalar kernel) and 4..32 (the lane kernel)
K10_ODD = ((17, 33, 8, 3), (9, 7, 32, 1), (5, 7, 3, 2), (13, 29, 4, 5),
           (11, 37, 16, 1), (7, 9, 12, 2), (81, 95, 32, 5))


@pytest.mark.parametrize("h,w,C,D", K10_ODD)
def test_warp_view_odd_sizes_match_plain(dev, h, w, C, D):
    src = torch.randn(h, w, C, device=dev, generator=_gen(dev, C))
    px, py = _edge_coords(h, w, D, dev, h * w)
    got = K10.warp_view(src, px, py)
    want = K10.warp_view_plain(src, px, py)
    torch.cuda.synchronize()
    assert not got[0, h // 2].any() and not got[-1, h - 1].any()
    _close(got, want, 1e-5)


@pytest.mark.parametrize("h,w,C,D", [(54, 72, 32, 48), (108, 144, 16, 32),
                                     (216, 288, 8, 8), (13, 29, 3, 5)])
def test_warp_view_repeats_bit_for_bit(dev, h, w, C, D):
    src = torch.randn(h, w, C, device=dev, generator=_gen(dev, 7))
    px, py = _edge_coords(h, w, D, dev, 8)
    first = K10.warp_view(src, px, py)
    again = K10.warp_view(src, px, py)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_warp_view_refuses_past_its_grid(dev):
    """More planes than the grid's y dimension holds: the wrapper raises
    before a launch."""
    src = torch.zeros(2, 2, 8, device=dev)
    px = torch.zeros(65536, 2, 2, device=dev)
    n0 = K10.warp_view.launches
    with pytest.raises(ValueError, match="past the kernel's grid"):
        K10.warp_view(src, px, px)
    assert K10.warp_view.launches == n0


# ---- the bf16 instances (the bf16 eval path): each against its bf16
# plain version, which is the float32 plain version on the bf16 operands
# rounded where the kernel rounds; both round their float32 result once,
# after sums in another order, so they may land one bf16 ulp apart.

def _close_bf16(got, want):
    """|got − want| ≤ 2^-7·|want| + 1e-4·max|want| per element: one bf16
    ulp of each element plus 1e-4 of the largest value."""
    g, w = got.float(), want.float()
    tol = w.abs() * 2.0 ** -7 + 1e-4 * float(w.abs().max())
    over = int(((g - w).abs() > tol).sum())
    assert torch.isfinite(g).all() and over == 0, (
        over, float((g - w).abs().max()))


def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


@pytest.mark.parametrize("V,h,w,C,D", [
    (4, 24, 40, 8, 8), (4, 24, 40, 16, 32), (4, 24, 40, 32, 48),
    (3, 9, 7, 8, 5), (5, 13, 21, 16, 7), (8, 24, 40, 32, 8)])
def test_warp_variance_bf16_matches_plain(dev, V, h, w, C, D):
    g = _gen(dev, 3 * C + h)
    feats, = _bf16(torch.randn(V, h, w, C, device=dev, generator=g))
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 3 + torch.rand(h, w, device=dev, generator=g)
    projs = _projs(V, h, w, dev)
    n0 = (K1.warp_variance.launches, K1.warp_variance.bf16.launches)
    got = K1.warp_variance(feats, projs, lo, step, D)
    want = K1.warp_variance_plain(feats, projs, lo, step, D)
    torch.cuda.synchronize()
    assert (K1.warp_variance.launches,
            K1.warp_variance.bf16.launches) == (n0[0], n0[1] + 1)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (C, D, h, w)
    _close_bf16(got, want)


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 8, 16, None), ("s2", 16, 32, None), ("t2", 64, 32, None),
    ("s1", 8, 1, None), ("s1", 32, 8, None), ("s1", 64, 64, None),
    ("s2", 64, 64, None), ("t2", 16, 8, None), ("s1", 16, 8, (5, 9, 7)),
    ("s2", 8, 16, (7, 13, 11)), ("t2", 32, 16, (3, 5, 6))])
def test_conv3d_bf16_matches_plain(dev, mode, ci, co, shape):
    """Every mode, Ci 8 (one zero-padded k16 chunk) to 64, widths that
    stage 8-byte row vectors and widths that do not; the prob head (one
    output channel) writes float32."""
    g = _gen(dev, 5 * ci + co)
    d, h, w = shape or ((4, 6, 10) if mode == "t2" else (8, 12, 20))
    x, = _bf16(torch.randn(1, ci, d, h, w, device=dev, generator=g))
    shape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    wgt, = _bf16(0.1 * torch.randn(*shape, device=dev, generator=g))
    b = torch.randn(co, device=dev, generator=g)
    skip = None
    if mode == "t2":
        skip, = _bf16(torch.randn(1, co, 2 * d, 2 * h, 2 * w, device=dev,
                                  generator=g))
    prob = co == 1
    kw = dict(relu=not prob, skip=skip,
              out_dtype=torch.float32 if prob else None)
    n0 = (K2.conv3d.launches, K2.conv3d.bf16.launches)
    got = K2.conv3d(x, wgt, b, mode, **kw)
    want = K2.conv3d_plain(x, wgt, b, mode, **kw)
    torch.cuda.synchronize()
    assert (K2.conv3d.launches, K2.conv3d.bf16.launches) == (n0[0],
                                                             n0[1] + 1)
    assert got.dtype == want.dtype == (torch.float32 if prob
                                       else torch.bfloat16)
    _close_bf16(got, want)


@pytest.mark.parametrize("k,stride,ci,co,h,w,layout,way,up", [
    (3, 1, 8, 8, 24, 40, "nchw", "tc", False),
    (3, 1, 16, 16, 19, 38, "warp", "tc", False),
    (3, 1, 32, 32, 9, 18, "nchw", "tc", False),
    (3, 1, 32, 16, 24, 40, "warp", "tc", False),
    (5, 2, 8, 16, 24, 40, "nchw", "tc", False),
    (5, 2, 16, 32, 17, 30, "warp", "tc", False),
    (1, 1, 32, 32, 12, 20, "warp", "direct", False),
    (1, 1, 16, 32, 12, 20, "nchw", "direct", True),
    (3, 1, 3, 8, 24, 40, "nchw", "direct", False),
    (3, 1, 3, 8, 19, 38, "warp", "direct", False)])
def test_conv2d_bf16_routes_match_plain(dev, k, stride, ci, co, h, w,
                                        layout, way, up):
    """Both routes of K5's bf16 instance, both layouts, aligned and
    unaligned widths, the upsample-add (inner1's call)."""
    assert K5.route(k, stride, k // 2, ci) == way
    g = _gen(dev, k * 100 + ci + co)
    x, wgt = _bf16(torch.randn(2, ci, h, w, device=dev, generator=g),
                   0.2 * torch.randn(co, ci, k, k, device=dev, generator=g))
    shift = torch.randn(co, device=dev, generator=g)
    upt = None
    if up:
        upt, = _bf16(torch.randn(2, co, h // 2, w // 2, device=dev,
                                 generator=g))
    kw = dict(stride=stride, padding=k // 2, relu=not up, up=upt,
              out_layout=layout)
    n0 = (K5.conv2d.launches, K5.conv2d.bf16.launches)
    got = K5.conv2d(x, wgt, None, shift, **kw)
    want = K5.conv2d_plain(x, wgt, None, shift, **kw)
    torch.cuda.synchronize()
    assert (K5.conv2d.launches, K5.conv2d.bf16.launches) == (n0[0],
                                                             n0[1] + 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close_bf16(got, want)


@pytest.mark.parametrize("n,h,w,layout", [
    (3, 24, 40, "warp"), (2, 18, 38, "nchw"), (1, 40, 72, "warp")])
def test_lateral_conv2d_bf16_matches_plain(dev, n, h, w, layout):
    g = _gen(dev, h * w + 1)
    up, lat, wi, wgt = _bf16(
        torch.randn(n, 32, h // 2, w // 2, device=dev, generator=g),
        torch.randn(n, 8, h, w, device=dev, generator=g),
        0.3 * torch.randn(32, 8, 1, 1, device=dev, generator=g),
        0.1 * torch.randn(8, 32, 3, 3, device=dev, generator=g))
    bi = torch.randn(32, device=dev, generator=g)
    n0 = K5.conv2d.bf16.launches
    got = K5.lateral_conv2d(up, lat, wi, bi, wgt, layout)
    want = K5.lateral_conv2d_plain(up, lat, wi, bi, wgt, layout)
    torch.cuda.synchronize()
    assert K5.conv2d.bf16.launches == n0 + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close_bf16(got, want)


def test_bf16_cascade_runs_the_bf16_instances(dev):
    """eval_dtype='bfloat16' on the card: K5, K1 and K2 run only their bf16
    instances, K4 its float32 one, the plain path launches nothing, and
    the depth agrees with the bf16 plain path (no pixel beyond 0.01
    relative)."""
    import numpy as np
    from rcmvsnet_tpu_torch.config import BackboneConfig
    from rcmvsnet_tpu_torch.data.plane_scene import dtu_samples, plane_scene
    from rcmvsnet_tpu_torch.models.cascade import CascadeMVSNet, infer_views
    from rcmvsnet_tpu_torch.weights import ASSET, load_state_dict
    model = CascadeMVSNet(BackboneConfig(ndepths=(16, 8, 8),
                                         eval_dtype="bfloat16"))
    model.load_state_dict(load_state_dict(ASSET), strict=True)
    model = model.to(dev).eval()
    samples = dtu_samples(plane_scene(64, 96, 3, 5), 64)[:1]
    wrappers = [K5.conv2d, K1.warp_variance, K2.conv3d, K5.conv2d.bf16,
                K1.warp_variance.bf16, K2.conv3d.bf16, K4.depth_tail]
    counts, depths = [], []
    for plain in (False, True):
        for fn in wrappers:
            fn.launches = 0
        depths.append(infer_views(model, samples, dev, plain=plain)[0][0])
        counts.append([fn.launches for fn in wrappers])
    dk, dp = depths
    assert counts[0][:3] == [0, 0, 0] and min(counts[0][3:]) > 0, counts
    assert counts[1] == [0] * len(wrappers), counts
    assert np.isfinite(dk).all()
    assert float((np.abs(dk - dp) / np.abs(dp)).max()) <= 0.01


# ---- the bf16 train instances (the bf16 train path): K6, K7 forward and
# backward, K8 (K2's train modes and the dw kernel) against their bf16
# plain versions; dw (float32 out) to 1e-4 of its largest value.

@pytest.mark.parametrize("V,h,w,C,D", [
    (4, 24, 40, 8, 8), (4, 24, 40, 16, 32), (4, 24, 40, 32, 48),
    (4, 13, 21, 8, 5), (3, 7, 9, 32, 3)])
def test_warp_variance_bwd_bf16_matches_plain(dev, V, h, w, C, D):
    """K6's bf16 instance under autograd (the bf16 forward, then the
    backward) against the bf16 plain pair, and repeated bit for bit."""
    g = _gen(dev, 11 * C + D)
    feats, cot = _bf16(torch.randn(V, h, w, C, device=dev, generator=g),
                       torch.randn(C, D, h, w, device=dev, generator=g))
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 3 + torch.rand(h, w, device=dev, generator=g)
    projs = _projs(V, h, w, dev)
    x = feats.clone().requires_grad_(True)
    n0 = (K1.warp_variance_bwd.launches, K1.warp_variance_bwd.bf16.launches)
    K1.warp_variance_train(x, projs, lo, step, D).backward(cot)
    again = K1.warp_variance_bwd(feats, projs, lo, step, cot)
    want = K1.warp_variance_bwd_plain(feats, projs, lo, step, cot)
    torch.cuda.synchronize()
    assert (K1.warp_variance_bwd.launches,
            K1.warp_variance_bwd.bf16.launches) == (n0[0], n0[1] + 2)
    assert x.grad.dtype == want.dtype == torch.bfloat16
    assert torch.equal(x.grad, again)
    _close_bf16(x.grad, want)


@pytest.mark.parametrize("V,h,w,C,D", [
    (4, 32, 40, 32, 48), (2, 9, 7, 8, 5), (5, 13, 21, 16, 7)])
def test_warp_volume_bf16_matches_plain(dev, V, h, w, C, D):
    """K7's bf16 instances, forward (var and the render volume) and
    backward (features and images), against their bf16 plain versions;
    the backward repeated bit for bit."""
    g = _gen(dev, 13 * C + V)
    feats, imgs = _bf16(torch.randn(V, h, w, C, device=dev, generator=g),
                        torch.rand(V, h, w, 3, device=dev, generator=g))
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 3 + torch.rand(h, w, device=dev, generator=g)
    projs = _projs(V, h, w, dev)
    args = (feats, imgs, projs, lo, step)
    n0 = (K7.warp_volume.launches, K7.warp_volume.bf16.launches,
          K7.warp_volume_bwd.launches, K7.warp_volume_bwd.bf16.launches)
    got = K7.warp_volume(*args, D)
    want = K7.warp_volume_plain(*args, D)
    cots = _bf16(*(torch.randn(c, D, h, w, device=dev, generator=g)
                   for c in (C, 3 * (V - 1) + C)))
    first = K7.warp_volume_bwd(*args, *cots)
    second = K7.warp_volume_bwd(*args, *cots)
    want_b = K7.warp_volume_bwd_plain(*args, *cots)
    torch.cuda.synchronize()
    assert (K7.warp_volume.launches, K7.warp_volume.bf16.launches,
            K7.warp_volume_bwd.launches,
            K7.warp_volume_bwd.bf16.launches) == (n0[0], n0[1] + 1, n0[2],
                                                  n0[3] + 2)
    for a, p in zip(got, want):
        assert a.dtype == p.dtype == torch.bfloat16
        _close_bf16(a, p)
    for a, b, p in zip(first, second, want_b):
        assert a.dtype == p.dtype == torch.bfloat16
        assert torch.equal(a, b)
        _close_bf16(a, p)


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 8, 16, (8, 12, 20)), ("s2", 16, 32, (8, 12, 20)),
    ("t2", 64, 32, (4, 6, 10)), ("prob", 8, 1, (8, 12, 20)),
    ("s1", 41, 8, (16, 16, 20)), ("s1", 64, 64, (4, 6, 10)),
    ("s2", 64, 64, (4, 6, 10)), ("t2", 64, 64, (2, 3, 5)),
    ("s1", 16, 8, (5, 9, 7)), ("s2", 16, 8, (7, 13, 11)),
    ("t2", 16, 8, (3, 5, 6)), ("s1", 64, 128, (4, 6, 10)),
    ("s2", 64, 128, (4, 6, 10))])
def test_conv3d_train_bf16_matches_plain(dev, mode, ci, co, shape):
    """K8's bf16 instances (K2-bf16 forward and adjoint, the bf16 dw
    kernel) under autograd against the bf16 plain pair: odd sizes (the
    stride-2 adjoint trimmed to them), 41 input channels, two Co groups
    of dw, and the prob head's float32 output and cotangent."""
    g = _gen(dev, 3 * ci + co)
    prob = mode == "prob"
    mode = "s1" if prob else mode
    x, = _bf16(torch.randn(1, ci, *shape, device=dev, generator=g))
    wshape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    wgt = 0.1 * torch.randn(*wshape, device=dev, generator=g)
    out = torch.float32 if prob else None
    xk, wk = x.clone().requires_grad_(True), wgt.clone().requires_grad_(True)
    xp, wp = x.clone().requires_grad_(True), wgt.clone().requires_grad_(True)
    n0 = (K2.conv3d.launches, K2.conv3d.bf16.launches,
          K8.conv3d_dw.launches, K8.conv3d_dw.bf16.launches)
    yk = K8.conv3d_train(xk, wk, mode, out_dtype=out)
    yp = K8.conv3d_train_plain(xp, wp, mode, out_dtype=out)
    cot = torch.randn(yk.shape, device=dev, generator=g).to(yk.dtype)
    yk.backward(cot)
    yp.backward(cot)
    torch.cuda.synchronize()
    assert (K2.conv3d.launches, K2.conv3d.bf16.launches,
            K8.conv3d_dw.launches, K8.conv3d_dw.bf16.launches) == (
        n0[0], n0[1] + 2, n0[2], n0[3] + 1)
    assert yk.dtype == yp.dtype == (torch.float32 if prob
                                    else torch.bfloat16)
    assert xk.grad.dtype == torch.bfloat16
    assert wk.grad.dtype == torch.float32
    _close_bf16(yk.detach(), yp.detach())
    _close_bf16(xk.grad, xp.grad)
    torch.testing.assert_close(wk.grad, wp.grad, rtol=0,
                               atol=1e-4 * float(wp.grad.abs().max()))


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 41, 8, (16, 16, 20)), ("s2", 32, 64, (8, 12, 20)),
    ("t2", 16, 8, (4, 6, 10)), ("s1", 64, 128, (4, 6, 10))])
def test_conv3d_dw_bf16_repeats_bit_for_bit(dev, mode, ci, co, shape):
    """The bf16 dw kernel: no atomics, two calls agree in every bit; a
    float32 cotangent beside a bf16 x is refused."""
    g = _gen(dev, 5 * ci + co)
    x, cot = _bf16(torch.randn(1, ci, *shape, device=dev, generator=g),
                   torch.randn(1, co, *K2.out_shape(mode, *shape),
                               device=dev, generator=g))
    first = K8.conv3d_dw(x, cot, mode)
    second = K8.conv3d_dw(x, cot, mode)
    torch.cuda.synchronize()
    assert first.dtype == torch.float32 and torch.equal(first, second)
    with pytest.raises(TypeError):
        K8.conv3d_dw(x, cot.float(), mode)


# ---- K2-bf16 and K8dw-bf16 (their own designs): every mode at the
# widths the U-Nets and the render U-Net run (Co 1, 8, 16, 72, 128; Ci 8
# and 41), odd sizes and the 2·in − 1 outputs of a stride-2 adjoint

@pytest.mark.parametrize("mode,ci,co,shape,kind", [
    ("s1", 8, 1, (5, 9, 7), "prob"), ("s1", 8, 8, (8, 12, 24), "eval"),
    ("s1", 41, 8, (6, 11, 19), "eval"), ("s1", 8, 41, (4, 9, 17), "train"),
    ("s1", 41, 72, (3, 7, 9), "train"), ("s1", 16, 128, (2, 6, 10), "eval"),
    ("s2", 8, 16, (9, 13, 23), "eval"), ("s2", 41, 8, (7, 9, 11), "train"),
    ("s2", 8, 72, (5, 7, 9), "train"), ("s2", 64, 128, (4, 6, 10), "eval"),
    ("t2", 16, 8, (3, 5, 6), "eval"), ("t2", 8, 16, (3, 6, 8), "eval"),
    ("t2", 41, 72, (2, 3, 5), "train"), ("t2", 128, 8, (2, 3, 5), "train"),
    ("t2", 16, 8, (4, 5, 7), "odd")])
def test_conv3d_bf16_widths_match_plain(dev, mode, ci, co, shape, kind):
    """K2-bf16 at the U-Nets' widths in every mode: "eval" with a bias,
    ReLU and (t2) the skip, "train" raw, "prob" the float32 output, "odd"
    a t2 output of 2n − 1 per axis."""
    g = _gen(dev, 7 * ci + co)
    x, = _bf16(torch.randn(1, ci, *shape, device=dev, generator=g))
    wshape = (ci, co, 3, 3, 3) if mode == "t2" else (co, ci, 3, 3, 3)
    wgt, = _bf16(0.1 * torch.randn(*wshape, device=dev, generator=g))
    b = (torch.randn(co, device=dev, generator=g) if kind == "eval"
         else torch.zeros(co, device=dev))
    kw = dict(relu=kind == "eval")
    if kind == "eval" and mode == "t2":
        kw["skip"], = _bf16(torch.randn(1, co, *K2.out_shape(mode, *shape),
                                        device=dev, generator=g))
    if kind == "prob":
        kw["out_dtype"] = torch.float32
    if kind == "odd":
        kw["out_dhw"] = tuple(2 * n - 1 for n in shape)
    n0 = K2.conv3d.bf16.launches
    got = K2.conv3d(x, wgt, b, mode, **kw)
    want = K2.conv3d_plain(x, wgt, b, mode, **kw)
    torch.cuda.synchronize()
    assert K2.conv3d.bf16.launches == n0 + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    _close_bf16(got, want)


@pytest.mark.parametrize("mode,ci,co,shape", [
    ("s1", 8, 1, (5, 9, 7)), ("s1", 8, 8, (8, 12, 24)),
    ("s1", 41, 8, (6, 11, 19)), ("s1", 8, 16, (4, 9, 17)),
    ("s1", 41, 72, (3, 7, 9)), ("s1", 16, 128, (2, 6, 10)),
    ("s2", 8, 16, (9, 13, 23)), ("s2", 41, 8, (7, 9, 11)),
    ("s2", 8, 72, (5, 7, 9)), ("s2", 64, 128, (4, 6, 10)),
    ("t2", 16, 8, (3, 5, 6)), ("t2", 8, 16, (3, 6, 8)),
    ("t2", 41, 72, (2, 3, 5)), ("t2", 128, 8, (2, 3, 5)),
    ("t2", 8, 1, (3, 5, 7))])
def test_conv3d_dw_bf16_widths_match_plain(dev, mode, ci, co, shape):
    """K8dw-bf16 at the U-Nets' widths in every mode, odd sizes: float32
    dW within 1e-4 of its largest value."""
    g = _gen(dev, 11 * ci + co)
    x, cot = _bf16(torch.randn(1, ci, *shape, device=dev, generator=g),
                   torch.randn(1, co, *K2.out_shape(mode, *shape),
                               device=dev, generator=g))
    n0 = K8.conv3d_dw.bf16.launches
    got = K8.conv3d_dw(x, cot, mode)
    want = K8.conv3d_dw_plain(x, cot, mode)
    torch.cuda.synchronize()
    assert K8.conv3d_dw.bf16.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


def test_conv3d_dw_bf16_long_chain_within_gate(dev):
    """One run of every brick (the 30720 positions of an 8 x 64 x 60
    grid a block) through the C entry: the flush once a brick keeps dW within 1e-4 of its largest
    value, where one tensor-core accumulator over such a run read 2.25e-4
    (tc_conv3d.cuh's accumulation note)."""
    g = _gen(dev, 30720)
    shape = (8, 64, 60)
    x, cot = _bf16(torch.randn(1, 8, *shape, device=dev, generator=g),
                   torch.randn(1, 8, *shape, device=dev, generator=g))
    plan = K8.dw_plan_bf16("s1", 1, 8, 8, *shape)
    partial = torch.empty((1, 8, 8, 27), dtype=torch.float32, device=dev)
    dw = torch.empty((8, 8, 27), dtype=torch.float32, device=dev)
    err = K8._lib("conv3d_dw_bf16", "conv3d_dw_bf16")(
        x.data_ptr(), cot.data_ptr(), partial.data_ptr(), dw.data_ptr(), 1,
        8, *shape, 8, *shape, K8.MODES["s1"], 1, plan.bricks,
        plan.brick[1], torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    _close(dw.reshape(8, 8, 3, 3, 3), K8.conv3d_dw_plain(x, cot, "s1"))


def test_bf16_train_step_runs_the_bf16_instances(dev):
    """train_dtype bfloat16 on the card: one train step launches the bf16
    instances of K1, K6, K7 (both), K2 and K8 dw, and no float32 instance
    of them; parameters and Adam's moments stay float32."""
    from rcmvsnet_tpu_torch.config import (BackboneConfig, Config,
                                           RenderConfig)
    from rcmvsnet_tpu_torch.data.synthetic import batch_from_views
    from rcmvsnet_tpu_torch.data.plane_scene import plane_scene
    from rcmvsnet_tpu_torch.train.state import create_train_state
    from rcmvsnet_tpu_torch.train.step import (batch_to, draw_step,
                                               make_train_step)
    cfg = Config(backbone=BackboneConfig(ndepths=(16, 8, 8),
                                         train_dtype="bfloat16"),
                 render=RenderConfig(n_rays=64, n_samples=16, num_planes=32))
    batch = batch_to(batch_from_views([plane_scene(64, 96, 3, 0)], 64, 0),
                     dev)
    state = create_train_state(cfg, 3, 10, dev)
    draws = draw_step(torch.Generator(device=dev).manual_seed(0), cfg, 1,
                      64, 96)
    counts = {"warp_variance": K1.warp_variance,
              "warp_variance_bwd": K1.warp_variance_bwd,
              "warp_volume": K7.warp_volume,
              "warp_volume_bwd": K7.warp_volume_bwd,
              "conv3d": K2.conv3d, "conv3d_dw": K8.conv3d_dw}
    n0 = {k: (f.launches, f.bf16.launches) for k, f in counts.items()}
    metrics = make_train_step(cfg)(state, batch, draws)
    torch.cuda.synchronize()
    for k, f in counts.items():
        assert f.launches == n0[k][0], k
        assert f.bf16.launches > n0[k][1], k
    assert all(torch.isfinite(v) for k, v in metrics.items()
               if k != "images")
    for p in list(state.cascade.parameters()) + list(
            state.render.parameters()):
        assert p.dtype == torch.float32
    for st in state.optimizer.state.values():
        assert st["exp_avg"].dtype == torch.float32


# ---- K1-bf16 and K6-bf16, the designs of `csrc/warp_variance_bf16.cu`:
# C 8/16/32, every view-count instance (the buckets of at most 3, 7 and 15
# source views: V 3-4, 5-8 and 10; K6-bf16's own at V 4), h·w that no
# block's pixels divide (P = 2048/C forward, 1024/C backward), h·w % 8 != 0
# (element-wise stores and staging of g), D not a multiple of K6's 8-plane
# chunk, D = 96 (the wide configuration's stage 1).

@pytest.mark.parametrize("V,h,w,C,D", [
    (3, 9, 7, 8, 5), (5, 13, 21, 16, 13), (8, 11, 29, 32, 7),
    (4, 24, 40, 32, 96), (7, 16, 24, 16, 9), (5, 24, 40, 8, 8),
    (10, 8, 12, 8, 4), (4, 20, 36, 16, 11)])
def test_warp_variance_bf16_design_matches_plain(dev, V, h, w, C, D):
    g = _gen(dev, 7 * C + V + D)
    feats, = _bf16(torch.randn(V, h, w, C, device=dev, generator=g))
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 3 + torch.rand(h, w, device=dev, generator=g)
    projs = _projs(V, h, w, dev)
    n0 = (K1.warp_variance.launches, K1.warp_variance.bf16.launches)
    got = K1.warp_variance(feats, projs, lo, step, D)
    want = K1.warp_variance_plain(feats, projs, lo, step, D)
    torch.cuda.synchronize()
    assert (K1.warp_variance.launches,
            K1.warp_variance.bf16.launches) == (n0[0], n0[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == (C, D, h, w)
    _close_bf16(got, want)


@pytest.mark.parametrize("V,h,w,C,D", [
    (3, 9, 7, 8, 5), (5, 13, 21, 16, 13), (8, 11, 29, 32, 7),
    (4, 24, 40, 32, 96), (4, 20, 36, 16, 11), (4, 13, 21, 8, 9),
    (10, 8, 12, 8, 4)])
def test_warp_variance_bwd_bf16_design_matches_plain(dev, V, h, w, C, D):
    """K6-bf16 against its bf16 plain version, and to itself on repeat in
    every bit."""
    g = _gen(dev, 5 * C + V + D)
    feats, cot = _bf16(torch.randn(V, h, w, C, device=dev, generator=g),
                       torch.randn(C, D, h, w, device=dev, generator=g))
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 3 + torch.rand(h, w, device=dev, generator=g)
    projs = _projs(V, h, w, dev)
    n0 = (K1.warp_variance_bwd.launches, K1.warp_variance_bwd.bf16.launches)
    first = K1.warp_variance_bwd(feats, projs, lo, step, cot)
    second = K1.warp_variance_bwd(feats, projs, lo, step, cot)
    want = K1.warp_variance_bwd_plain(feats, projs, lo, step, cot)
    torch.cuda.synchronize()
    assert (K1.warp_variance_bwd.launches,
            K1.warp_variance_bwd.bf16.launches) == (n0[0], n0[1] + 2)
    assert first.dtype == torch.bfloat16 and first.shape == feats.shape
    assert torch.equal(first, second)
    _close_bf16(first, want)


# ---- K5-bf16's own design (`csrc/conv2d_bf16.cu`): the tensor-core route
# at stride 1 and 2 with 8-channel chunks (Ci 8, m16n8k8) and 16-channel
# ones (Ci 16, 24 with a half-empty chunk, 32 in two chunks), the direct
# route at Ci 3 and the 1×1 heads, both layouts, widths whose rows are
# whole 16-byte vectors and widths that are not, a source that does not
# start on 16 bytes (element-wise staging), the upsample-add on both
# routes, and the lateral head at Cu 16/24/32, Cl 3/8, up rows of whole
# vectors and not.

@pytest.mark.parametrize("k,stride,ci,co,h,w,layout,way,up,shifted", [
    (3, 1, 8, 8, 24, 40, "nchw", "tc", False, False),
    (3, 1, 8, 8, 19, 38, "warp", "tc", False, False),
    (3, 1, 16, 16, 24, 40, "nchw", "tc", True, False),
    (3, 1, 16, 16, 20, 38, "warp", "tc", True, False),
    (3, 1, 24, 8, 20, 36, "nchw", "tc", False, False),
    (3, 1, 32, 32, 9, 18, "nchw", "tc", False, True),
    (3, 1, 32, 16, 24, 40, "warp", "tc", False, False),
    (5, 2, 8, 16, 24, 40, "nchw", "tc", False, False),
    (5, 2, 8, 16, 17, 30, "warp", "tc", False, True),
    (5, 2, 16, 32, 17, 30, "warp", "tc", False, False),
    (5, 2, 32, 32, 24, 40, "nchw", "tc", False, False),
    (3, 1, 3, 8, 24, 40, "nchw", "direct", False, False),
    (3, 1, 3, 8, 19, 38, "warp", "direct", False, True),
    (1, 1, 32, 32, 12, 20, "warp", "direct", False, False),
    (1, 1, 32, 16, 19, 38, "warp", "direct", False, False),
    (1, 1, 16, 32, 12, 24, "nchw", "direct", True, False),
    (1, 1, 16, 32, 12, 18, "nchw", "direct", True, True)])
def test_conv2d_bf16_design_matches_plain(dev, k, stride, ci, co, h, w,
                                          layout, way, up, shifted):
    assert K5.route(k, stride, k // 2, ci) == way
    g = _gen(dev, 31 * ci + co + k + h)
    x, wgt = _bf16(torch.randn(2, ci, h, w, device=dev, generator=g),
                   0.2 * torch.randn(co, ci, k, k, device=dev, generator=g))
    if shifted:                    # the same values one element further on
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    shift = torch.randn(co, device=dev, generator=g)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    upt = None
    if up:
        upt, = _bf16(torch.randn(2, co, ho // 2, wo // 2, device=dev,
                                 generator=g))
    kw = dict(stride=stride, padding=k // 2, relu=not up, up=upt,
              out_layout=layout)
    n0 = (K5.conv2d.launches, K5.conv2d.bf16.launches)
    got = K5.conv2d(x, wgt, None, shift, **kw)
    want = K5.conv2d_plain(x, wgt, None, shift, **kw)
    torch.cuda.synchronize()
    assert (K5.conv2d.launches, K5.conv2d.bf16.launches) == (n0[0],
                                                             n0[1] + 1)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close_bf16(got, want)


@pytest.mark.parametrize("k,s,mt,ntb", [
    (k, s, mt, ntb) for (k, s), tiles in K5.TILES_BF16.items()
    for mt, ntb in tiles])
@pytest.mark.parametrize("ci", [8, 32])
def test_conv2d_bf16_every_tile_matches_plain(dev, monkeypatch, k, s, mt,
                                              ntb, ci):
    """Every tensor-core tile of K5-bf16 (the wrapper's `tile` pinned to
    it), 8-channel and 16-channel chunks, 24 output channels (a partial
    n8 group where NTB = 2 or 4), odd sizes."""
    monkeypatch.setattr(K5, "tile", lambda *a, **kw: (mt, ntb))
    g = _gen(dev, 100 * mt + 10 * ntb + ci + k)
    x, wgt = _bf16(torch.randn(2, ci, 37, 45, device=dev, generator=g),
                   0.2 * torch.randn(24, ci, k, k, device=dev, generator=g))
    shift = torch.randn(24, device=dev, generator=g)
    kw = dict(stride=s, padding=k // 2, relu=True)
    got = K5.conv2d(x, wgt, None, shift, **kw)
    want = K5.conv2d_plain(x, wgt, None, shift, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    _close_bf16(got, want)


@pytest.mark.parametrize("n,cu,cl,h,w,layout", [
    (3, 32, 8, 24, 40, "warp"), (2, 16, 8, 18, 38, "nchw"),
    (1, 24, 3, 40, 72, "warp"), (2, 32, 8, 34, 68, "nchw")])
def test_lateral_conv2d_bf16_design_matches_plain(dev, n, cu, cl, h, w,
                                                  layout):
    g = _gen(dev, h * w + cu + cl)
    up, lat, wi, wgt = _bf16(
        torch.randn(n, cu, h // 2, w // 2, device=dev, generator=g),
        torch.randn(n, cl, h, w, device=dev, generator=g),
        0.3 * torch.randn(cu, cl, 1, 1, device=dev, generator=g),
        0.1 * torch.randn(8, cu, 3, 3, device=dev, generator=g))
    bi = torch.randn(cu, device=dev, generator=g)
    n0 = K5.conv2d.bf16.launches
    got = K5.lateral_conv2d(up, lat, wi, bi, wgt, layout)
    want = K5.lateral_conv2d_plain(up, lat, wi, bi, wgt, layout)
    torch.cuda.synchronize()
    assert K5.conv2d.bf16.launches == n0 + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close_bf16(got, want)


# ---- K7bwd-bf16's own design (`csrc/warp_volume_bf16.cu`): C 8/16/32,
# every view-count instance (its own at V 4, the buckets of at most 3, 7
# and 15 source views), h·w that no block's pixels (1024 / C) divide and
# h·w % 8 != 0 (element-wise staging of the cotangents), D 5-13 (not a
# multiple of the 8-plane chunk) and 48 (the train step's stage 1).

@pytest.mark.parametrize("V,h,w,C,D", [
    (4, 32, 40, 32, 48), (3, 9, 7, 8, 5), (5, 13, 21, 16, 13),
    (8, 11, 29, 32, 7), (10, 8, 12, 8, 6), (4, 13, 21, 8, 9),
    (4, 20, 36, 16, 11), (2, 9, 7, 16, 5)])
def test_warp_volume_bwd_bf16_design_matches_plain(dev, V, h, w, C, D):
    """K7bwd-bf16 against its bf16 plain version (features and images), and
    to itself on repeat in every bit."""
    g = _gen(dev, 11 * C + V + D)
    feats, imgs = _bf16(torch.randn(V, h, w, C, device=dev, generator=g),
                        torch.rand(V, h, w, 3, device=dev, generator=g))
    cots = _bf16(*(torch.randn(c, D, h, w, device=dev, generator=g)
                   for c in (C, 3 * (V - 1) + C)))
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 3 + torch.rand(h, w, device=dev, generator=g)
    args = (feats, imgs, _projs(V, h, w, dev), lo, step, *cots)
    n0 = (K7.warp_volume_bwd.launches, K7.warp_volume_bwd.bf16.launches)
    first = K7.warp_volume_bwd(*args)
    second = K7.warp_volume_bwd(*args)
    want = K7.warp_volume_bwd_plain(*args)
    torch.cuda.synchronize()
    assert (K7.warp_volume_bwd.launches,
            K7.warp_volume_bwd.bf16.launches) == (n0[0], n0[1] + 2)
    for a, b, p in zip(first, second, want):
        assert a.dtype == torch.bfloat16 and a.shape == p.shape
        assert torch.equal(a, b)
        _close_bf16(a, p)


# ---- K7-bf16's own design (`csrc/warp_volume_bf16.cu`): C 8/16/32, every
# view-count instance (its own at V 4, the buckets of at most 3, 7 and 15
# source views, V = MAX_VIEWS at C 8: the largest staging), h·w that no
# block's pixels (2048 / C) divide and h·w % 8 != 0 (element-wise stores),
# D 5-13 and 48 (the train step's stage 1).

@pytest.mark.parametrize("V,h,w,C,D", [
    (4, 32, 40, 32, 48), (4, 13, 21, 8, 9), (4, 20, 36, 16, 11),
    (3, 9, 7, 8, 5), (2, 9, 7, 16, 5), (5, 13, 21, 16, 13),
    (8, 11, 29, 32, 7), (10, 8, 12, 8, 6), (16, 8, 12, 8, 4),
    (16, 9, 7, 32, 5)])
def test_warp_volume_bf16_design_matches_plain(dev, V, h, w, C, D):
    """K7-bf16 against its bf16 plain version (var and the render
    volume), and a second launch equal to the first in every bit."""
    g = _gen(dev, 17 * C + V + D)
    feats, imgs = _bf16(torch.randn(V, h, w, C, device=dev, generator=g),
                        torch.rand(V, h, w, 3, device=dev, generator=g))
    lo = 560 + 10 * torch.rand(h, w, device=dev, generator=g)
    step = 3 + torch.rand(h, w, device=dev, generator=g)
    args = (feats, imgs, _projs(V, h, w, dev), lo, step, D)
    n0 = (K7.warp_volume.launches, K7.warp_volume.bf16.launches)
    first = K7.warp_volume(*args)
    second = K7.warp_volume(*args)
    want = K7.warp_volume_plain(*args)
    torch.cuda.synchronize()
    assert (K7.warp_volume.launches,
            K7.warp_volume.bf16.launches) == (n0[0], n0[1] + 2)
    for a, b, p in zip(first, second, want):
        assert a.dtype == torch.bfloat16 and a.shape == p.shape
        assert torch.equal(a, b)
        _close_bf16(a, p)


@pytest.mark.parametrize("kernel", ["k1", "k7", "k7bwd"])
def test_bf16_warp_kernels_refuse_a_misaligned_source(dev, kernel):
    """K1-bf16 and K7-bf16 gather 16 bytes a tap, K7bwd-bf16 8 bytes:
    features that do not start on such a boundary are refused at launch,
    not read, and the launch is not counted."""
    V, h, w, C, D = 3, 8, 12, 8, 4
    buf = torch.zeros(V * h * w * C + 1, dtype=torch.bfloat16, device=dev)
    feats = buf[1:].view(V, h, w, C)
    imgs = torch.zeros(V, h, w, 3, dtype=torch.bfloat16, device=dev)
    cots = [torch.zeros(c, D, h, w, dtype=torch.bfloat16, device=dev)
            for c in (C, 3 * (V - 1) + C)]
    lo = torch.full((h, w), 560.0, device=dev)
    step = torch.full((h, w), 4.0, device=dev)
    projs = _projs(V, h, w, dev)
    fn, count, args = {
        "k1": (K1.warp_variance, K1.warp_variance.bf16,
               (feats, projs, lo, step, D)),
        "k7": (K7.warp_volume, K7.warp_volume.bf16,
               (feats, imgs, projs, lo, step, D)),
        "k7bwd": (K7.warp_volume_bwd, K7.warp_volume_bwd.bf16,
                  (feats, imgs, projs, lo, step, *cots))}[kernel]
    n0 = count.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fn(*args)
    assert count.launches == n0
