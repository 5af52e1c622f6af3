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
within 1e-5 of its largest value. The backward kernels sum in another
order than autograd (K8 dw in per-block partials, K6 and K7 in 64-bit
fixed point, rounded once per flushed run of planes), so they are held to
1e-4 of the largest value, and to themselves bit for bit. Run on the card
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
