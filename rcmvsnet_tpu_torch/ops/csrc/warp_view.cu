// Per-view plane-sweep warp (float32), for Hopper: K10.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_warp.py
// warp_volume_pallas (_warp_rows_kernel): one source view's feature map
// sampled at given pixel coordinates for every depth plane,
//   out[d, y, x, c] = bilinear(src[:, :, c], px[d, y, x], py[d, y, x]),
// zeros padding per tap, with K1's taps and weights (warp_common.cuh
// `taps_at`, `tap_weight`; taps 0..3, one fused multiply-add each), so
// this warp and K1's fused one share one sampling rule. The TPU kernel
// keeps the map resident in VMEM and turns the x interpolation into a
// matmul over a y-band of rows (a band that must cover each 8-row group's
// source rows); here the taps are gathered straight from device memory,
// so there is no band and no precondition.
//
// Layouts: src [H, W, C] channels-last; px, py [D, H, W]; out [D, H, W, C]
// (the TPU kernel writes [D, H, C, W]; its caller moves C last).
//
// Bound: device-memory bytes. Each output float is written once (D*H*W*C
// floats, 73-87 % of the bytes at the DTU shapes), px and py read once;
// the source map (H*W*C floats, 8-32 MB) is read 4x per sample through
// the 50 MB L2. What the design does about it (each choice timed in turns
// against the others with tools/ab_warp_view; PERF.md §6 has the times):
//   * long chunks: a warp owns a chunk of one row, 8 passes of 32 / L
//     samples (L = C / 4 lanes a sample, one float4 of channels a lane).
//     It loads the chunk's px and py at once and works out each sample's
//     taps once (tap 0's offset, which taps land, the four weights),
//     staged in shared memory, where the L lanes of the sample read them
//     as one broadcast. With chunks of 2 passes each warp waited on px,
//     py and then on its gathers for a few samples, and the card was
//     latency-bound.
//   * gathers in flight: the taps of pass p + 1 are loaded before pass p
//     is summed and stored; a warp's store of one pass is 512 contiguous
//     bytes, with the streaming hint (evict first).
//   * planes inner: the grid runs x tile fastest, then plane, then row
//     group, so the blocks in flight at once sweep every plane of a band
//     of rows and the band of the map they read stays in L2 (plane-major
//     order read the 32 MB stage-3 map from memory again for each plane).
//   * 32-bit index math inside the block from one 64-bit base per warp;
//     no thread divides.
// Any C that is not 4, 8, 16 or 32 runs one channel per thread with
// scalar loads (`warp_view_scalar_kernel`), the same weights and order.
// Every path adds the taps in the same order with the same operations, so
// the output does not depend on the schedule (tools/ab_warp_view holds it
// bit for bit against other builds).
#include <climits>

#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = 8;          // passes of a warp's chunk

// One sample's taps as the gather loop reads them.
struct TapPlan {
  int off;   // (y0 * W + x0) * C: tap 0's offset in floats (only the
             // offsets of taps that land are ever read)
  int mask;  // bit k set: tap k lies in the image
};

// L lanes a sample (C = 4 * L); a pass of a warp is G = 32 / L
// consecutive samples, and a warp's chunk is P = kPasses passes, NW = P * G
// samples (32 at C = 32 up to 256 at C = 4). Block (bx, d, bz) covers
// kWarps rows of plane d, from row bz * kWarps: warp w takes row
// bz * kWarps + w and the chunk starting at x = bx * NW, cut at the row's
// end. Lane (g, q) = (lane / L, lane % L) owns channels 4q..4q+3 of the
// chunk's samples p * G + g, p = 0..P-1.
template <int L>
__global__ void __launch_bounds__(kThreads)
warp_view_lanes_kernel(const float* __restrict__ src,
                       const float* __restrict__ px,
                       const float* __restrict__ py,
                       float* __restrict__ out, int H, int W) {
  constexpr int C = 4 * L;
  constexpr int G = 32 / L;
  constexpr int P = kPasses;
  constexpr int NW = P * G;
  constexpr int R = NW / 32;           // samples a lane plans
  static_assert(NW % 32 == 0, "a chunk is whole warps of samples");
  __shared__ float4 s_wgt[kWarps][NW];
  __shared__ TapPlan s_plan[kWarps][NW];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.z * kWarps + wid;
  const int xs = blockIdx.x * NW;
  if (row >= H || xs >= W) return;             // the whole warp
  const int count = min(NW, W - xs);
  const long long first = ((long long)blockIdx.y * H + row) * W + xs;

  // Taps once per sample: every px, py load of the chunk first.
  float cx[R], cy[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    cx[r] = i < count ? __ldg(px + first + i) : 0.f;
    cy[r] = i < count ? __ldg(py + first + i) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    TapPlan plan{0, 0};
    float4 wgt = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < count) {
      const warp::Taps t = warp::taps_at(cx[r], cy[r]);
      const bool x0in = t.x0 >= 0 && t.x0 < W;
      const bool x1in = t.x0 >= -1 && t.x0 < W - 1;
      const bool y0in = t.y0 >= 0 && t.y0 < H;
      const bool y1in = t.y0 >= -1 && t.y0 < H - 1;
      plan.off = (t.y0 * W + t.x0) * C;
      plan.mask = (x0in && y0in) | (x1in && y0in) << 1 |
                  (x0in && y1in) << 2 | (x1in && y1in) << 3;
      wgt = make_float4(warp::tap_weight(t, 0), warp::tap_weight(t, 1),
                        warp::tap_weight(t, 2), warp::tap_weight(t, 3));
    }
    s_wgt[wid][i] = wgt;
    s_plan[wid][i] = plan;
  }
  __syncwarp();

  // The passes in order, the taps of pass p + 1 loaded before pass p is
  // summed and stored (two passes' taps, in ring slots p % 2).
  const int g = lane / L, q = lane % L;
  const float* map = src + 4 * q;
  const int tap_off[4] = {0, C, W * C, W * C + C};
  float4 v[2][4];
  int mask[2];
  auto gather = [&](int p) {
    const TapPlan plan = s_plan[wid][p * G + g];
    const int b = p % 2;
    mask[b] = plan.mask;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[b][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (plan.mask >> k & 1)
        v[b][k] = __ldg(
            reinterpret_cast<const float4*>(map + plan.off + tap_off[k]));
    }
  };
  gather(0);
  float* wout = out + first * C + 4 * q;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p + 1 < P) gather(p + 1);
    const int j = p * G + g, b = p % 2;
    if (j >= count) break;
    const float4 w4 = s_wgt[wid][j];
    const float wgt[4] = {w4.x, w4.y, w4.z, w4.w};
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(mask[b] >> k & 1)) continue;
      acc.x = __fmaf_rn(wgt[k], v[b][k].x, acc.x);
      acc.y = __fmaf_rn(wgt[k], v[b][k].y, acc.y);
      acc.z = __fmaf_rn(wgt[k], v[b][k].z, acc.z);
      acc.w = __fmaf_rn(wgt[k], v[b][k].w, acc.w);
    }
    __stcs(reinterpret_cast<float4*>(wout + j * C), acc);
  }
}

__global__ void __launch_bounds__(kThreads)
warp_view_scalar_kernel(const float* __restrict__ src,
                        const float* __restrict__ px,
                        const float* __restrict__ py,
                        float* __restrict__ out, int H, int W, int C,
                        long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * C) return;
  const long long q = idx / C;
  const int c = (int)(idx - q * C);
  const warp::Taps t = warp::taps_at(__ldg(px + q), __ldg(py + q));
  float val = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long p = warp::tap_pixel(t, k, H, W);
    if (p < 0) continue;
    val = __fmaf_rn(warp::tap_weight(t, k), __ldg(src + p * C + c), val);
  }
  out[idx] = val;
}

template <int L>
void launch_lanes(const float* src, const float* px, const float* py,
                  float* out, int H, int W, int D, cudaStream_t s) {
  const int chunk = kPasses * (32 / L);               // x samples a warp
  const dim3 grid((W + chunk - 1) / chunk, D, (H + kWarps - 1) / kWarps);
  warp_view_lanes_kernel<L><<<grid, kThreads, 0, s>>>(src, px, py, out, H,
                                                       W);
}

}  // namespace

// n = D * H * W sample points; any C >= 1. The lane kernel's tap offsets
// are 32-bit: (H + 2) * (W + 2) * C must stay below 2^31.
extern "C" int warp_view_f32(const float* src, const float* px,
                             const float* py, float* out, int H, int W,
                             int C, int D, void* stream) {
  if (C < 1 || H < 1 || W < 1 || D < 1 || D > 65535 ||
      (long long)(H + 2) * (W + 2) * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)D * H * W;
  switch (C) {
    case 4: launch_lanes<1>(src, px, py, out, H, W, D, s); break;
    case 8: launch_lanes<2>(src, px, py, out, H, W, D, s); break;
    case 16: launch_lanes<4>(src, px, py, out, H, W, D, s); break;
    case 32: launch_lanes<8>(src, px, py, out, H, W, D, s); break;
    default: {
      const long long threads = n * C;
      warp_view_scalar_kernel<<<(unsigned)((threads + kThreads - 1) /
                                           kThreads),
                                kThreads, 0, s>>>(src, px, py, out, H, W,
                                                  C, n);
    }
  }
  return (int)cudaGetLastError();
}
