// Per-view plane-sweep warp (float32), for Hopper: K10.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_warp.py
// warp_volume_pallas (_warp_rows_kernel): one source view's feature map
// sampled at given pixel coordinates for every depth plane,
//   out[d, y, x, c] = bilinear(src[:, :, c], px[d, y, x], py[d, y, x]),
// zeros padding per tap, with K1's taps and weights (warp_common.cuh), so
// this warp and K1's fused one share one sampling rule. The TPU kernel
// keeps the map resident in VMEM and turns the x interpolation into a
// matmul over a y-band of rows (a band that must cover each 8-row group's
// source rows); here each thread gathers its four taps straight from
// device memory, so there is no band and no precondition.
//
// Layouts: src [H, W, C] channels-last; px, py [D, H, W]; out [D, H, W, C]
// (the TPU kernel writes [D, H, C, W]; its caller moves C last).
//
// One thread per (plane, pixel, channel group): for C % 4 == 0 a group is
// four channels (one float4 load per tap, one float4 store, neighbouring
// threads on neighbouring 16 bytes); any other C runs one channel per
// thread with scalar loads and the same weights and order.
//
// Bound: device-memory bytes. Each output float is written once (D*H*W*C
// floats, the bulk), px and py read once; the source map (H*W*C floats)
// is read 4x per plane through the 50 MB L2, where it stays.
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_view_vec_kernel(const float* __restrict__ src,
                     const float* __restrict__ px,
                     const float* __restrict__ py, float* __restrict__ out,
                     int H, int W, int C, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int groups = C / 4;
  if (idx >= n * groups) return;
  const long long q = idx / groups;                  // (plane, pixel)
  const int g = (int)(idx - q * groups);
  const warp::Taps t = warp::taps_at(__ldg(px + q), __ldg(py + q));
  float val[4];
  warp::sample_channels<4>(src + 4 * g, t, H, W, val, C);
  reinterpret_cast<float4*>(out + q * C)[g] =
      make_float4(val[0], val[1], val[2], val[3]);
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

}  // namespace

// n = D * H * W sample points; any C >= 1.
extern "C" int warp_view_f32(const float* src, const float* px,
                             const float* py, float* out, int H, int W,
                             int C, int D, void* stream) {
  if (C < 1 || H < 1 || W < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)D * H * W;
  if (C % 4 == 0) {
    const long long threads = n * (C / 4);
    warp_view_vec_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                           kThreads, 0, s>>>(src, px, py, out, H, W, C, n);
  } else {
    const long long threads = n * C;
    warp_view_scalar_kernel<<<(unsigned)((threads + kThreads - 1) /
                                         kThreads),
                              kThreads, 0, s>>>(src, px, py, out, H, W, C,
                                                n);
  }
  return (int)cudaGetLastError();
}
