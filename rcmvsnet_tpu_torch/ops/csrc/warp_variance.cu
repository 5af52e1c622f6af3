// Fused plane-sweep warp + multi-view variance (float32) and its
// backward, for Hopper.
//
// Forward (K1) replaces the TPU kernel rcmvsnet_tpu/ops/pallas_warp2.py
// plane_sweep_variance_lanes (planes mode: _warp_var_plane_kernel, coords
// _coords_inkernel). What it computes, per (depth plane d, ref pixel):
//   dv = lo + d * step                          (per-pixel hypothesis)
//   each source view v sampled at its projection (warp_common.cuh)
//   the reference view is read in place (identity warp)
//   sum, sum of squares over the V views in float32 registers
//   variance = sum_sq * (1/V) - (sum * (1/V))^2, written once,
// every step rounded on its own, in the order ops/warp_view.py's
// plane_sweep_variance_views takes over the per-view warps (K10), so the
// two routes give the same variance (gated at 1e-5 of its largest value).
// No warped per-view volume ever reaches device memory.
//
// Backward (K6) replaces the backward kernel of
// rcmvsnet_tpu/ops/pallas_warp_train.py plane_sweep_variance_fused_train
// (_warp_var_bwd_kernel). With x_v the warped view v and g the cotangent
// of the variance,
//   dL/dx_v = (2/V) * g * (x_v - mean),   dL/dsrc_v = Warp_v^T dL/dx_v,
// and no cotangent reaches the projections or the depth planes (the
// sampling grid carries no gradient, as in the reference). One thread per
// (plane, pixel) recomputes the mean over all V views (pass 1), then
// re-samples each view and scatters its cotangent into dsrc with the four
// bilinear weights (pass 2; atomicAdd). The reference view's cotangent
// lands on its own pixel.
//
// Layouts: src and dsrc [V, h, w, C] channels-last (one tap reads C
// contiguous floats, float4 loads); rel [V, 16] row-major relative
// projections (row 0 unused); lo, step [h, w]; out and g [C, D, h, w], the
// layout the 3D U-Net kernel (conv3d.cu) reads and writes.
//
// Bound: device-memory bytes for the forward (each thread gathers
// 4 taps x (V-1) views x C floats from source maps that stay hot in the
// 50 MB L2, and writes C floats, coalesced across the warp per channel);
// the backward adds twice the gathers and 4 x V x C atomic adds per
// thread, which serialise on the D planes that hit one source pixel, so
// atomic throughput bounds it.
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

using warp::kMaxViews;

template <int C>
__global__ void __launch_bounds__(128)
warp_variance_kernel(const float* __restrict__ src,
                     const float* __restrict__ rel,
                     const float* __restrict__ lo,
                     const float* __restrict__ step,
                     float* __restrict__ out,
                     int V, int H, int W, int D) {
  __shared__ float s_rel[kMaxViews * 16];
  for (int i = threadIdx.x; i < V * 16; i += blockDim.x) s_rel[i] = rel[i];
  __syncthreads();

  const long long HW = (long long)H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HW * D) return;
  const int d = (int)(idx / HW);
  const long long pix = idx - (long long)d * HW;
  const int y = (int)(pix / W);
  const int x = (int)(pix - (long long)y * W);
  const float dv = warp::plane_depth(lo[pix], step[pix], d);

  float sum[C], sq[C];
  {
    const float4* r = reinterpret_cast<const float4*>(src + pix * C);
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4) {
      const float4 q = __ldg(r + c4);
      sum[4 * c4 + 0] = q.x; sum[4 * c4 + 1] = q.y;
      sum[4 * c4 + 2] = q.z; sum[4 * c4 + 3] = q.w;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) sq[c] = __fmul_rn(sum[c], sum[c]);
  }

  const float fx = (float)x, fy = (float)y;
  for (int v = 1; v < V; ++v) {
    const warp::Taps t = warp::project(s_rel + v * 16, fx, fy, dv, H, W);
    float val[C];
    warp::sample_channels<C>(src + (long long)v * HW * C, t, H, W, val);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sum[c] = __fadd_rn(sum[c], val[c]);
      sq[c] = __fadd_rn(sq[c], __fmul_rn(val[c], val[c]));
    }
  }

  const float inv_v = 1.f / (float)V;
  const long long plane = (long long)D * HW;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mean = __fmul_rn(sum[c], inv_v);
    out[c * plane + d * HW + pix] =
        __fsub_rn(__fmul_rn(sq[c], inv_v), __fmul_rn(mean, mean));
  }
}

template <int C>
__global__ void __launch_bounds__(128)
warp_variance_bwd_kernel(const float* __restrict__ src,
                         const float* __restrict__ rel,
                         const float* __restrict__ lo,
                         const float* __restrict__ step,
                         const float* __restrict__ g,
                         float* __restrict__ dsrc,
                         int V, int H, int W, int D) {
  __shared__ float s_rel[kMaxViews * 16];
  for (int i = threadIdx.x; i < V * 16; i += blockDim.x) s_rel[i] = rel[i];
  __syncthreads();

  const long long HW = (long long)H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HW * D) return;
  const int d = (int)(idx / HW);
  const long long pix = idx - (long long)d * HW;
  const int y = (int)(pix / W);
  const int x = (int)(pix - (long long)y * W);
  const float dv = warp::plane_depth(lo[pix], step[pix], d);
  const float fx = (float)x, fy = (float)y;
  const long long plane = (long long)D * HW;
  const float* gp = g + d * HW + pix;            // channel c at c * plane
  const float fv = (float)V;
  const float scale = 2.f / fv;

  // pass 1: the mean over all views
  float mean[C], val[C];
  {
    const float4* r = reinterpret_cast<const float4*>(src + pix * C);
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4) {
      const float4 q = __ldg(r + c4);
      mean[4 * c4 + 0] = q.x; mean[4 * c4 + 1] = q.y;
      mean[4 * c4 + 2] = q.z; mean[4 * c4 + 3] = q.w;
    }
  }
  for (int v = 1; v < V; ++v) {
    const warp::Taps t = warp::project(s_rel + v * 16, fx, fy, dv, H, W);
    warp::sample_channels<C>(src + (long long)v * HW * C, t, H, W, val);
#pragma unroll
    for (int c = 0; c < C; ++c) mean[c] += val[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) mean[c] /= fv;

  // pass 2: each view's cotangent, scattered through its warp
  {
    const float* r = src + pix * C;
#pragma unroll
    for (int c = 0; c < C; ++c)
      val[c] = scale * __ldg(gp + c * plane) * (__ldg(r + c) - mean[c]);
    float* q = dsrc + pix * C;
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(q + c, val[c]);
  }
  for (int v = 1; v < V; ++v) {
    const warp::Taps t = warp::project(s_rel + v * 16, fx, fy, dv, H, W);
    warp::sample_channels<C>(src + (long long)v * HW * C, t, H, W, val);
#pragma unroll
    for (int c = 0; c < C; ++c)
      val[c] = scale * __ldg(gp + c * plane) * (val[c] - mean[c]);
    warp::scatter_channels<C>(dsrc + (long long)v * HW * C, t, H, W, val);
  }
}

template <int C>
cudaError_t launch(const float* src, const float* rel, const float* lo,
                   const float* step, float* out, int V, int H, int W, int D,
                   cudaStream_t stream) {
  const long long n = (long long)H * W * D;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  warp_variance_kernel<C><<<blocks, threads, 0, stream>>>(
      src, rel, lo, step, out, V, H, W, D);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bwd(const float* src, const float* rel, const float* lo,
                       const float* step, const float* g, float* dsrc, int V,
                       int H, int W, int D, cudaStream_t stream) {
  const long long n = (long long)H * W * D;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  warp_variance_bwd_kernel<C><<<blocks, threads, 0, stream>>>(
      src, rel, lo, step, g, dsrc, V, H, W, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int warp_variance_f32(const float* src, const float* rel,
                                 const float* lo, const float* step,
                                 float* out, int V, int H, int W, int C,
                                 int D, void* stream) {
  if (V < 1 || V > kMaxViews) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8: return (int)launch<8>(src, rel, lo, step, out, V, H, W, D, s);
    case 16: return (int)launch<16>(src, rel, lo, step, out, V, H, W, D, s);
    case 32: return (int)launch<32>(src, rel, lo, step, out, V, H, W, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dsrc must be zeroed by the caller (the kernel accumulates into it).
extern "C" int warp_variance_bwd_f32(const float* src, const float* rel,
                                     const float* lo, const float* step,
                                     const float* g, float* dsrc, int V,
                                     int H, int W, int C, int D,
                                     void* stream) {
  if (V < 1 || V > kMaxViews) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8:
      return (int)launch_bwd<8>(src, rel, lo, step, g, dsrc, V, H, W, D, s);
    case 16:
      return (int)launch_bwd<16>(src, rel, lo, step, g, dsrc, V, H, W, D, s);
    case 32:
      return (int)launch_bwd<32>(src, rel, lo, step, g, dsrc, V, H, W, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
