// Stage-1 train volume kernel (float32) and its backward, for Hopper.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_warp_volume.py
// plane_sweep_volume_fused_train (forward _warp_volume_kernel, backward
// _warp_volume_bwd_kernel). In ONE sweep over (depth plane d, ref pixel)
// it writes the three volumes the clean train pass needs at stage 1:
//   var     variance over all V views (reference included)  -> U-Net
//   var_nr  variance over the V-1 source views, divided by V (the
//           reference's no_ref bookkeeping)                  -> render
//   wimg    the V-1 warped source images, view-major          -> render
// Features and images are separate tensors sampled with the same taps.
//
// Backward: with mean = (ref + sum_v x_v) / V and mean_nr = sum_v x_v / V,
//   dL/dx_v   = (2/V) g_var (x_v - mean) + (2/V) g_nr (x_v - mean_nr)
//   dL/dref   = (2/V) g_var (ref - mean)
//   dL/dimg_v = the image cotangent of view v,
// each scattered through Warp_v^T (four bilinear taps, atomicAdd) into
// dfeat and dimg; the reference's lands on its own pixel. One thread per
// (plane, pixel) recomputes the source sum (pass 1), then re-samples each
// view (pass 2).
//
// Layouts: feats / dfeat [V, h, w, C], imgs / dimg [V, h, w, 3]
// channels-last; rel [V, 16]; lo, step [h, w]; var, var_nr, g_var, g_nr
// [C, D, h, w]; wimg, g_img [3 (V-1), D, h, w].
//
// Bound: device-memory bytes forward (gathers hot in L2, (2C + 3(V-1))
// floats written per thread); atomic throughput backward, as K6's.
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace {

using warp::kMaxViews;

__device__ __forceinline__ void sample_rgb(const float* base,
                                           const warp::Taps& t, int H, int W,
                                           float* rgb) {
  rgb[0] = rgb[1] = rgb[2] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long p = warp::tap_pixel(t, k, H, W);
    if (p < 0) continue;
    const float wgt = warp::tap_weight(t, k);
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] += wgt * __ldg(base + p * 3 + c);
  }
}

template <int C>
__global__ void __launch_bounds__(128)
warp_volume_kernel(const float* __restrict__ feats,
                   const float* __restrict__ imgs,
                   const float* __restrict__ rel,
                   const float* __restrict__ lo,
                   const float* __restrict__ step,
                   float* __restrict__ var, float* __restrict__ var_nr,
                   float* __restrict__ wimg, int V, int H, int W, int D) {
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
  const long long at = d * HW + pix;

  // source views only, as the no-ref variance sums them
  float sum[C], sq[C];
#pragma unroll
  for (int c = 0; c < C; ++c) sum[c] = sq[c] = 0.f;
  for (int v = 1; v < V; ++v) {
    const warp::Taps t = warp::project(s_rel + v * 16, fx, fy, dv, H, W);
    float val[C];
    warp::sample_channels<C>(feats + (long long)v * HW * C, t, H, W, val);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sum[c] += val[c];
      sq[c] += val[c] * val[c];
    }
    float rgb[3];
    sample_rgb(imgs + (long long)v * HW * 3, t, H, W, rgb);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      wimg[(long long)(3 * (v - 1) + c) * plane + at] = rgb[c];
  }

  const float fv = (float)V;
  const float* ref = feats + pix * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float m_nr = sum[c] / fv;
    var_nr[c * plane + at] = sq[c] / fv - m_nr * m_nr;
    const float r = __ldg(ref + c);
    const float m = (sum[c] + r) / fv;
    var[c * plane + at] = (sq[c] + r * r) / fv - m * m;
  }
}

template <int C>
__global__ void __launch_bounds__(128)
warp_volume_bwd_kernel(const float* __restrict__ feats,
                       const float* __restrict__ rel,
                       const float* __restrict__ lo,
                       const float* __restrict__ step,
                       const float* __restrict__ g_var,
                       const float* __restrict__ g_nr,
                       const float* __restrict__ g_img,
                       float* __restrict__ dfeat, float* __restrict__ dimg,
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
  const long long at = d * HW + pix;
  const float fv = (float)V;
  const float scale = 2.f / fv;
  const float* ref = feats + pix * C;

  // pass 1: the source sum
  float sum[C], val[C];
#pragma unroll
  for (int c = 0; c < C; ++c) sum[c] = 0.f;
  for (int v = 1; v < V; ++v) {
    const warp::Taps t = warp::project(s_rel + v * 16, fx, fy, dv, H, W);
    warp::sample_channels<C>(feats + (long long)v * HW * C, t, H, W, val);
#pragma unroll
    for (int c = 0; c < C; ++c) sum[c] += val[c];
  }

  // the reference view: only the all-view variance reads it
  {
    float* q = dfeat + pix * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float r = __ldg(ref + c);
      const float m = (sum[c] + r) / fv;
      atomicAdd(q + c, scale * __ldg(g_var + c * plane + at) * (r - m));
    }
  }
  // pass 2: each source view's feature and image cotangents
  for (int v = 1; v < V; ++v) {
    const warp::Taps t = warp::project(s_rel + v * 16, fx, fy, dv, H, W);
    warp::sample_channels<C>(feats + (long long)v * HW * C, t, H, W, val);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float m = (sum[c] + __ldg(ref + c)) / fv;
      const float m_nr = sum[c] / fv;
      val[c] = scale * (__ldg(g_var + c * plane + at) * (val[c] - m)
                        + __ldg(g_nr + c * plane + at) * (val[c] - m_nr));
    }
    warp::scatter_channels<C>(dfeat + (long long)v * HW * C, t, H, W, val);
    float gi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      gi[c] = __ldg(g_img + (long long)(3 * (v - 1) + c) * plane + at);
    warp::scatter_channels<3>(dimg + (long long)v * HW * 3, t, H, W, gi);
  }
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int warp_volume_f32(const float* feats, const float* imgs,
                               const float* rel, const float* lo,
                               const float* step, float* var, float* var_nr,
                               float* wimg, int V, int H, int W, int C, int D,
                               void* stream) {
  if (V < 2 || V > kMaxViews) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = blocks_for((long long)H * W * D, 128);
  switch (C) {
    case 8: warp_volume_kernel<8><<<b, 128, 0, s>>>(
        feats, imgs, rel, lo, step, var, var_nr, wimg, V, H, W, D); break;
    case 16: warp_volume_kernel<16><<<b, 128, 0, s>>>(
        feats, imgs, rel, lo, step, var, var_nr, wimg, V, H, W, D); break;
    case 32: warp_volume_kernel<32><<<b, 128, 0, s>>>(
        feats, imgs, rel, lo, step, var, var_nr, wimg, V, H, W, D); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dfeat and dimg must be zeroed by the caller (the kernel accumulates).
extern "C" int warp_volume_bwd_f32(const float* feats, const float* rel,
                                   const float* lo, const float* step,
                                   const float* g_var, const float* g_nr,
                                   const float* g_img, float* dfeat,
                                   float* dimg, int V, int H, int W, int C,
                                   int D, void* stream) {
  if (V < 2 || V > kMaxViews) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = blocks_for((long long)H * W * D, 128);
  switch (C) {
    case 8: warp_volume_bwd_kernel<8><<<b, 128, 0, s>>>(
        feats, rel, lo, step, g_var, g_nr, g_img, dfeat, dimg, V, H, W, D);
      break;
    case 16: warp_volume_bwd_kernel<16><<<b, 128, 0, s>>>(
        feats, rel, lo, step, g_var, g_nr, g_img, dfeat, dimg, V, H, W, D);
      break;
    case 32: warp_volume_bwd_kernel<32><<<b, 128, 0, s>>>(
        feats, rel, lo, step, g_var, g_nr, g_img, dfeat, dimg, V, H, W, D);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
