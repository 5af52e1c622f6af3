// Fused plane-sweep warp + multi-view variance (float32), for Hopper.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_warp2.py
// plane_sweep_variance_lanes (planes mode: _warp_var_plane_kernel, coords
// _coords_inkernel). What it computes, per (depth plane d, ref pixel):
//   dv = lo + d * step                          (per-pixel hypothesis)
//   for each source view v: p = rot_v * [x, y, 1] * dv + t_v,
//       |Z| floored at 1e-6, px = X/Z clipped to [-2, w+1],
//       py = Y/Z clipped to [-2, h+1], zeros-padded bilinear sample
//   the reference view is read in place (identity warp)
//   sum, sum of squares over the V views in float32 registers
//   variance = sum_sq / V - (sum / V)^2, written once.
// No warped per-view volume ever reaches device memory.
//
// Layouts: src [V, h, w, C] channels-last, so one bilinear tap reads C
// contiguous floats (float4 loads); rel [V, 16] row-major relative
// projections (row 0 unused); lo, step [h, w]; out [C, D, h, w], the layout
// the 3D U-Net kernel (conv3d.cu) reads.
//
// Bound: device-memory bytes. Each thread gathers 4 taps x (V-1) views x C
// floats from source maps that stay hot in the 50 MB L2 (neighbouring
// threads are neighbouring x, whose taps are neighbours too), and writes C
// floats, coalesced across the warp for each channel. One thread per
// (d, pixel): no reduction crosses threads, so there is no shared state.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxViews = 16;

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
  // same rounding as the plain lo + d * step (no fused multiply-add)
  const float dv = __fadd_rn(lo[pix], __fmul_rn((float)d, step[pix]));

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
    for (int c = 0; c < C; ++c) sq[c] = sum[c] * sum[c];
  }

  const float fx = (float)x, fy = (float)y;
  for (int v = 1; v < V; ++v) {
    const float* m = s_rel + v * 16;
    const float rx = m[0] * fx + m[1] * fy + m[2];
    const float ry = m[4] * fx + m[5] * fy + m[6];
    const float rz = m[8] * fx + m[9] * fy + m[10];
    const float X = rx * dv + m[3];
    const float Y = ry * dv + m[7];
    float Z = rz * dv + m[11];
    if (fabsf(Z) < 1e-6f) Z = Z < 0.f ? -1e-6f : 1e-6f;
    const float px = fminf(fmaxf(X / Z, -2.f), (float)W + 1.f);
    const float py = fminf(fmaxf(Y / Z, -2.f), (float)H + 1.f);
    const float x0f = floorf(px), y0f = floorf(py);
    const float wx = px - x0f, wy = py - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const float* base = src + (long long)v * HW * C;

    float val[C];
#pragma unroll
    for (int c = 0; c < C; ++c) val[c] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int xi = x0 + (t & 1), yi = y0 + (t >> 1);
      if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
      const float wgt = ((t & 1) ? wx : 1.f - wx) * ((t >> 1) ? wy : 1.f - wy);
      const float4* p = reinterpret_cast<const float4*>(
          base + ((long long)yi * W + xi) * C);
#pragma unroll
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 q = __ldg(p + c4);
        val[4 * c4 + 0] += wgt * q.x; val[4 * c4 + 1] += wgt * q.y;
        val[4 * c4 + 2] += wgt * q.z; val[4 * c4 + 3] += wgt * q.w;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sum[c] += val[c];
      sq[c] += val[c] * val[c];
    }
  }

  const float fv = (float)V;
  const long long plane = (long long)D * HW;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mean = sum[c] / fv;
    out[c * plane + d * HW + pix] = sq[c] / fv - mean * mean;
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
