// Plane-sweep sampling coordinates shared by the warp kernels
// (warp_variance.cu: K1 and its backward; warp_volume.cu: the stage-1
// volume kernel and its backward; warp_view.cu: the per-view warp K10), so
// that a backward recomputes exactly the taps its forward read and every
// warp of the port samples by one rule. The backwards' transposed sample
// (a deterministic fixed-point scatter) is in warp_bwd.cuh.
//
// For reference pixel (x, y) at hypothesis depth dv and a row-major 4x4
// relative projection m (src @ inv(ref), K folded in):
//   r = rot * [x, y, 1],  p = r * dv + t,  |Z| floored at 1e-6 (sign kept),
//   px = X/Z clipped to [-2, W+1], py = Y/Z clipped to [-2, H+1];
// every operation rounds on its own (no fused multiply-add), in the order
// ops/warp_view.pixel_coords spells out with plain tensor operations, so
// the coordinates it computes equal these bit for bit. The K10 route's
// 1e-5 gate against K1 (chip_smoke.py, tests/test_torch_kernels_gpu.py)
// rests on that: one ulp of a coordinate moves the variance by up to
// 3e-5 of its largest value. Reordering or contracting these operations
// (in K1, K6 or K7) means changing pixel_coords to match.
// Tap k (0..3) is (x0 + (k & 1), y0 + (k >> 1)) with the bilinear weight
// tap_weight(k); a tap outside the image reads zero (zeros padding, per
// tap). The clip only moves samples whose four taps all lie outside.
// bf16 sources (the bf16 kernels, warp_bf16.cuh): the x weight is rounded
// to bf16 before it multiplies the y weight (float32), as the JAX kernel
// rounds its x hat weights to the compute dtype and keeps the y ones
// float32 (pallas_warp2.py:228-243; tap_weight_bf16); the coordinates are
// float32 either way.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace warp {

constexpr int kMaxViews = 16;

struct Taps {
  int x0, y0;
  float wx, wy;
};

// The hypothesis depth, rounded as the plain lo + d * step (no FMA).
__device__ __forceinline__ float plane_depth(float lo, float step, int d) {
  return __fadd_rn(lo, __fmul_rn((float)d, step));
}

// Taps of the sample point (px, py), in pixels.
__device__ __forceinline__ Taps taps_at(float px, float py) {
  const float x0f = floorf(px), y0f = floorf(py);
  return Taps{(int)x0f, (int)y0f, px - x0f, py - y0f};
}

// One row of rot * [x, y, 1] * dv + t, each operation rounded, in two
// halves: rot_row, the same for every plane (K1 computes it once per
// pixel), and depth_row, per plane.
__device__ __forceinline__ float rot_row(const float* r, float fx,
                                         float fy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], fx), __fmul_rn(r[1], fy)),
                   r[2]);
}

__device__ __forceinline__ float depth_row(float rr, float t, float dv) {
  return __fadd_rn(__fmul_rn(rr, dv), t);
}

__device__ __forceinline__ float project_row(const float* r, float fx,
                                             float fy, float dv) {
  return depth_row(rot_row(r, fx, fy), r[3], dv);
}

// Taps of the point whose three projected rows are X, Y, Z.
__device__ __forceinline__ Taps taps_of_rows(float X, float Y, float Z,
                                             int H, int W) {
  if (fabsf(Z) < 1e-6f) Z = Z < 0.f ? -1e-6f : 1e-6f;
  const float px = fminf(fmaxf(__fdiv_rn(X, Z), -2.f), (float)W + 1.f);
  const float py = fminf(fmaxf(__fdiv_rn(Y, Z), -2.f), (float)H + 1.f);
  return taps_at(px, py);
}

__device__ __forceinline__ Taps project(const float* m, float fx, float fy,
                                        float dv, int H, int W) {
  return taps_of_rows(project_row(m, fx, fy, dv),
                      project_row(m + 4, fx, fy, dv),
                      project_row(m + 8, fx, fy, dv), H, W);
}

// Tap k's pixel index y * W + x, or -1 when it lies outside the image.
__device__ __forceinline__ long long tap_pixel(const Taps& t, int k, int H,
                                               int W) {
  const int xi = t.x0 + (k & 1), yi = t.y0 + (k >> 1);
  if (xi < 0 || xi >= W || yi < 0 || yi >= H) return -1;
  return (long long)yi * W + xi;
}

__device__ __forceinline__ float tap_weight(const Taps& t, int k) {
  return ((k & 1) ? t.wx : 1.f - t.wx) * ((k >> 1) ? t.wy : 1.f - t.wy);
}

// tap_weight with the x weight rounded to bf16 (to nearest even).
__device__ __forceinline__ float tap_weight_bf16(const Taps& t, int k) {
  const float wx = __bfloat162float(
      __float2bfloat16_rn((k & 1) ? t.wx : 1.f - t.wx));
  return __fmul_rn(wx, (k >> 1) ? t.wy : 1.f - t.wy);
}

// An output element from its float32 value (bf16: rounded to nearest even).
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One element; four consecutive channels as float4 (one 16-byte load).
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Bilinear sample of the 4 channels [4q, 4q + 4) of map base [H, W, C]
// (one float4 per tap), in sample_channels' order (taps 0..3, one fused
// multiply-add each); the taps' offset, bounds and weights are worked out
// once for the 4 taps.
template <int C>
__device__ __forceinline__ float4 sample_quad(const float* base,
                                              const Taps& t, int H, int W,
                                              int q) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool x0in = t.x0 >= 0 && t.x0 < W, x1in = t.x0 >= -1 && t.x0 < W - 1;
  const bool y0in = t.y0 >= 0 && t.y0 < H, y1in = t.y0 >= -1 && t.y0 < H - 1;
  const long long p00 = ((long long)t.y0 * W + t.x0) * C + 4 * q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!(((k & 1) ? x1in : x0in) && ((k >> 1) ? y1in : y0in))) continue;
    const float wgt = tap_weight(t, k);
    const float4 s = load4(base + p00 + ((k >> 1) ? (long long)W * C : 0) +
                           ((k & 1) ? C : 0));
    v.x = __fmaf_rn(wgt, s.x, v.x);
    v.y = __fmaf_rn(wgt, s.y, v.y);
    v.z = __fmaf_rn(wgt, s.z, v.z);
    v.w = __fmaf_rn(wgt, s.w, v.w);
  }
  return v;
}

// Bilinear sample of C channels (C % 4 == 0, float4 loads; stride, the
// floats between two pixels, a multiple of 4) of map base [H, W, stride]
// into val, accumulating the taps in order 0..3 with one fused
// multiply-add each.
template <int C>
__device__ __forceinline__ void sample_channels(const float* base,
                                                const Taps& t, int H, int W,
                                                float* val,
                                                int stride = C) {
#pragma unroll
  for (int c = 0; c < C; ++c) val[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long p = tap_pixel(t, k, H, W);
    if (p < 0) continue;
    const float wgt = tap_weight(t, k);
    const float4* q4 = reinterpret_cast<const float4*>(base + p * stride);
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4) {
      const float4 q = __ldg(q4 + c4);
      val[4 * c4 + 0] = __fmaf_rn(wgt, q.x, val[4 * c4 + 0]);
      val[4 * c4 + 1] = __fmaf_rn(wgt, q.y, val[4 * c4 + 1]);
      val[4 * c4 + 2] = __fmaf_rn(wgt, q.z, val[4 * c4 + 2]);
      val[4 * c4 + 3] = __fmaf_rn(wgt, q.w, val[4 * c4 + 3]);
    }
  }
}

}  // namespace warp
