// K4: fused softmax over depth + depth regression + photometric
// confidence (float32), for Hopper.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_tail.py
// fused_depth_tail (:133; body _tail_kernel :36, pallas_call :107). Per
// pixel of a cost volume [D, h, w] (D <= 64) with hypotheses
// dv(d) = lo + d * step ([h, w] each):
//   m = max_d cost,  e_d = exp(cost_d - m),  s = sum_d e_d,  p_d = e_d / s
//   depth = sum_d p_d * dv(d),  i = clamp(trunc(sum_d p_d * d), 0, D - 1)
//   conf  = sum_{d = i-1}^{i+2} p_d   (the window clipped to [0, D)),
// which equals the reference's pad-(1, 2) window-4 sum of p gathered at i
// (ops/depth_tail.photometric_confidence).
//
// What bounds it: bytes. The cost volume is read once (4 D bytes a
// pixel) and depth and confidence written once (8 bytes); the work per
// pixel is D exponentials and divisions. One thread owns one pixel and
// holds its D costs in registers, D a template parameter (8, 32 and 48,
// the cascade's stages; a generic instance for any D <= 64 masks the
// planes past D), so nothing is padded: the Triton kernel this replaces
// padded D = 8 to 16 and spent half its stage-3 loads on nothing. A warp
// reads 32 consecutive pixels of each plane (one 128-byte line) and
// writes depth and confidence the same way; every plane's load is issued
// before the first use, so a thread keeps D loads in flight.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDepth = 64;

// DT: D at compile time, or 0 for the generic instance (D <= kMaxDepth
// at run time).
template <int DT>
__global__ void __launch_bounds__(kThreads)
depth_tail_kernel(const float* __restrict__ cost,
                  const float* __restrict__ lo,
                  const float* __restrict__ step,
                  float* __restrict__ depth, float* __restrict__ conf,
                  int n_pix, int d_rt) {
  constexpr int DM = DT ? DT : kMaxDepth;
  const int D = DT ? DT : d_rt;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_pix) return;
  float c[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d)
    c[d] = (DT || d < D) ? __ldg(cost + (long long)d * n_pix + p)
                         : -__int_as_float(0x7f800000);  // -inf
  float m = c[0];
#pragma unroll
  for (int d = 1; d < DM; ++d) m = fmaxf(m, c[d]);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    c[d] = expf(c[d] - m);                 // exp(-inf) = 0 past D
    s += c[d];
  }
  const float lo_p = __ldg(lo + p), step_p = __ldg(step + p);
  float dsum = 0.f, isum = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    c[d] = __fdiv_rn(c[d], s);             // p_d
    const float dv = __fadd_rn(lo_p, __fmul_rn((float)d, step_p));
    dsum = __fmaf_rn(c[d], dv, dsum);
    isum = __fmaf_rn(c[d], (float)d, isum);
  }
  const int i = min(max((int)isum, 0), D - 1);   // (int) truncates
  float win = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d >= i - 1 && d <= i + 2) win += c[d];
  depth[p] = dsum;
  conf[p] = win;
}

template <int DT>
cudaError_t launch(const float* cost, const float* lo, const float* step,
                   float* depth, float* conf, int n_pix, int D,
                   cudaStream_t s) {
  depth_tail_kernel<DT><<<(n_pix + kThreads - 1) / kThreads, kThreads, 0,
                          s>>>(cost, lo, step, depth, conf, n_pix, D);
  return cudaGetLastError();
}

}  // namespace

// cost [D, n_pix], lo / step / depth / conf [n_pix], 1 <= D <= 64.
extern "C" int depth_tail_f32(const float* cost, const float* lo,
                              const float* step, float* depth, float* conf,
                              int n_pix, int D, void* stream) {
  if (D < 1 || D > kMaxDepth || n_pix < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 8: return (int)launch<8>(cost, lo, step, depth, conf, n_pix, D, s);
    case 32: return (int)launch<32>(cost, lo, step, depth, conf, n_pix, D, s);
    case 48: return (int)launch<48>(cost, lo, step, depth, conf, n_pix, D, s);
    default: return (int)launch<0>(cost, lo, step, depth, conf, n_pix, D, s);
  }
}
