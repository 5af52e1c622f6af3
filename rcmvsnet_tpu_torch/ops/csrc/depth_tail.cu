// K4: fused softmax over depth + depth regression + photometric
// confidence (float32), for Hopper.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_tail.py
// fused_depth_tail (:133; body _tail_kernel :36, pallas_call :107). Per
// pixel of a cost volume [D, h, w] (any D >= 1) with hypotheses
// dv(d) = lo + d * step ([h, w] each):
//   m = max_d cost,  e_d = exp(cost_d - m),  s = sum_d e_d,  p_d = e_d / s
//   depth = sum_d p_d * dv(d),  i = clamp(trunc(sum_d p_d * d), 0, D - 1)
//   conf  = sum_{d = i-1}^{i+2} p_d   (the window clipped to [0, D)),
// which equals the reference's pad-(1, 2) window-4 sum of p gathered at i
// (ops/depth_tail.photometric_confidence).
//
// What bounds it: bytes. The cost volume is read once (4 D bytes a
// pixel) and depth and confidence written once (8 bytes); the work per
// pixel is D exponentials and divisions. One thread owns one pixel. For
// D <= 64 it holds its D costs in registers, D a template parameter (8, 32
// and 48, the cascade's stages; a generic instance for any D <= 64 masks
// the planes past D), so nothing is padded: the Triton kernel this
// replaces padded D = 8 to 16 and spent half its stage-3 loads on
// nothing. A warp reads 32 consecutive pixels of each plane (one 128-byte
// line) and writes depth and confidence the same way; every plane's load
// is issued before the first use, so a thread keeps D loads in flight.
//
// D > 64 (e.g. --ndepths 96,32,8) runs the streaming instance, which keeps
// no per-thread array of D. Its order of operations, per pixel:
//   pass 1, over chunks of kChunk planes in order (the loads of a chunk
//     issued together, planes past D read as -inf):
//       mc = max of the chunk; if mc > m: r = exp(m - mc) (0 while m is
//       -inf), s *= r, sdv *= r, sd *= r, m = mc;
//       then per plane d of the chunk in order: e = exp(cost_d - m),
//       s += e, sdv = fma(e, dv(d), sdv), sd = fma(e, d, sd);
//   depth = sdv / s,  i = clamp(trunc(sd / s), 0, D - 1);
//   pass 2 re-reads the <= 4 planes of the window, in order:
//       conf += exp(cost_d - m) / s.
// It divides once where the register instances divide per plane (p_d =
// e_d / s before the products), and rescales its sums when the running
// max rises, so its rounding differs from theirs; chip_smoke.py holds it
// to the same bounds (depth 1e-5 relative; confidence beyond 1e-4 on at
// most 1e-3 of the pixels, where trunc lands on the other side of an
// integer). The cost volume is still read once, plus <= 4 planes.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDepth = 64;   // the register instances' largest D
constexpr int kChunk = 16;      // planes loaded together (streaming)

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


// D > kMaxDepth: one pass with an online max, then the window re-read
// (the order of operations is in the file header).
__global__ void __launch_bounds__(kThreads)
depth_tail_stream(const float* __restrict__ cost,
                  const float* __restrict__ lo,
                  const float* __restrict__ step,
                  float* __restrict__ depth, float* __restrict__ conf,
                  int n_pix, int D) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_pix) return;
  const float ninf = -__int_as_float(0x7f800000);
  const float lo_p = __ldg(lo + p), step_p = __ldg(step + p);
  float m = ninf, s = 0.f, sdv = 0.f, sd = 0.f;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    float c[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      c[j] = d0 + j < D ? __ldg(cost + (long long)(d0 + j) * n_pix + p)
                        : ninf;
    float mc = c[0];
#pragma unroll
    for (int j = 1; j < kChunk; ++j) mc = fmaxf(mc, c[j]);
    if (mc > m) {
      const float r = expf(m - mc);        // exp(-inf) = 0 on the first
      s = __fmul_rn(s, r);
      sdv = __fmul_rn(sdv, r);
      sd = __fmul_rn(sd, r);
      m = mc;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float e = expf(c[j] - m);      // 0 past D
      const float d = (float)(d0 + j);
      const float dv = __fadd_rn(lo_p, __fmul_rn(d, step_p));
      s = __fadd_rn(s, e);
      sdv = __fmaf_rn(e, dv, sdv);
      sd = __fmaf_rn(e, d, sd);
    }
  }
  const int i = min(max((int)__fdiv_rn(sd, s), 0), D - 1);  // truncates
  float win = 0.f;
  for (int d = max(i - 1, 0); d <= min(i + 2, D - 1); ++d)
    win = __fadd_rn(
        win, __fdiv_rn(expf(__ldg(cost + (long long)d * n_pix + p) - m), s));
  depth[p] = __fdiv_rn(sdv, s);
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

// cost [D, n_pix], lo / step / depth / conf [n_pix], D >= 1.
extern "C" int depth_tail_f32(const float* cost, const float* lo,
                              const float* step, float* depth, float* conf,
                              int n_pix, int D, void* stream) {
  if (D < 1 || n_pix < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D > kMaxDepth) {
    depth_tail_stream<<<(n_pix + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        cost, lo, step, depth, conf, n_pix, D);
    return (int)cudaGetLastError();
  }
  switch (D) {
    case 8: return (int)launch<8>(cost, lo, step, depth, conf, n_pix, D, s);
    case 32: return (int)launch<32>(cost, lo, step, depth, conf, n_pix, D, s);
    case 48: return (int)launch<48>(cost, lo, step, depth, conf, n_pix, D, s);
    default: return (int)launch<0>(cost, lo, step, depth, conf, n_pix, D, s);
  }
}
