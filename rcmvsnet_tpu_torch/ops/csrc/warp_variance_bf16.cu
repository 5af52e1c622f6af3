// The bf16 plane-sweep warp + variance (K1-bf16) and its backward
// (K6-bf16), designed for Hopper on their own. The float32 kernels stay on
// the shared templates of warp_variance.cu (warp_fwd.cuh, warp_bwd.cuh).
// What K1-bf16 and K6-bf16 share with K7's bf16 pair (warp_volume_bf16.cu)
// is in warp_bf16.cuh.
//
// K1-bf16 replaces rcmvsnet_tpu/ops/pallas_warp2.py
// plane_sweep_variance_lanes at compute dtype = out dtype = bf16 (its
// defaults, :400; pallas_call :506/:554), and the train forward of
// pallas_warp_train.py:335-346. Per (depth plane d, reference pixel) and
// channel it computes what warp_variance.cu's float32 K1 does, in the same
// order of operations: dv = lo + d * step, each source view sampled at its
// projection (warp_common.cuh, the pinned rounding of each operation) with
// each bilinear x weight rounded to bf16 before it multiplies the float32 y
// weight, the reference channel first, then taps 0..3 with one fused
// multiply-add each and the views in order, sum and sum of squares in
// float32, the variance sum_sq * (1/V) - (sum * (1/V))^2 rounded to bf16
// once (pallas_warp2.py:228-243, :151). So its output is the same in every
// bit as the float32 template's bf16 instance that it replaces
// (tools/ab_warp_fwd.py holds builds to each other with torch.equal).
//
// K6-bf16 replaces the backward of pallas_warp_train.py
// plane_sweep_variance_fused_train at compute dtype bf16 (:306, its
// default :310; _warp_var_bwd_kernel :108, pallas_call :374). With x_v the
// bf16 forward's sample of view v, mean = sum_v x_v / V and g the
// cotangent of the variance, e_v = (2/V) g (x_v - mean) in float32; source
// tap k of a sample receives bf16(e_v * wy_k) * bf16(wx_k) (the JAX kernel
// rounds each y-weighted cotangent row and its x hat weights, :180-182,
// :202-206, :251-253, :272-275), the reference view (2/V) g (x_0 - mean)
// summed over the planes in float32, and dsrc is rounded to bf16 once
// (:400). The scatter is warp_bwd.cuh's 64-bit fixed point (runs of planes
// that share a top-left tap, flushed as integer adds into quanta 2^e), so
// the output repeats bit for bit, and each channel's float sequence is the
// template instance's, so it equals that instance's output bit for bit
// (tools/ab_warp_bwd.py).
//
// What held the template instances back. Neither is bound by bytes (K1
// moves its output in 6-9x less time than it takes, K6 its g and dsrc in
// 26x less); both are bound by the work each lane repeats per plane. The
// float32 design gives K1 a float4 of channels a lane and K6 one channel a
// lane; on bf16 maps the same lanes gather half the bytes for the same
// instructions:
//   * K6's C lanes a pixel each projected every source view (two IEEE
//     divisions a view), kept every view's run bookkeeping and rounded
//     bf16(wx_k) once a channel, and each tap was a 2-byte load;
//   * K1's C/4 lanes gathered 8 bytes a tap and wrote scalar bf16 stores,
//     64-byte runs a row at C = 32.
// What these designs do about it:
//   * K1-bf16: 8 channels a lane (L = C/8 lanes a pixel, one 16-byte gather
//     a tap, the four taps' loads issued before their multiply-adds); the
//     projections shared as in warp_fwd.cuh (lane q projects views q,
//     q + L, ... and the group passes each view's taps on with
//     __shfl_sync); plane d + 1's projection computed while plane d's
//     gathers are in flight; the plane's variances staged in bf16 and
//     written as 16-byte vectors, runs of P = 2048/C pixels (128 bytes a
//     row at C = 32, 512 at C = 8).
//   * K6-bf16: kBwdCh = 4 channels a lane (L = C/4 lanes a pixel, one
//     8-byte gather a tap), so the projections (shared as above), the run
//     bookkeeping and bf16(wx_k) are worked out once for 4 channels;
//     bf16(e * wy_k) of two channels rounded by one packed conversion;
//     plane d + 1's projection and gathers issued before plane d's
//     multiply-adds and run updates (at 1 block an SM, register-bound,
//     the extra registers cost no occupancy); g staged along pixels in
//     16-byte vectors, in bf16, rows padded so that the lanes' reads fall
//     on distinct banks; the division by V a multiplication where V is a
//     power of two (both round the same real number once, so the bits do
//     not change), and the train step's V = 4 an instance of its own,
//     whose view loops have no run-time bound (each 3-4 % of K6-bf16's
//     time in the bf16 step's trace, PERF.md). The scatter is the
//     template's, one integer add per flushed in-image tap and channel; a
//     run is per pixel and view, so the flush boundaries are the
//     template's. A flush hands the group's
//     sums over through shared memory so that each add instruction covers
//     L consecutive words, as the template's C lanes do: with each lane
//     adding its own 4 consecutive words instead, every instruction hit
//     one word in four and the kernel took 37 % longer.
// Measured and not adopted (tools/ab_warp_fwd.py, ab_warp_bwd.py; PERF.md):
// K6 at 2 channels a lane, at 2 planes a loop turn, at 2 blocks an SM
// (128 registers, spills); K1 at 4 channels a lane, at 3 blocks an SM,
// without the projection one plane ahead, with the gathers one plane
// ahead (up to 255 registers, 1 block an SM), with instances of its own
// for the main path's view counts (V = 4, 5, 7) beside the buckets
// NV = 3, 7, 15.
// tests/test_torch_warp_bf16_lanes.py emulates both lane maps and the
// flush rule on the CPU.
//
// Layouts (the template instances'): src and dsrc [V, h, w, C] bf16
// channels-last, rel [V, 16] float (row 0 unused), lo and step [h, w]
// float, out and g [C, D, h, w] bf16; the backward's scratch is
// warp_bwd.cuh's Aux, then int64 quanta [V-1, h, w, C].
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "warp_bf16.cuh"
#include "warp_bwd.cuh"
#include "warp_common.cuh"
#include "warp_fwd.cuh"

namespace {

using namespace warpb;
using warp::kMaxViews;
using warp::project_mine;
using warp::rot_rows;
using warp::taps_of_view;

constexpr int kFwdCh = 8;          // K1-bf16: channels a lane
constexpr int kBwdCh = 4;          // K6-bf16: channels a lane
constexpr int kPlaneChunk = 8;     // K6-bf16: planes of g staged a barrier
static_assert(kThreads == warp::kFwdThreads, "K1-bf16's grid: fwd_plan");

// ------------------------------------------------------------ K1-bf16

// A block: P consecutive reference pixels (L = C/8 lanes each, lane q
// channels [8q, 8q + 8)) over the planes [d0, d0 + DC) of its chunk.
// NV bounds the source views. vec: out takes 16-byte stores (h*w % 8 ==
// 0, out 16-byte aligned).
template <int C, int NV>
__global__ void __launch_bounds__(kThreads)
warp_variance_bf16_kernel(const bf16* __restrict__ src,
                          const float* __restrict__ rel,
                          const float* __restrict__ lo,
                          const float* __restrict__ step,
                          bf16* __restrict__ out, int V, int H, int W,
                          int D, int DC, bool vec) {
  constexpr int N = kFwdCh, L = C / N, P = kThreads / L;
  constexpr int S = (NV + L - 1) / L;       // views a lane projects
  constexpr int PS = P + 8;                 // staging row, 16-byte aligned
  __shared__ float s_rel[kMaxViews * 16];
  __shared__ __align__(16) bf16 s_out[2][C][PS];
  for (int i = threadIdx.x; i < V * 16; i += blockDim.x) s_rel[i] = rel[i];
  __syncthreads();

  const long long HW = (long long)H * W;
  const int j = threadIdx.x / L, q = threadIdx.x % L;
  const long long p0 = (long long)blockIdx.x * P;
  // a pixel past the image computes the last one (its lanes take part in
  // the shuffles) and writes nothing
  const long long pix = min(p0 + j, HW - 1);
  const int y = (int)(pix / W);
  const float fx = (float)(pix - (long long)y * W), fy = (float)y;
  const float lo_p = lo[pix], step_p = step[pix];
  const int nv = V - 1;
  const float inv_v = __fdiv_rn(1.f, (float)V);
  float ref[N], ref_sq[N];
  load_bf16<N>(src + pix * C + N * q, ref);
#pragma unroll
  for (int i = 0; i < N; ++i) ref_sq[i] = __fmul_rn(ref[i], ref[i]);

  float rr[S][3];
  rot_rows<S, L>(rr, s_rel, q, nv, fx, fy);
  const int d0 = blockIdx.y * DC, d1 = min(D, d0 + DC);
  Taps next[S];
  project_mine<S, L>(next, rr, s_rel, q, nv,
                     warp::plane_depth(lo_p, step_p, d0), H, W);
  for (int d = d0; d < d1; ++d) {
    Taps mine[S];
    next_plane<S, L>(mine, next, rr, s_rel, q, nv, lo_p, step_p, d, H, W);
    float sum[N], sq[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sum[i] = ref[i];
      sq[i] = ref_sq[i];
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (v >= nv) break;                  // the same in the whole warp
      const Taps t = taps_of_view<S, L>(mine, v);
      unsigned w[4][N / 2];
      float val[N];
      load_taps<C, N>(src + (long long)(v + 1) * HW * C, t, H, W, N * q, w);
      fma_taps<N>(t, H, W, w, val);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        sum[i] = __fadd_rn(sum[i], val[i]);
        sq[i] = __fadd_rn(sq[i], __fmul_rn(val[i], val[i]));
      }
    }
    bf16(*so)[PS] = s_out[(d - d0) & 1];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float mean = __fmul_rn(sum[i], inv_v);
      so[N * q + i][j] = __float2bfloat16_rn(
          __fsub_rn(__fmul_rn(sq[i], inv_v), __fmul_rn(mean, mean)));
    }
    __syncthreads();
    // C runs of P consecutive bf16 of out[c, d, :, :]; the two staging
    // buffers alternate between planes, so one barrier a plane suffices
    store_rows<P>(&so[0][0], PS, C,
                  [&](int r) { return out + (long long)r * D * HW; },
                  (long long)d * HW + p0, p0, HW, vec);
  }
}

template <int C, int NV>
void launch_fwd(const bf16* src, const float* rel, const float* lo,
                const float* step, bf16* out, int V, int H, int W, int D,
                bool vec, cudaStream_t stream) {
  // a block walks all D planes where the pixel blocks alone fill the
  // card, else a chunk of them (warp_fwd.cuh)
  const warp::Plan p = warp::fwd_plan(H, W, C, D, kFwdCh);
  warp_variance_bf16_kernel<C, NV>
      <<<dim3((unsigned)p.nx, (unsigned)p.nz), kThreads, 0, stream>>>(
          src, rel, lo, step, out, V, H, W, D, p.dc, vec);
}

template <int C>
void fwd_views(const bf16* src, const float* rel, const float* lo,
               const float* step, bf16* out, int V, int H, int W, int D,
               bool vec, cudaStream_t s) {
  if (V <= 4)
    launch_fwd<C, 3>(src, rel, lo, step, out, V, H, W, D, vec, s);
  else if (V <= 8)
    launch_fwd<C, 7>(src, rel, lo, step, out, V, H, W, D, vec, s);
  else
    launch_fwd<C, 15>(src, rel, lo, step, out, V, H, W, D, vec, s);
}

// ------------------------------------------------------------ K6-bf16

// A block: P consecutive reference pixels, L = C / kBwdCh lanes each
// (lane q channels [q * kBwdCh, (q + 1) * kBwdCh)), walking all D planes
// in order, g staged kPlaneChunk planes at a time. NV bounds the source
// views; EXACT: exactly NV (the train step's V = 4).
template <int C, int NV, bool EXACT>
__global__ void __launch_bounds__(kThreads)
warp_variance_bwd_bf16_kernel(const bf16* __restrict__ src,
                              const float* __restrict__ rel,
                              const float* __restrict__ lo,
                              const float* __restrict__ step,
                              const bf16* __restrict__ g,
                              bf16* __restrict__ dsrc,
                              unsigned long long* __restrict__ acc,
                              const warp::Quantum* __restrict__ quantum,
                              int V, int H, int W, int D, bool vec) {
  constexpr int N = kBwdCh, L = C / N, P = kThreads / L;
  constexpr int S = (NV + L - 1) / L;       // views a lane projects
  // a staged row of g: P pixels and a pad that puts the L lanes of a
  // pixel, reading channels q * N + i, on distinct banks
  constexpr int PG = P + 64 / C;
  static_assert(PG % 2 == 0 && P % 8 == 0, "staging rows of whole words");
  __shared__ float s_rel[kMaxViews * 16];
  __shared__ __align__(16) bf16 s_g[kPlaneChunk][C][PG];
  __shared__ __align__(16) float s_fl[P][4][C];     // each group's flushes
  for (int i = threadIdx.x; i < V * 16; i += blockDim.x) s_rel[i] = rel[i];
  __syncthreads();

  const long long HW = (long long)H * W;
  const int j = threadIdx.x / L, q = threadIdx.x % L, c0 = N * q;
  // this lane's group of L lanes in its warp
  static_assert(L < 32, "a group is part of a warp");
  const unsigned mask = ((1u << L) - 1u) << (threadIdx.x % 32 / L * L);
  const long long p0 = (long long)blockIdx.x * P;
  // a pixel past the image computes the last one (its lanes take part in
  // the shuffles) and adds and writes nothing
  const bool live = p0 + j < HW;
  const long long pix = live ? p0 + j : HW - 1;
  const int y = (int)(pix / W);
  const float fx = (float)(pix - (long long)y * W), fy = (float)y;
  const float lo_p = lo[pix], step_p = step[pix];
  const double to_q = quantum->to_q;
  const int nv = EXACT ? NV : V - 1;
  const float fv = (float)V;
  const float scale = __fdiv_rn(2.f, fv);
  // x / V, rounded once: for V a power of two x * (1/V) is the same
  // correctly rounded quotient
  const bool pow2 = (V & (V - 1)) == 0;
  const float inv_v = __fdiv_rn(1.f, fv);
  float ref[N];
  load_bf16<N>(src + pix * C + c0, ref);

  float rr[S][3];
  rot_rows<S, L>(rr, s_rel, q, nv, fx, fy);
  Run<N> run[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) run_clear(run[v]);
  float dref[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dref[i] = 0.f;

  // plane d's taps and loaded words of each view, fetched while plane
  // d - 1 adds up its cotangents
  Taps tn[NV];
  unsigned wn[NV][4][N / 2];
  auto fetch = [&](int d) {
    fetch_views<C, N, L, S, NV, EXACT>(tn, wn, rr, s_rel, src, HW, q, nv,
                                       warp::plane_depth(lo_p, step_p, d),
                                       H, W, c0);
  };
  fetch(0);
  for (int d0 = 0; d0 < D; d0 += kPlaneChunk) {
    __syncthreads();                 // the last chunk's reads are done
    stage_g<C, P, PG, kPlaneChunk>(s_g, g, p0, HW, d0, D, vec);
    __syncthreads();
    const int dn = min(kPlaneChunk, D - d0);
    for (int dd = 0; dd < dn; ++dd) {
      Taps t[NV];
      unsigned w[NV][4][N / 2];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!EXACT && v >= nv) break;
        t[v] = tn[v];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < N / 2; ++i) w[v][k][i] = wn[v][k][i];
      }
      fetch(d0 + dd + 1);            // past the last plane: read, unused
      float x[NV][N], sum[N];
#pragma unroll
      for (int i = 0; i < N; ++i) sum[i] = ref[i];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!EXACT && v >= nv) break;
        fma_taps<N>(t[v], H, W, w[v], x[v]);
#pragma unroll
        for (int i = 0; i < N; ++i) sum[i] = __fadd_rn(sum[i], x[v][i]);
      }
      float mean[N], gs[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        mean[i] = pow2 ? __fmul_rn(sum[i], inv_v) : __fdiv_rn(sum[i], fv);
        gs[i] = __fmul_rn(scale, __bfloat162float(s_g[dd][c0 + i][j]));
        dref[i] = __fmaf_rn(gs[i], __fsub_rn(ref[i], mean[i]), dref[i]);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!EXACT && v >= nv) break;
        if (run[v].x0 != t[v].x0 || run[v].y0 != t[v].y0) {
          if (live)
            flush<C, N, L>(acc + (long long)v * HW * C, run[v], s_fl[j],
                           mask, H, W, q, to_q);
          run[v].x0 = t[v].x0;
          run[v].y0 = t[v].y0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < N; ++i) run[v].acc[k][i] = 0.f;
        }
        float cot[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          cot[i] = __fmul_rn(gs[i], __fsub_rn(x[v][i], mean[i]));
        run_add<N>(run[v], t[v], cot);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!EXACT && v >= nv) break;
    flush<C, N, L>(acc + (long long)v * HW * C, run[v], s_fl[j], mask, H,
                   W, q, to_q);
  }
  static_assert(N == 4, "one 8-byte store of dref");
  *reinterpret_cast<uint2*>(dsrc + pix * C + c0) =
      make_uint2(pack_rn(dref[0], dref[1]), pack_rn(dref[2], dref[3]));
}

template <int C, int NV, bool EXACT>
void launch_bwd(const bf16* src, const float* rel, const float* lo,
                const float* step, const bf16* g, bf16* dsrc,
                unsigned long long* acc, const warp::Quantum* q, int V,
                int H, int W, int D, bool vec, cudaStream_t stream) {
  constexpr int P = kThreads / (C / kBwdCh);
  const long long HW = (long long)H * W;
  warp_variance_bwd_bf16_kernel<C, NV, EXACT>
      <<<(unsigned)((HW + P - 1) / P), kThreads, 0, stream>>>(
          src, rel, lo, step, g, dsrc, acc, q, V, H, W, D, vec);
}

template <int C>
void bwd_views(const bf16* src, const float* rel, const float* lo,
               const float* step, const bf16* g, bf16* dsrc,
               unsigned long long* acc, const warp::Quantum* q, int V, int H,
               int W, int D, bool vec, cudaStream_t s) {
  if (V == 4)
    launch_bwd<C, 3, true>(src, rel, lo, step, g, dsrc, acc, q, V, H, W, D,
                           vec, s);
  else if (V <= 4)
    launch_bwd<C, 3, false>(src, rel, lo, step, g, dsrc, acc, q, V, H, W, D,
                            vec, s);
  else if (V <= 8)
    launch_bwd<C, 7, false>(src, rel, lo, step, g, dsrc, acc, q, V, H, W, D,
                            vec, s);
  else
    launch_bwd<C, 15, false>(src, rel, lo, step, g, dsrc, acc, q, V, H, W,
                             D, vec, s);
}

}  // namespace

// K1-bf16: src [V, H, W, C] and out [C, D, H, W] bf16; src 16-byte
// aligned (one 16-byte gather a tap).
extern "C" int warp_variance_bf16(const bf16* src, const float* rel,
                                  const float* lo, const float* step,
                                  bf16* out, int V, int H, int W, int C,
                                  int D, void* stream) {
  if (V < 1 || V > kMaxViews || D < 1 || (long long)H * W < 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(src)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (long long)H * W % 8 == 0 && aligned16(out);
  switch (C) {
    case 8: fwd_views<8>(src, rel, lo, step, out, V, H, W, D, vec, s); break;
    case 16: fwd_views<16>(src, rel, lo, step, out, V, H, W, D, vec, s);
      break;
    case 32: fwd_views<32>(src, rel, lo, step, out, V, H, W, D, vec, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Bytes of the scratch warp_variance_bwd_bf16 takes (any contents).
extern "C" long long warp_variance_bf16_bwd_scratch_bytes(int V, int H,
                                                          int W, int C) {
  return warp::variance_bwd_scratch_bytes(V, H, W, C);
}

// K6-bf16. src, g and dsrc bf16 (src and dsrc 8-byte aligned); every
// element of dsrc is written; scratch holds
// warp_variance_bf16_bwd_scratch_bytes(V, H, W, C) bytes.
extern "C" int warp_variance_bwd_bf16(const bf16* src, const float* rel,
                                      const float* lo, const float* step,
                                      const bf16* g, bf16* dsrc,
                                      void* scratch, int V, int H, int W,
                                      int C, int D, void* stream) {
  if (V < 1 || V > kMaxViews || D < 1 || (long long)H * W < 1)
    return (int)cudaErrorInvalidValue;
  if (C != 8 && C != 16 && C != 32) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(src) % (2 * kBwdCh) != 0 ||
      reinterpret_cast<uintptr_t>(dsrc) % (2 * kBwdCh) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const long long HW = (long long)H * W;
  warp::Aux* aux = static_cast<warp::Aux*>(scratch);
  auto* acc = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + warp::kAuxBytes);
  warp::AbsMaxArgs a{{src, g, nullptr, nullptr},
                     {V * HW * C, C * D * HW, 0, 0},
                     {true, true, false, false}};
  warp::prepare_scratch(scratch,
                        warp_variance_bf16_bwd_scratch_bytes(V, H, W, C), a,
                        D * HW, V, false, s);
  const bool vec = HW % 8 == 0 && aligned16(g);
  switch (C) {
    case 8: bwd_views<8>(src, rel, lo, step, g, dsrc, acc, aux->q, V, H, W,
                         D, vec, s); break;
    case 16: bwd_views<16>(src, rel, lo, step, g, dsrc, acc, aux->q, V, H,
                           W, D, vec, s); break;
    default: bwd_views<32>(src, rel, lo, step, g, dsrc, acc, aux->q, V, H,
                           W, D, vec, s); break;
  }
  warp::finish_quanta(acc, dsrc + HW * C, (V - 1) * HW * C, C, C, aux->q,
                      s);
  return (int)cudaGetLastError();
}
