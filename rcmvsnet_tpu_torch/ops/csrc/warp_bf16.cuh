// Shared pieces of the bf16 plane-sweep kernels designed for Hopper on
// their own: K1-bf16 and K6-bf16 (warp_variance_bf16.cu), K7-bf16 and
// K7bwd-bf16 (warp_volume_bf16.cu). The float32 kernels stay on the
// templates of warp_fwd.cuh and warp_bwd.cuh.
//
// A group of L lanes owns one reference pixel, lane q N consecutive
// channels (N = 4 or 8: one 8- or 16-byte gather a tap). The projections
// are shared (warp_fwd.cuh's hand-off: lane q projects views q, q + L,
// ... and the group passes each view's taps on with __shfl_sync); the
// forwards project plane d + 1 while plane d's gathers are in flight
// (next_plane), stage each plane's rows in bf16 and write them as 16-byte
// vectors (store_rows). The
// backwards' runs (warp_bwd.cuh's fixed-point scatter) are worked out once
// for the lane's N channels and flushed through shared memory, so that
// each integer add instruction of the group covers L consecutive words
// (flush below). Each channel's float sequence is the template instances'
// (warp_bwd.cuh's bf16 note), so the outputs equal theirs in every bit.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "warp_common.cuh"
#include "warp_fwd.cuh"

namespace warpb {

using bf16 = __nv_bfloat16;
using warp::Taps;

constexpr int kThreads = 256;      // a block

// N bf16 (N = 4, 8: one 8- or 16-byte load) as N / 2 words, each two
// elements, the first in the low half.
template <int N>
__device__ __forceinline__ void load_words(const bf16* p,
                                           unsigned (&w)[N / 2]) {
  if constexpr (N == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else {
    static_assert(N == 8, "4 or 8 channels a lane");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  }
}

// Element i of words w, widened exactly.
template <int M>
__device__ __forceinline__ float elem(const unsigned (&w)[M], int i) {
  return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                 : (w[i >> 1] << 16));
}

template <int N>
__device__ __forceinline__ void load_bf16(const bf16* p, float (&v)[N]) {
  unsigned w[N / 2];
  load_words<N>(p, w);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = elem(w, i);
}

// a, b rounded to bf16 (to nearest even) by one packed conversion; a in
// the low half
__device__ __forceinline__ unsigned pack_rn(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float bf16_rn(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// Whether tap k of taps t lies inside the image.
__device__ __forceinline__ bool tap_in(const Taps& t, int k, int H, int W) {
  const int xi = t.x0 + (k & 1), yi = t.y0 + (k >> 1);
  return xi >= 0 && xi < W && yi >= 0 && yi < H;
}

// The four taps' channels [c0, c0 + N) of map base [H, W, C] bf16 (zero
// where a tap lies outside the image): the loads of a bilinear sample.
template <int C, int N>
__device__ __forceinline__ void load_taps(const bf16* base, const Taps& t,
                                          int H, int W, int c0,
                                          unsigned (&w)[4][N / 2]) {
  const long long p00 = ((long long)t.y0 * W + t.x0) * C + c0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) w[k][i] = 0u;
    if (tap_in(t, k, H, W))
      load_words<N>(base + p00 + ((k >> 1) ? (long long)W * C : 0) +
                        ((k & 1) ? C : 0),
                    w[k]);
  }
}

// The bilinear sample from its loaded taps: sample_quad's rule
// (warp_common.cuh) on N channels, the taps in order 0..3, one fused
// multiply-add each with the tap's weight bf16(wx_k) * wy_k; a tap
// outside the image adds nothing.
template <int N>
__device__ __forceinline__ void fma_taps(const Taps& t, int H, int W,
                                         const unsigned (&w)[4][N / 2],
                                         float (&val)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) val[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!tap_in(t, k, H, W)) continue;
    const float wgt = warp::tap_weight_bf16(t, k);
#pragma unroll
    for (int i = 0; i < N; ++i) val[i] = __fmaf_rn(wgt, elem(w[k], i), val[i]);
  }
}

// The projection hand-off and the gathers of one plane at depth dv: the
// taps tn[v] of each source view (lane q projects views q, q + L, ...;
// rr their rot * [x, y, 1], warp_fwd.cuh) and the lane's channels [c0,
// c0 + N) of their four taps in src [V, H, W, C]. NV bounds the source
// views; EXACT: exactly NV, else nv of them.
template <int C, int N, int L, int S, int NV, bool EXACT>
__device__ __forceinline__ void fetch_views(Taps (&tn)[NV],
                                            unsigned (&wn)[NV][4][N / 2],
                                            const float (&rr)[S][3],
                                            const float* s_rel,
                                            const bf16* src, long long HW,
                                            int q, int nv, float dv, int H,
                                            int W, int c0) {
  Taps mine[S];
  warp::project_mine<S, L>(mine, rr, s_rel, q, nv, dv, H, W);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!EXACT && v >= nv) break;          // the same in the whole warp
    tn[v] = warp::taps_of_view<S, L>(mine, v);
    load_taps<C, N>(src + (long long)(v + 1) * HW * C, tn[v], H, W, c0,
                    wn[v]);
  }
}

// Plane d's taps of the views lane q projects, handed from next to mine,
// and plane d + 1's projected into next (rr: their rot * [x, y, 1],
// warp_fwd.cuh): the next projection has no dependence on this plane's
// gathers, so it runs while they are in flight. Past the last plane the
// projection is made and not used.
template <int S, int L>
__device__ __forceinline__ void next_plane(Taps (&mine)[S], Taps (&next)[S],
                                           const float (&rr)[S][3],
                                           const float* s_rel, int q, int nv,
                                           float lo_p, float step_p, int d,
                                           int H, int W) {
#pragma unroll
  for (int s = 0; s < S; ++s) mine[s] = next[s];
  warp::project_mine<S, L>(next, rr, s_rel, q, nv,
                           warp::plane_depth(lo_p, step_p, d + 1), H, W);
}

// A plane's staged rows out: staged row r (P bf16 at so + r * PS, PS % 8
// == 0) to dst(r) + off, the run of P consecutive pixels from p0 of its
// output row, nothing at or past pixel HW. vec (h*w % 8 == 0, every
// output row 16-byte aligned): 16-byte vectors of 8 pixels; else element
// by element.
template <int P, class Dst>
__device__ __forceinline__ void store_rows(const bf16* so, int PS, int rows,
                                           Dst dst, long long off,
                                           long long p0, long long HW,
                                           bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * (P / 8); i += kThreads) {
      const int r = i / (P / 8), jj = 8 * (i % (P / 8));
      if (p0 + jj < HW)
        *reinterpret_cast<uint4*>(dst(r) + off + jj) =
            *reinterpret_cast<const uint4*>(so + r * PS + jj);
    }
  } else {
    for (int i = threadIdx.x; i < rows * P; i += kThreads) {
      const int r = i / P, jj = i - r * P;
      if (p0 + jj < HW) dst(r)[off + jj] = so[r * PS + jj];
    }
  }
}

// One source view's run of consecutive planes that share a top-left tap:
// the tap and, per tap k and channel i of the lane, a float sum.
template <int N>
struct Run {
  int x0, y0;
  float acc[4][N];
};

// A run that covers no tap: its first plane always starts a new one.
template <int N>
__device__ __forceinline__ void run_clear(Run<N>& r) {
  r.x0 = r.y0 = -(1 << 30);
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) r.acc[k][i] = 0.f;
}

// Add the run's sums, in quanta, into dst [H, W, C] at its taps inside the
// image (warp::flush_taps). The group's L lanes (mask) hand their N
// channels over through fl, its [4][C] floats of shared memory, so that
// lane q adds channels q, q + L, ...: each integer add instruction of the
// group covers L consecutive words, as the template's C lanes do, rather
// than one word in every N.
template <int C, int N, int L>
__device__ __forceinline__ void flush(unsigned long long* dst,
                                      const Run<N>& r, float (*fl)[C],
                                      unsigned mask, int H, int W, int q,
                                      double to_q) {
  if (!(to_q > 0.0)) return;          // all-zero or non-finite inputs
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) fl[k][N * q + i] = r.acc[k][i];
  __syncwarp(mask);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = r.x0 + (k & 1), yi = r.y0 + (k >> 1);
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    unsigned long long* p = dst + ((long long)yi * W + xi) * C + q;
#pragma unroll
    for (int i = 0; i < N; ++i)
      atomicAdd(p + i * L, (unsigned long long)llrint(
                               (double)fl[k][i * L + q] * to_q));
  }
  __syncwarp(mask);                   // fl is free for the next flush
}

// Tap k of the run receives bf16(cot_i * wy_k) * bf16(wx_k), channel i
// (warp_bwd.cuh's bf16 rule on N channels: bf16(wx_k) once, two
// channels' products rounded by one packed conversion).
template <int N>
__device__ __forceinline__ void run_add(Run<N>& r, const Taps& t,
                                        const float (&cot)[N]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wy = (k >> 1) ? t.wy : __fsub_rn(1.f, t.wy);
    const float wx = bf16_rn((k & 1) ? t.wx : __fsub_rn(1.f, t.wx));
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const unsigned ty = pack_rn(__fmul_rn(cot[i], wy),
                                  __fmul_rn(cot[i + 1], wy));
      r.acc[k][i] = __fmaf_rn(wx, __uint_as_float(ty << 16), r.acc[k][i]);
      r.acc[k][i + 1] =
          __fmaf_rn(wx, __uint_as_float(ty & 0xffff0000u), r.acc[k][i + 1]);
    }
  }
}

// s[dd][r][jj] = g[r, d0 + dd, p0 + jj] in bf16 for the DCH planes from
// d0 and the R rows of g [R', D, h, w], zero past D, the image or row
// `rows`: vec (h*w % 8 == 0, g 16-byte aligned) in 16-byte loads of 8
// pixels, else element by element.
template <int R, int P, int PG, int DCH>
__device__ __forceinline__ void stage_g(bf16 (*s)[R][PG],
                                        const bf16* __restrict__ g,
                                        long long p0, long long HW, int d0,
                                        int D, bool vec, int rows = R) {
  if (vec) {
    constexpr int CH = P / 8;             // 16-byte chunks a row
    for (int i = threadIdx.x; i < DCH * R * CH; i += kThreads) {
      const int ch = i % CH, row = i / CH, c = row % R, dd = row / R;
      const int d = d0 + dd;
      const long long pp = p0 + 8 * ch;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (d < D && pp < HW && c < rows)
        u = __ldg(reinterpret_cast<const uint4*>(
            g + ((long long)c * D + d) * HW + pp));
      unsigned* o = reinterpret_cast<unsigned*>(&s[dd][c][8 * ch]);
      o[0] = u.x;
      o[1] = u.y;
      o[2] = u.z;
      o[3] = u.w;
    }
  } else {
    for (int i = threadIdx.x; i < DCH * R * P; i += kThreads) {
      const int jj = i % P, c = (i / P) % R, dd = i / (P * R);
      const long long pp = p0 + jj;
      const int d = d0 + dd;
      s[dd][c][jj] = pp < HW && d < D && c < rows
          ? g[((long long)c * D + d) * HW + pp] : __float2bfloat16_rn(0.f);
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace warpb
