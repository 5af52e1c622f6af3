// Shared pieces of the tensor-core convolutions, for Hopper (sm_90a): the
// float32 3x3x3 ones (conv3d.cu, K2/K9, and conv3d_dw.cu, K8's weight
// gradient) and FeatureNet's float32 2D convs (conv2d.cu, K5). The bf16
// convs have designs of their own (conv3d_bf16.cu, conv3d_dw_bf16.cu,
// conv2d_bf16.cu, tc_bf16.cuh), which take the element helpers and the
// bf16 weight words below.
//
// Products (Elem<float> below): mma.sync.aligned.m16n8k8 with TF32
// operands and float32 accumulators. The float32 path's gates hold each
// call to 1e-4 of its largest value; one TF32 product (10-bit mantissa)
// misses that by 3x, so every product is 3xTF32: a = a_hi + a_lo with both
// halves rounded to TF32 as cvt.rna.tf32.f32 rounds (nearest, ties away;
// done as an integer add and mask, the same bits on full-rate ALU ops),
// acc += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (a_lo*b_lo, ~2^-22 of the
// product, is dropped). A chunk is 8 channels, 32 bytes a position; the
// weights are rows of 32-bit words [tap][8 rows][NW co].
// Accumulation: the tensor cores add into their float32 accumulators
// with truncation, so an error of up to ~2^-23 of the running sum per MMA
// grows with the length of the chain (measured: 2e-4 of the largest dw
// value over a run of ~30k positions). Each kernel therefore runs MMAs
// into short-lived accumulators over a few dozen products and adds them
// into a float32 total with ordinary round-to-nearest adds (flush). The
// three products of a 3xTF32 step go to S = 3 separate accumulators where
// registers allow: three independent MMA chains instead of one.
//
// Bricks: a block owns a brick of "base" positions, BZ x BY x 16 in z, y,
// x (16 = one m16 row tile or two k8 steps), and stages the input it reads
// -- the brick plus its halo -- in shared memory with cp.async, 8 input
// channels at a time, zero-filled outside the volume (the padding). The
// base grid is the output grid for stride 1 ("s1", mode 0) and stride 2
// ("s2", mode 1), and the INPUT grid for the transposed conv ("t2", mode
// 2), which runs as 8 dense parity classes: output o = 2*b + p reads, per
// axis, tap 1 from input b when p = 0, taps 0 and 2 from inputs b + 1 and
// b when p = 1 -- 27 taps per base position over the 8 classes, none on a
// stuffed zero.
//   halo brick per axis: s1 extent + 2 (origin b0 - 1); s2 2*extent + 1
//   (origin 2*b0 - 1, x stored as two parity halves so that a stride-2
//   read is contiguous); t2 extent + 1 (origin b0). In x, the s1 and t2
//   rows are staged as whole 16-byte vectors (s1: inputs bx0 - 4 ..
//   bx0 + 19, t2: bx0 .. bx0 + 19) with 16-byte cp.async when the rows of
//   the volume are 16-byte aligned (W % 4 == 0), one float at a time
//   otherwise.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBX = 16;      // brick width in x
constexpr int kCiChunk = 8;  // float input channels staged at a time
                             // (mma k = 8); rows of a weight chunk
using bf16 = __nv_bfloat16;

// Smallest m >= n with m = r (mod 32): the stride between channel planes
// (or rows) that puts the lanes of one fragment load on distinct banks.
constexpr int pad_to(int n, int r) { return n + ((r - n % 32) + 32) % 32; }

// Row stride of a chunk's staged weights [tap][ci][NW co]: B fragment
// loads at t * stride + g fall on distinct banks for 8 or 24 (mod 32).
constexpr int weight_stride(int nw) {
  return (nw % 32 == 8 || nw % 32 == 24) ? nw : nw + 8;
}

template <int MODE, int BZ, int BY, class T = float>
struct Halo {
  static constexpr int EZ = MODE == 0 ? BZ + 2 : MODE == 1 ? 2 * BZ + 1 : BZ + 1;
  static constexpr int EY = MODE == 0 ? BY + 2 : MODE == 1 ? 2 * BY + 1 : BY + 1;
  static constexpr int EX = MODE == 0 ? kBX + 2 : MODE == 1 ? 2 * kBX + 1 : kBX + 1;
  static constexpr int XH = kBX + 1;                       // even half (s2)
  static constexpr bool VEC = MODE != 1;                   // vector rows
  // smem row: s2 two parity halves; s1 inputs bx0 - 4 .. bx0 + 19 and t2
  // bx0 .. bx0 + 19, whole vectors
  static constexpr int XS = MODE == 1 ? 2 * XH : MODE == 0 ? kBX + 8
                                                           : kBX + 4;
  static_assert(MODE == 1 || (MODE == 2 ? EX : EX + 3) <= XS, "row fits");
  static constexpr int NV = XS / 4;                        // vectors a row
  static constexpr int PLANE = EZ * EY * XS;

  // brick-relative x (input origin(bx0) + rx) -> column in the smem row
  static __device__ __forceinline__ int xcol(int rx) {
    return MODE == 1 ? (rx & 1) * XH + (rx >> 1) : MODE == 2 ? rx : rx + 3;
  }
  // first input index of the halo brick for base origin b0
  static __device__ __forceinline__ int origin(int b0) {
    return MODE == 0 ? b0 - 1 : MODE == 1 ? 2 * b0 - 1 : b0;
  }
  // first input x of the staged row (VEC rows): column 0
  static __device__ __forceinline__ int row_origin(int bx0) {
    return MODE == 0 ? bx0 - 4 : MODE == 1 ? 2 * bx0 - 4 : bx0;
  }
};

// Per-axis tap of a transposed-conv parity class: p = 0 has one tap (k 1,
// input offset 0); p = 1 has two, chosen by bit: (k 0, offset 1), (k 2, 0).
__device__ __forceinline__ void t2_tap(int p, int bit, int& k, int& off) {
  k = p ? (bit ? 2 : 0) : 1;
  off = (p && !bit) ? 1 : 0;
}

// v rounded to TF32 as cvt.rna.tf32.f32 does: to nearest on the 10-bit
// mantissa, ties away from zero (the magnitude's bits plus half a TF32
// ulp, low 13 bits cleared).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// 3xTF32 split: v = hi + lo, both TF32; v - hi is exact in float32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// total += the sum of the S partial accumulators; part = 0 (the flush of
// the accumulation note above).
template <int A, int B, int S>
__device__ __forceinline__ void flush(float (&total)[A][B][4],
                                      float (&part)[A][B][S][4]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = part[a][b][0][i];
        part[a][b][0][i] = 0.f;
#pragma unroll
        for (int k = 1; k < S; ++k) {
          v += part[a][b][k][i];
          part[a][b][k][i] = 0.f;
        }
        total[a][b][i] += v;
      }
}

// Allow `bytes` of dynamic shared memory for `kern`, once per kernel (the
// port runs on one device).
template <class K>
cudaError_t allow_smem(K* kern, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

// d += a * b: m16n8k8, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32, the small terms first; with S = 3 accumulators
// each product has its own.
template <int S>
__device__ __forceinline__ void mma_3xtf32(float (&d)[S][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d[0], al, bh[0], bh[1]);
  mma_tf32(d[1 % S], ah, bl[0], bl[1]);
  mma_tf32(d[2 % S], ah, bh[0], bh[1]);
}

// Two bf16 as one 32-bit fragment word, lo in bits 0-15.
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The operands of the float32 convs. A fragments are read from a staged
// tile of channel planes (plane stride PS elements) at `base`, the tile's
// (row 0, channel 0) for the warp's m16 tile; B fragments from a weight
// chunk's row-of-words layout at `wp`, the lane's (row t, column g).
// S: the accumulators of a short MMA chain (one per product of a step).
template <class T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int CK = kCiChunk;
  static constexpr int S = 3;
  struct A { uint32_t h[4], l[4]; };
  struct B { uint32_t h[2], l[2]; };
  // row g / g + 8 = position (PSTR columns apart), column t / t + 4 =
  // channel, split hi + lo
  template <int PSTR = 1>
  static __device__ __forceinline__ A load_a(const float* base, int PS,
                                             int g, int t) {
    const float* ap = base + t * PS + g * PSTR;
    A a;
    split_tf32(ap[0], a.h[0], a.l[0]);
    split_tf32(ap[8 * PSTR], a.h[1], a.l[1]);
    split_tf32(ap[4 * PS], a.h[2], a.l[2]);
    split_tf32(ap[4 * PS + 8 * PSTR], a.h[3], a.l[3]);
    return a;
  }
  // b0: row t, b1: row t + 4, split hi + lo
  static __device__ __forceinline__ B load_b(const float* wp, int NPS) {
    B b;
    split_tf32(wp[0], b.h[0], b.l[0]);
    split_tf32(wp[4 * NPS], b.h[1], b.l[1]);
    return b;
  }
  template <int SS>
  static __device__ __forceinline__ void mma(float (&d)[SS][4], const A& a,
                                             const B& b) {
    mma_3xtf32<SS>(d, a.h, a.l, b.h, b.l);
  }
};

// An element's value as float, and a float rounded to the element type
// (round to nearest even, as torch's and JAX's casts round).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: the rounding of an intermediate that the JAX
// bf16 path stores in bf16 (identity for float)
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Asynchronous copies global -> shared; the bytes past `bytes` (all of
// them when 0, and src is then not read) are written as zeros.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
// Four consecutive elements (16 bytes of float, 8 of bf16), `n` of them
// copied (0..4), the rest zero.
__device__ __forceinline__ void cp_async_vec(float* dst, const float* src,
                                             int n) {
  cp_async16(dst, src, 4 * n);
}
__device__ __forceinline__ void cp_async_vec(bf16* dst, const bf16* src,
                                             int n) {
  cp_async8(dst, src, 2 * n);
}
// One element, or zero when !valid (src is then not read): float by
// cp.async; bf16 by a plain load and store (cp.async copies 4 bytes at
// least), visible after the barrier that follows a stage's loads.
__device__ __forceinline__ void stage_one(float* dst, const float* src,
                                          bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void stage_one(bf16* dst, const bf16* src,
                                          bool valid) {
  *dst = valid ? src[0] : __ushort_as_bfloat16((unsigned short)0);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The weights laid out once per call for the blocks' 16-byte copies:
// wt[group][chunk][tap][row 8][NW] 32-bit words (group = co / NW, chunk =
// ci / 8; a row is channel chunk * 8 + row), zero past Co and Ci, from w
// [Co, Ci, KK]. A bf16 w's word holds channels ci and ci + 1 (the bf16
// convs' own layouts: conv3d_bf16.cu, conv2d_bf16.cu).
__device__ __forceinline__ uint32_t weight_word(const float* w, int co,
                                                int ci, int Ci, int Co,
                                                int KK, int tap) {
  return __float_as_uint(
      co < Co && ci < Ci ? w[((long long)co * Ci + ci) * KK + tap] : 0.f);
}
__device__ __forceinline__ uint32_t weight_word(const bf16* w, int co,
                                                int ci, int Ci, int Co,
                                                int KK, int tap) {
  const bf16 z = __ushort_as_bfloat16((unsigned short)0);
  const long long o = ((long long)co * Ci + ci) * KK + tap;
  return pack_bf16(co < Co && ci < Ci ? w[o] : z,
                   co < Co && ci + 1 < Ci ? w[o + KK] : z);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
prep_weights(const T* __restrict__ w, uint32_t* __restrict__ wt, int Ci,
             int Co, int KK, int NW, int nch, long long total) {
  constexpr int per_row = Elem<T>::CK / kCiChunk;   // channels a row
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long r = i / NW;
  const int col = (int)(i - r * NW);
  const int c = (int)(r % kCiChunk);
  r /= kCiChunk;
  const int tap = (int)(r % KK);
  r /= KK;
  const int ch = (int)(r % nch), grp = (int)(r / nch);
  const int co = grp * NW + col, ci = ch * Elem<T>::CK + per_row * c;
  wt[i] = weight_word(w, co, ci, Ci, Co, KK, tap);
}

// Launch prep_weights for all of w into the caller's scratch wt
// (ceil(Co / NW) * ceil(Ci / CK) * KK * 8 * NW words).
template <class T>
inline cudaError_t prep(const T* w, void* wt, int Ci, int Co, int KK, int NW,
                        cudaStream_t stream) {
  const int groups = (Co + NW - 1) / NW;
  const int nch = (Ci + Elem<T>::CK - 1) / Elem<T>::CK;
  const long long n = (long long)groups * nch * KK * kCiChunk * NW;
  prep_weights<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(w, static_cast<uint32_t*>(wt), Ci, Co, KK, NW,
                              nch, n);
  return cudaGetLastError();
}

// One chunk of one group's prepared weights (KK * 8 rows of NW words)
// into s[tap][row][co] with row stride NPS, 16 bytes per copy.
template <int KK, int NW, int NPS>
__device__ __forceinline__ void load_weights(float* s, const void* wt_) {
  const float* wt = static_cast<const float*>(wt_);
  constexpr int nv = NW / 4, total = KK * kCiChunk * nv;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int v = e % nv, r = e / nv;
    cp_async16(s + r * NPS + 4 * v, wt + r * NW + 4 * v, 16);
  }
}

// Stage channels [c0, c0 + CK) of the halo brick of sample n into s
// (plane stride PS, row stride XS, in elements): zero outside the volume
// and for channels >= C. vec (Halo::VEC rows, rows of the volume aligned
// for whole vectors): whole rows of four-element vectors; else one
// element per thread and step, x fastest. CK = Elem<T>::CK channels.
template <int MODE, int BZ, int BY, int PS, class T>
__device__ __forceinline__ void load_halo(T* s, const T* x, int n, int c0,
                                          int C, int Di, int Hi, int Wi,
                                          int bz0, int by0, int bx0,
                                          bool vec) {
  using Hl = Halo<MODE, BZ, BY, T>;
  constexpr int CK = Elem<T>::CK;
  const int iz0 = Hl::origin(bz0), iy0 = Hl::origin(by0);
  if (Hl::VEC && vec) {
    const int gx0 = Hl::row_origin(bx0);
    constexpr int total = CK * Hl::EZ * Hl::EY * Hl::NV;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int v = e % Hl::NV;
      int r = e / Hl::NV;
      const int ry = r % Hl::EY;
      r /= Hl::EY;
      const int rz = r % Hl::EZ;
      const int c = r / Hl::EZ;
      const int gz = iz0 + rz, gy = iy0 + ry, gx = gx0 + 4 * v;
      const int nx = (c0 + c < C && gz >= 0 && gz < Di && gy >= 0 &&
                      gy < Hi && gx >= 0)
                         ? min(4, max(0, Wi - gx))
                         : 0;
      const T* src =
          nx ? x + ((((long long)n * C + c0 + c) * Di + gz) * Hi + gy) * Wi +
                   gx
             : x;
      cp_async_vec(s + c * PS + (rz * Hl::EY + ry) * Hl::XS + 4 * v, src,
                   nx);
    }
    return;
  }
  const int ix0 = Hl::origin(bx0);
  constexpr int total = CK * Hl::EZ * Hl::EY * Hl::EX;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int rx = e % Hl::EX;
    int r = e / Hl::EX;
    const int ry = r % Hl::EY;
    r /= Hl::EY;
    const int rz = r % Hl::EZ;
    const int c = r / Hl::EZ;
    const int gz = iz0 + rz, gy = iy0 + ry, gx = ix0 + rx;
    const bool ok = c0 + c < C && gz >= 0 && gz < Di && gy >= 0 && gy < Hi &&
                    gx >= 0 && gx < Wi;
    const T* src =
        ok ? x + ((((long long)n * C + c0 + c) * Di + gz) * Hi + gy) * Wi + gx
           : x;
    stage_one(s + c * PS + (rz * Hl::EY + ry) * Hl::XS + Hl::xcol(rx), src,
              ok);
  }
}

}  // namespace tc
