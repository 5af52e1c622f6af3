// Shared pieces of the bf16 convolutions on Hopper's tensor cores: K2-bf16
// (conv3d_bf16.cu), K8's bf16 weight gradient (conv3d_dw_bf16.cu) and
// K5-bf16 (conv2d_bf16.cu). The float32 kernels do not include this file.
//
// Products: mma.sync.aligned.m16n8k16 (K2's 8-channel chunks: m16n8k8),
// bf16 operands, float32 accumulators; a bf16 x bf16 product is exact in
// float32.
//
// Fragment words as 64-bit shared loads. In an m16n8k16 product lane
// (g, t) holds, of A, k = 2t, 2t + 1 (a0: row g, a1: row g + 8) and
// k = 2t + 8, 2t + 9 (a2, a3), and of B the same k for column g (b0, b1).
// The sum over k does not care which element of the K dimension a k
// names, as long as A and B agree, so both kernels name them so that a
// lane's four k are four consecutive elements of the staged K axis:
//   k = 2t + j  ->  element 4t + j,   k = 2t + 8 + j  ->  element 4t + 2 + j
// (j = 0, 1). Then one 8-byte load at element 4t of a row gives the
// row's a0 (low word) and a2 (high word), and one at element 4t of a B
// column gives b0 and b1: two loads an A fragment, one a B fragment.
// K2 and K5 stage x channels-last (K = the 16 channels of a chunk, 32
// bytes a position), K8 dw stages x and g along positions (K = 16
// positions of one brick row).
//
// Staging: rows of x and g are read from device memory as whole 16-byte
// vectors of 8 elements where the row allows (W % 8 == 0 and the base
// aligned), else one element at a time, zero outside the volume (K2:
// straight into registers; dw: x as TMA boxes and g by cp.async into a
// ring, then registers); the
// re-layout (channel transposes, the x shifts of the taps, the parity
// split of a stride-2 row) is done in registers with byte permutes, and
// the result stored to shared memory as 16-byte vectors.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_conv3d.cuh"

namespace tcb {

using tc::bf16;
using tc::kBX;
using tc::kThreads;
using tc::kWarps;

// 8 bytes of shared memory: two fragment words
__device__ __forceinline__ uint2 lds64(const uint32_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// d = a * b from zero accumulators: the tensor cores sum one k16 step's
// 16 exact products; the caller adds d into a float32 total with
// round-to-nearest (the short chain of tc_conv3d.cuh's accumulation note,
// of length one).
__device__ __forceinline__ void mma_zero(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f),
        "f"(0.f), "f"(0.f), "f"(0.f));
}

// d += a * b
__device__ __forceinline__ void mma_acc(float (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a * b, m16n8k8 (a0: row g, a1: row g + 8, k = 2t, 2t + 1; b0: k =
// 2t, 2t + 1 of column g): the k8 product of an 8-channel chunk
__device__ __forceinline__ void mma_acc_k8(float (&d)[4], uint32_t a0,
                                           uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Elements [x0, x0 + 8 NV) of a row of bf16 (x0 a multiple of 8) as 4 NV
// words (element 2i in the low half of word i), zero outside [0, W) and
// everywhere when !ok (row is then not read). vec: the row is 16-byte
// aligned and W % 8 == 0, so a vector lies wholly inside or outside.
template <int NV>
__device__ __forceinline__ void load_span(uint32_t (&w)[4 * NV],
                                          const bf16* row, int x0, int W,
                                          bool ok, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int x = x0 + 8 * i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ok && x >= 0 && x < W)
        v = __ldg(reinterpret_cast<const uint4*>(row + x));
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
    return;
  }
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
  for (int i = 0; i < 4 * NV; ++i) {
    const int x = x0 + 2 * i;
    const uint32_t lo = ok && x >= 0 && x < W ? r[x] : 0u;
    const uint32_t hi = ok && x + 1 >= 0 && x + 1 < W ? r[x + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
}

// The word of span elements e (low half) and e + s (high half), s = 1
// or 2; e and s are constants after unrolling, so w stays in registers.
template <int N>
__device__ __forceinline__ uint32_t pair_word(const uint32_t (&w)[N], int e,
                                              int s) {
  if (s == 1)
    return (e & 1) ? __byte_perm(w[e >> 1], w[(e >> 1) + 1], 0x5432)
                   : w[e >> 1];
  return __byte_perm(w[e >> 1], w[(e >> 1) + 1], (e & 1) ? 0x7632 : 0x5410);
}

// 16-byte store of four words to shared memory
__device__ __forceinline__ void sts128(uint32_t* p, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// The fragments of one chunk width (CK channels, CK / 2 words a staged
// position), as lane (g, t) loads them: A of an m16 tile whose row g is
// staged position pos (row g + 8 eight positions on), B of column `row` of
// a weight layout of CK / 2 words a column, and the product.
template <int CK>
struct Frag;

template <>
struct Frag<16> {
  struct A { uint32_t v[4]; };
  using B = uint2;
  static __device__ __forceinline__ A load_a(const uint32_t* sx, int pos,
                                             int t) {
    const uint2 lo = lds64(sx + pos * 8 + 2 * t);
    const uint2 hi = lds64(sx + (pos + 8) * 8 + 2 * t);
    return A{{lo.x, hi.x, lo.y, hi.y}};
  }
  static __device__ __forceinline__ B load_b(const uint32_t* sw, int row,
                                             int t) {
    return lds64(sw + row * 8 + 2 * t);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_acc(d, a.v[0], a.v[1], a.v[2], a.v[3], b.x, b.y);
  }
};

template <>
struct Frag<8> {
  struct A { uint32_t v[2]; };
  using B = uint32_t;
  static __device__ __forceinline__ A load_a(const uint32_t* sx, int pos,
                                             int t) {
    return A{{sx[pos * 4 + t], sx[(pos + 8) * 4 + t]}};
  }
  static __device__ __forceinline__ B load_b(const uint32_t* sw, int row,
                                             int t) {
    return sw[row * 4 + t];
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_acc_k8(d, a.v[0], a.v[1], b);
  }
};

template <int MT, int NTB>
__device__ __forceinline__ void flush(float (&acc)[MT][NTB][4],
                                      float (&part)[MT][NTB][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] += part[mt][nt][i];
        part[mt][nt][i] = 0.f;
      }
}

// `words` words of prepared weights (a multiple of 4) into s, by 16-byte
// cp.async
__device__ __forceinline__ void stage_w(uint32_t* s, const uint32_t* wt,
                                        int words) {
  for (int e = threadIdx.x; e < words / 4; e += kThreads)
    tc::cp_async16(reinterpret_cast<float*>(s + 4 * e),
                   reinterpret_cast<const float*>(wt + 4 * e), 16);
}

}  // namespace tcb
