// 2D convolution of the FeatureNet FPN in bf16 (K5-bf16, the bf16 eval
// path), designed for Hopper on its own; conv2d.cu keeps the float32
// kernels.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_conv2d.py conv2d_cm
// (:306, pallas_call :394) on a bf16 input, as
// nn/featurenet_fast.featurenet_packed chains it, and what that chain
// leaves to XLA (the 1x1 FPN heads, the nearest x2 upsample-add and
// stage 3's head, whose lateral sum is never written), as conv2d.cu does
// for float32 (its header states the function, the epilogue and the
// layouts; ops/conv2d.py picks the route and the tile). The arithmetic:
// bf16 products, exact in float32; float32 accumulation, the tensor cores'
// sums flushed into float32 totals after each short chain (3 k-steps a
// tap column at stride 1, 5 a tap row at stride 2; ROADMAP section 3);
// the epilogue (scale, shift, ReLU) in float32 and the output rounded once;
// with up, the conv's result rounded before the add and the sum again.
//
// What held the template instance back (conv2d.cu's float32 design on
// bf16, 3.69 ms a DTU map against 0.365 ms of bytes; PERF.md): the input
// tile staged as channel planes, so every A fragment took eight 2-byte
// shared loads and four packs; 16-channel chunks half zeros at Ci = 8
// (conv0.1, conv1.0); the lateral head's sum formed one 2-byte store a
// channel plane from scattered 2-byte loads of up; outputs stored 2 or 4
// bytes at a time from the fragments. What this design does about it,
// on K2-bf16's rules (tc_bf16.cuh, conv3d_bf16.cu):
//   * the tile is staged CHANNELS-LAST, CK channels (2 CK bytes) a
//     position, transposed from the NCHW planes in registers with byte
//     permutes and stored as 16-byte vectors; an A fragment is two 8-byte
//     shared loads (tc_bf16.cuh's k-permutation: a lane's four k are four
//     consecutive channels), a B fragment one;
//   * rows are staged whole 8-input groups at a time (16-byte loads where
//     the rows allow), the staging items ordered half, row, group, and the
//     row stride padded to 4 HF words (mod 32), so that the 16-byte stores
//     of a quarter warp fall on distinct banks; stride-2 rows are stored
//     as their even then odd inputs, so the 16 outputs of a tile read 16
//     consecutive positions (distinct banks);
//   * Ci <= 8 runs 8-channel chunks on m16n8k8 (conv0.1, conv1.0);
//   * the lateral head stages lat (8 channels) and the half-resolution up
//     (all Cu channels) channels-last once, then each thread forms, for a
//     fixed 8 of the sum's channels whose 1x1 weights it keeps in
//     registers, each halo position's sum (inner2's product in channel
//     order, + b, rounded, + up, rounded) and stores it as a 16-byte
//     vector into the chunk tiles the MMAs read; the sum is never written
//     to device memory;
//   * the epilogue stages a tile's float32 results in shared memory and
//     writes 16-byte vectors: 8 consecutive x of a channel row in NCHW, 8
//     channels of a pixel in K1's [N, H, W, C] layout;
//   * the direct route (conv0.0 with Ci = 3, the 1x1 heads out1 and
//     inner1+up) gives a thread 8 consecutive output x: 16-byte input
//     loads where rows are whole 8-element groups, 16-byte output stores.
// tests/test_torch_conv2d_tc.py emulates the staging, the fragment maps
// and the lateral head at this addressing on the CPU.
//
// Layouts: x, up, lat [N, C, H, W]; w [Co, Ci, K, K], wi [Cu, Cl] bf16;
// scale, shift, bi float32 (null: 1, 0); out NCHW or [N, H, W, Co].
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_bf16.cuh"

namespace {

using namespace tcb;

// ------------------------------------------------------------ helpers

// Element e of a span of words (element 2i in the low half of word i),
// widened exactly; e is a constant after unrolling.
template <int M>
__device__ __forceinline__ float span_elem(const uint32_t (&w)[M], int e) {
  return __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u)
                                 : (w[e >> 1] << 16));
}

__device__ __forceinline__ float bf16_rn(float v) {
  return tc::to_f32(tc::from_f32<bf16>(v));
}

// The epilogue of one output value before any up-add: r * scale + shift,
// ReLU.
__device__ __forceinline__ float scale_shift(float r, const float* scale,
                                             const float* shift, int relu,
                                             int co) {
  if (scale != nullptr) r *= scale[co];
  if (shift != nullptr) r += shift[co];
  if (relu) r = fmaxf(r, 0.f);
  return r;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Allow kern `bytes` of dynamic shared memory; each instance keeps the
// largest size it was allowed (`allowed`), so a call sets it only when it
// needs more.
template <class Kern>
cudaError_t allow(Kern* kern, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// ------------------------------------------------------------ direct route

// A thread: 8 consecutive output x of row (n, oy) and CO_T output
// channels. The input span a tap row reads, elements [ox0 S - pad - OFF,
// ...), is loaded as whole 8-element groups (vec: pad == K / 2, rows of x
// whole groups and 16-byte aligned) or element by element; OFF puts the
// span's first group on a multiple of 8 in the vec case, so every element
// index below is a constant.
template <int K, int S, int CO_T, bool NHWC>
__global__ void __launch_bounds__(128)
conv2d_bf16_direct(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const bf16* __restrict__ up, bf16* __restrict__ out,
                   int N, int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
                   int pad, int relu, int vec, int vec_out, int vec_up) {
  constexpr int OFF = (8 - K / 2) % 8;
  constexpr int NG = (OFF + 8 * S + K - 1 + 7) / 8;   // groups a span
  extern __shared__ float s_w[];                      // [Ci][K*K][CO_T]
  const int co0 = blockIdx.y * CO_T;
  for (int i = threadIdx.x; i < Ci * K * K * CO_T; i += blockDim.x) {
    const int j = i % CO_T;
    const int k = (i / CO_T) % (K * K);
    const int c = i / (CO_T * K * K);
    s_w[i] = tc::to_f32(w[((long long)(co0 + j) * Ci + c) * K * K + k]);
  }
  __syncthreads();

  const int nxg = (Wo + 7) / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)N * Ho * nxg) return;
  const int xg = (int)(idx % nxg);
  const long long r = idx / nxg;
  const int oy = (int)(r % Ho), n = (int)(r / Ho);
  const int ox0 = 8 * xg;
  const int xb = ox0 * S - pad - OFF;                 // the span's element 0

  float acc[8][CO_T];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int o = 0; o < CO_T; ++o) acc[j][o] = 0.f;

  const long long plane = (long long)Hi * Wi;
  for (int c = 0; c < Ci; ++c) {
    const bf16* xc = x + ((long long)n * Ci + c) * plane;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const int yi = oy * S - pad + ky;
      if (yi < 0 || yi >= Hi) continue;
      uint32_t sp[4 * NG];
      load_span<NG>(sp, xc + (long long)yi * Wi, xb, Wi, true, vec);
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const float4* wk = reinterpret_cast<const float4*>(
            s_w + (c * K * K + ky * K + kx) * CO_T);
        float wv[CO_T];
        if constexpr (CO_T % 4 == 0) {
#pragma unroll
          for (int o = 0; o < CO_T; o += 4) {
            const float4 q = wk[o / 4];
            wv[o] = q.x;
            wv[o + 1] = q.y;
            wv[o + 2] = q.z;
            wv[o + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int o = 0; o < CO_T; ++o)
            wv[o] = s_w[(c * K * K + ky * K + kx) * CO_T + o];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = span_elem(sp, OFF + j * S + kx);
#pragma unroll
          for (int o = 0; o < CO_T; ++o) acc[j][o] = fmaf(v, wv[o], acc[j][o]);
        }
      }
    }
  }

  const int Hu = Ho / 2, Wu = Wo / 2;
#pragma unroll
  for (int o = 0; o < CO_T; ++o)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][o] = scale_shift(acc[j][o], scale, shift, relu, co0 + o);
  if (up != nullptr) {
#pragma unroll
    for (int o = 0; o < CO_T; ++o) {
      const bf16* ur = up + (((long long)n * Co + co0 + o) * Hu + oy / 2) * Wu;
      uint32_t u[2];
      // output x ox0 + j reads up x ox0 / 2 + j / 2: 4 elements
      if (vec_up) {
        const uint2 q = *reinterpret_cast<const uint2*>(ur + ox0 / 2);
        u[0] = q.x;
        u[1] = q.y;
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int xa = ox0 / 2 + 2 * i;
          const unsigned short* ru =
              reinterpret_cast<const unsigned short*>(ur);
          const uint32_t lo = xa < Wu ? ru[xa] : 0u;
          const uint32_t hi = xa + 1 < Wu ? ru[xa + 1] : 0u;
          u[i] = lo | (hi << 16);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j][o] = bf16_rn(acc[j][o]) + span_elem(u, j / 2);
    }
  }

  if constexpr (!NHWC) {
#pragma unroll
    for (int o = 0; o < CO_T; ++o) {
      bf16* orow = out + (((long long)n * Co + co0 + o) * Ho + oy) * Wo;
      if (vec_out && ox0 + 8 <= Wo) {
        *reinterpret_cast<uint4*>(orow + ox0) = make_uint4(
            tc::pack_bf16(tc::from_f32<bf16>(acc[0][o]),
                          tc::from_f32<bf16>(acc[1][o])),
            tc::pack_bf16(tc::from_f32<bf16>(acc[2][o]),
                          tc::from_f32<bf16>(acc[3][o])),
            tc::pack_bf16(tc::from_f32<bf16>(acc[4][o]),
                          tc::from_f32<bf16>(acc[5][o])),
            tc::pack_bf16(tc::from_f32<bf16>(acc[6][o]),
                          tc::from_f32<bf16>(acc[7][o])));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ox0 + j < Wo) orow[ox0 + j] = tc::from_f32<bf16>(acc[j][o]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (ox0 + j >= Wo) break;
      bf16* o = out + (((long long)n * Ho + oy) * Wo + ox0 + j) * Co + co0;
      if constexpr (CO_T % 8 == 0) {
        if (vec_out) {
#pragma unroll
          for (int c = 0; c < CO_T; c += 8)
            *reinterpret_cast<uint4*>(o + c) = make_uint4(
                tc::pack_bf16(tc::from_f32<bf16>(acc[j][c]),
                              tc::from_f32<bf16>(acc[j][c + 1])),
                tc::pack_bf16(tc::from_f32<bf16>(acc[j][c + 2]),
                              tc::from_f32<bf16>(acc[j][c + 3])),
                tc::pack_bf16(tc::from_f32<bf16>(acc[j][c + 4]),
                              tc::from_f32<bf16>(acc[j][c + 5])),
                tc::pack_bf16(tc::from_f32<bf16>(acc[j][c + 6]),
                              tc::from_f32<bf16>(acc[j][c + 7])));
          continue;
        }
      }
#pragma unroll
      for (int c = 0; c < CO_T; ++c) o[c] = tc::from_f32<bf16>(acc[j][c]);
    }
  }
}

template <int K, int S, int CO_T, bool NHWC>
cudaError_t launch_direct(const bf16* x, const bf16* w, const float* scale,
                          const float* shift, const bf16* up, bf16* out,
                          int N, int Ci, int Hi, int Wi, int Co, int Ho,
                          int Wo, int pad, int relu, cudaStream_t s) {
  auto kern = conv2d_bf16_direct<K, S, CO_T, NHWC>;
  const size_t smem = sizeof(float) * Ci * K * K * CO_T;
  static size_t allowed = 48 * 1024;       // the default
  const cudaError_t e = allow(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const int vec = pad == K / 2 && Wi % 8 == 0 && aligned(x, 16);
  // NCHW: rows of whole 8-element vectors; NHWC: pixels of whole
  // 8-channel vectors; up: rows of whole 4-element (8-byte) runs
  const int vec_out = NHWC ? Co % 8 == 0 && aligned(out, 16)
                           : Wo % 8 == 0 && aligned(out, 16);
  const int vec_up = Wo % 8 == 0 && aligned(up, 8);
  const long long items = (long long)N * Ho * ((Wo + 7) / 8);
  dim3 grid((unsigned)((items + 127) / 128), Co / CO_T);
  kern<<<grid, 128, smem, s>>>(x, w, scale, shift, up, out, N, Ci, Hi, Wi,
                               Co, Ho, Wo, pad, relu, vec, vec_out, vec_up);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t direct_ks(const bf16* x, const bf16* w, const float* scale,
                      const float* shift, const bf16* up, bf16* out, int N,
                      int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
                      int pad, int relu, int nhwc, cudaStream_t s) {
#define DIRECT(CO_T, L)                                                    \
  return launch_direct<K, S, CO_T, L>(x, w, scale, shift, up, out, N, Ci, \
                                      Hi, Wi, Co, Ho, Wo, pad, relu, s)
  if (Co % 8 == 0) {
    if (nhwc) DIRECT(8, true);
    DIRECT(8, false);
  }
  if (nhwc) DIRECT(1, true);
  DIRECT(1, false);
#undef DIRECT
}

cudaError_t direct(const bf16* x, const bf16* w, const float* scale,
                   const float* shift, const bf16* up, bf16* out, int N,
                   int Ci, int Hi, int Wi, int Co, int Ho, int Wo, int K,
                   int stride, int pad, int relu, int nhwc, cudaStream_t s) {
#define KS(KK, SS)                                                         \
  if (K == KK && stride == SS)                                             \
    return direct_ks<KK, SS>(x, w, scale, shift, up, out, N, Ci, Hi, Wi, Co, \
                             Ho, Wo, pad, relu, nhwc, s);
  KS(1, 1) KS(3, 1) KS(5, 1) KS(1, 2) KS(3, 2) KS(5, 2)
#undef KS
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ tensor cores

// The tile of a block (conv2d.cu's Tile): 8 warps as WY rows x WX columns
// (stride 1: 2 x 4; stride 2: 8 x 1); warp (wy, wx) owns output rows by0 +
// wy MT + [0, MT) and columns bx0 + 16 wx + [0, 16). The halo, EY rows x
// EX inputs from (S by0 - K/2, S bx0 - K/2), is staged channels-last:
// CK channels (PW words) a position, RS words a row; at stride 2 a row
// holds its XH even inputs, then its odd ones. Staging reads each row as
// NG groups of 8 inputs from (S bx0 - 8).
template <int K, int S, int MT, int NTB, int CK>
struct Cfg {
  static constexpr int WX = S == 1 ? 4 : 1, WY = kWarps / WX;
  static constexpr int BY = WY * MT, BX = 16 * WX, PAD = K / 2;
  static constexpr int EY = S * (BY - 1) + K, EX = S * (BX - 1) + K;
  static constexpr int XH = S == 1 ? 0 : (EX + 1) / 2;
  static constexpr int NG = (S * BX) / 8 + 2;
  static constexpr int PW = CK / 2, HF = CK / 8;
  static constexpr int RS = tc::pad_to(EX * PW, 4 * HF);
  static constexpr int RP = RS / PW;                // positions a row
  static constexpr int X_WORDS = EY * RS;
  static constexpr int NW = 8 * NTB;               // channels a block
  static constexpr int W_WORDS = K * K * NW * PW;
  static constexpr int STAGE = X_WORDS + W_WORDS;
  // the epilogue tile ep[co][y][x] in floats; a co's rows are 4 (mod 32)
  // words apart, so a fragment's stores fall on distinct banks
  static constexpr int CS = BY * BX + 4;
  static constexpr int EP = NW * CS;
  static_assert(PAD <= 8 && K - 1 - PAD - S < 8, "halo in NG groups");
  static_assert(EX * PW <= RS && RS % PW == 0, "rows of whole positions");
};

// Stored column of halo input h (0 <= h < EX) of a row.
template <int S, int XH>
__device__ __forceinline__ int halo_col(int h) {
  return S == 1 ? h : (h & 1) ? XH + (h >> 1) : (h >> 1);
}

// Stage channels [c0, c0 + 8 HF) of rows [y0, y0 + NR) of the C-channel
// NCHW map src (sample n, H x W) channels-last into s (RS words a row, PW
// a position): item (half, row, group) reads 8 channels x 8 inputs from
// x = xg0 + 8 group and writes the half (16 bytes) of each input that
// maps to a stored column (col(rel), rel = 8 group + p; -1: not stored);
// zero outside the map and past C.
template <int NR, int NGR, int HF, int RS, int PW, class ColOf>
__device__ __forceinline__ void stage_cl(uint32_t* s, const bf16* src,
                                         int n, int c0, int C, int H, int W,
                                         int y0, int xg0, bool vec,
                                         ColOf col_of) {
  const long long plane = (long long)H * W;
  for (int e = threadIdx.x; e < HF * NR * NGR; e += kThreads) {
    const int hf = e % HF, row = (e / HF) % NR, gi = e / (HF * NR);
    const int gy = y0 + row, cb = c0 + 8 * hf;
    const bool okr = gy >= 0 && gy < H && cb < C;
    const bf16* base =
        okr ? src + ((long long)n * C + cb) * plane + (long long)gy * W : src;
    uint32_t v[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      load_span<1>(v[c], base + c * plane, xg0 + 8 * gi, W,
                   okr && cb + c < C, vec);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int col = col_of(8 * gi + p);
      if (col < 0) continue;
      const int sel = (p & 1) ? 0x7632 : 0x5410;
      sts128(s + row * RS + col * PW + 4 * hf,
             __byte_perm(v[0][p >> 1], v[1][p >> 1], sel),
             __byte_perm(v[2][p >> 1], v[3][p >> 1], sel),
             __byte_perm(v[4][p >> 1], v[5][p >> 1], sel),
             __byte_perm(v[6][p >> 1], v[7][p >> 1], sel));
    }
  }
}

// The halo tile of a conv block (Cfg's geometry).
template <int K, int S, int MT, int NTB, int CK>
__device__ __forceinline__ void stage_x(uint32_t* s, const bf16* x, int n,
                                        int c0, int Ci, int Hi, int Wi,
                                        int by0, int bx0, bool vec) {
  using C = Cfg<K, S, MT, NTB, CK>;
  stage_cl<C::EY, C::NG, C::HF, C::RS, C::PW>(
      s, x, n, c0, Ci, Hi, Wi, S * by0 - C::PAD, S * bx0 - 8, vec,
      [](int rel) {
        const int h = rel - (8 - C::PAD);
        return h >= 0 && h < C::EX ? halo_col<S, C::XH>(h) : -1;
      });
}

// The K x K taps of one staged chunk: acc[mt][nt] += window(tap) x w[tap].
// Stride 1: per tap column kx, the K B fragments stay in registers and the
// warp walks its MT + K - 1 halo rows; each row's A fragment is loaded
// once and feeds every (output row mt, tap row ky) with mt + ky = that
// row; the chain is flushed after each tap column. Stride 2: per tap, the
// MT rows' fragments; flushed after each tap row.
template <int K, int S, int MT, int NTB, int CK>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][NTB][4],
                                          float (&part)[MT][NTB][4],
                                          const uint32_t* sx,
                                          const uint32_t* sw, int wy, int wx,
                                          int g, int t) {
  using C = Cfg<K, S, MT, NTB, CK>;
  using F = Frag<CK>;
  if constexpr (S == 1) {
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
      typename F::B b[K][NTB];
#pragma unroll
      for (int ky = 0; ky < K; ++ky)
#pragma unroll
        for (int nt = 0; nt < NTB; ++nt)
          b[ky][nt] = F::load_b(sw, (ky * K + kx) * C::NW + nt * 8 + g, t);
#pragma unroll
      for (int z = 0; z < MT + K - 1; ++z) {
        const typename F::A a =
            F::load_a(sx, (wy * MT + z) * C::RP + 16 * wx + kx + g, t);
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const int mt = z - ky;
          if (mt >= 0 && mt < MT) {
#pragma unroll
            for (int nt = 0; nt < NTB; ++nt) F::mma(part[mt][nt], a, b[ky][nt]);
          }
        }
      }
      flush(acc, part);
    }
  } else {
#pragma unroll 1
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        typename F::B b[NTB];
#pragma unroll
        for (int nt = 0; nt < NTB; ++nt)
          b[nt] = F::load_b(sw, (ky * K + kx) * C::NW + nt * 8 + g, t);
        // output x j reads halo input S j + kx (wx = 0 at stride 2)
        const int col = halo_col<S, C::XH>(kx);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const typename F::A a =
              F::load_a(sx, (S * (wy * MT + mt) + ky) * C::RP + col + g, t);
#pragma unroll
          for (int nt = 0; nt < NTB; ++nt) F::mma(part[mt][nt], a, b[nt]);
        }
      }
      flush(acc, part);
    }
  }
}

// The epilogue of a block: acc (C fragments: row g / g + 8 = x, col 2t /
// 2t + 1 = co of warp (wy, wx)'s tiles) scaled, shifted and ReLU'd into
// ep[co][y][x] (float32, stride CS a co); then 16-byte vectors out: NCHW
// 8 consecutive x of a channel row (+ up: the result rounded, + up, rounded
// again), [N, H, W, Co] the 8 channels of a pixel. vec_out: NCHW rows of
// whole vectors (Wo % 8 == 0, out 16-byte and up 8-byte aligned), or
// pixels of whole vectors (Co % 8 == 0, out 16-byte aligned).
template <int MT, int NTB, int BY, int BX, int CS>
__device__ __forceinline__ void epilogue(
    const float (&acc)[MT][NTB][4], float* ep,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const bf16* __restrict__ up, bf16* __restrict__ out, int n, int by0,
    int bx0, int co0, int Co, int Ho, int Wo, int relu, int nhwc,
    int vec_out, int wy, int wx, int g, int t) {
  constexpr int NW = 8 * NTB;
  __syncthreads();                  // the last MMAs are done with smem
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int co = nt * 8 + 2 * t + (i & 1);
        const int cc = min(co0 + co, Co - 1);
        ep[co * CS + (wy * MT + mt) * BX + 16 * wx + g + ((i & 2) ? 8 : 0)] =
            scale_shift(acc[mt][nt][i], scale, shift, relu, cc);
      }
  __syncthreads();
  const int Hu = Ho / 2, Wu = Wo / 2;
  if (!nhwc) {
    constexpr int RV = BX / 8;                      // vectors a row
    for (int e = threadIdx.x; e < NW * BY * RV; e += kThreads) {
      const int v = e % RV, y = (e / RV) % BY, co = e / (RV * BY);
      const int cg = co0 + co, oy = by0 + y, ox0 = bx0 + 8 * v;
      if (cg >= Co || oy >= Ho || ox0 >= Wo) continue;
      const float4* src =
          reinterpret_cast<const float4*>(ep + co * CS + y * BX + 8 * v);
      const float4 a = src[0], b = src[1];
      float val[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      if (up != nullptr) {
        const bf16* ur = up + (((long long)n * Co + cg) * Hu + oy / 2) * Wu;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (vec_out || ox0 + k < Wo)
            val[k] = bf16_rn(val[k]) + tc::to_f32(ur[(ox0 + k) / 2]);
      }
      bf16* o = out + (((long long)n * Co + cg) * Ho + oy) * Wo + ox0;
      if (vec_out) {
        *reinterpret_cast<uint4*>(o) = make_uint4(
            tc::pack_bf16(tc::from_f32<bf16>(val[0]),
                          tc::from_f32<bf16>(val[1])),
            tc::pack_bf16(tc::from_f32<bf16>(val[2]),
                          tc::from_f32<bf16>(val[3])),
            tc::pack_bf16(tc::from_f32<bf16>(val[4]),
                          tc::from_f32<bf16>(val[5])),
            tc::pack_bf16(tc::from_f32<bf16>(val[6]),
                          tc::from_f32<bf16>(val[7])));
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (ox0 + k < Wo) o[k] = tc::from_f32<bf16>(val[k]);
      }
    }
  } else {
    constexpr int CV = NW / 8;                      // vectors a pixel
    for (int e = threadIdx.x; e < BY * BX * CV; e += kThreads) {
      const int cv = e % CV, x = (e / CV) % BX, y = e / (CV * BX);
      const int oy = by0 + y, ox = bx0 + x, c = co0 + 8 * cv;
      if (oy >= Ho || ox >= Wo || c >= Co) continue;
      float val[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) val[k] = ep[(8 * cv + k) * CS + y * BX + x];
      if (up != nullptr) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (c + k < Co)
            val[k] = bf16_rn(val[k]) +
                     tc::to_f32(up[(((long long)n * Co + c + k) * Hu +
                                    oy / 2) * Wu + ox / 2]);
      }
      bf16* o = out + (((long long)n * Ho + oy) * Wo + ox) * Co + c;
      if (vec_out) {
        *reinterpret_cast<uint4*>(o) = make_uint4(
            tc::pack_bf16(tc::from_f32<bf16>(val[0]),
                          tc::from_f32<bf16>(val[1])),
            tc::pack_bf16(tc::from_f32<bf16>(val[2]),
                          tc::from_f32<bf16>(val[3])),
            tc::pack_bf16(tc::from_f32<bf16>(val[4]),
                          tc::from_f32<bf16>(val[5])),
            tc::pack_bf16(tc::from_f32<bf16>(val[6]),
                          tc::from_f32<bf16>(val[7])));
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (c + k < Co) o[k] = tc::from_f32<bf16>(val[k]);
      }
    }
  }
}

template <int MT, int NTB>
__device__ __forceinline__ void zero(float (&acc)[MT][NTB][4],
                                     float (&part)[MT][NTB][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = part[mt][nt][i] = 0.f;
}

// Two blocks per SM: the compiler keeps each thread within 128 registers.
constexpr int kMinBlocks = 2;

template <int K, int S, int MT, int NTB, int CK>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv2d_bf16_tc(const bf16* __restrict__ x, const uint32_t* __restrict__ wt,
               const float* __restrict__ scale,
               const float* __restrict__ shift, const bf16* __restrict__ up,
               bf16* __restrict__ out, int Ci, int Hi, int Wi, int Co, int Ho,
               int Wo, int relu, int nhwc, int nby, int nbx, int vec,
               int vec_out) {
  using C = Cfg<K, S, MT, NTB, CK>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wx = warp % C::WX, wy = warp / C::WX;
  int b = blockIdx.x;
  const int bx0 = (b % nbx) * C::BX;
  b /= nbx;
  const int by0 = (b % nby) * C::BY;
  const int n = b / nby;
  const int co0 = blockIdx.y * C::NW;

  float acc[MT][NTB][4], part[MT][NTB][4];
  zero(acc, part);
  const int nch = (Ci + CK - 1) / CK;
  auto stage = [&](int ch) -> uint32_t* { return smem + (ch & 1) * C::STAGE; };
  auto load = [&](int ch) {
    uint32_t* s = stage(ch);
    stage_w(s + C::X_WORDS,
            wt + ((long long)blockIdx.y * nch + ch) * C::W_WORDS, C::W_WORDS);
    tc::cp_async_commit();
    stage_x<K, S, MT, NTB, CK>(s, x, n, ch * CK, Ci, Hi, Wi, by0, bx0, vec);
  };

  load(0);
  for (int ch = 0; ch < nch; ++ch) {
    tc::cp_async_wait<0>();
    __syncthreads();
    if (ch + 1 < nch) load(ch + 1);
    const uint32_t* sx = stage(ch);
    chunk_mma<K, S, MT, NTB, CK>(acc, part, sx, sx + C::X_WORDS, wy, wx, g,
                                 t);
  }
  epilogue<MT, NTB, C::BY, C::BX, C::CS>(
      acc, reinterpret_cast<float*>(smem), scale, shift, up, out, n, by0, bx0,
      co0, Co, Ho, Wo, relu, nhwc, vec_out, wy, wx, g, t);
}

// ------------------------------------------------------------ lateral head

// The lateral head: out = conv3x3(sum), sum = nearest_x2(up) + (inner .
// lat + bi), never written. A block (the 3x3 conv's stride-1 tile at CK =
// 16) stages lat (Cl <= 8 channels, CK = 8 layout) over the halo and up
// (all Cu channels, UPW words a position) over the halo's half-resolution
// rows and columns, channels-last; then thread tid forms the sum's 8
// channels 8 q.. 8 q + 7, q = tid % Q, of every halo position e (e = tid /
// Q, ... in steps of 256 / Q): a = fma over ci in order from 0 of lat[ci]
// * wi[c][ci] (the 8 ci; zero past Cl), + bi, rounded to bf16, + up,
// rounded again (the direct kernel's 1x1 conv with its up-add), zero
// outside the image; it stores them as one 16-byte vector into chunk q / 2
// (half q % 2) of the chunk tiles, whose stride ≡ 16 (mod 32) words, so a
// quarter warp's stores fall on distinct banks. Then every chunk's MMAs as
// the conv's, and the conv's epilogue.
template <int MT>
struct Lat {
  using C = Cfg<3, 1, MT, 1, 16>;              // the sum's chunks
  using CL = Cfg<3, 1, MT, 1, 8>;              // lat
  static constexpr int UY = C::BY / 2 + 2, UX = C::BX / 2 + 2;
  static constexpr int UNG = C::BX / 16 + 2;   // up groups a row
  static constexpr int XC = tc::pad_to(C::X_WORDS, 16);   // a chunk tile
};

template <int MT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lateral_conv2d_bf16_tc(const bf16* __restrict__ up,
                       const bf16* __restrict__ lat,
                       const bf16* __restrict__ wi,
                       const float* __restrict__ bi,
                       const uint32_t* __restrict__ wt,
                       bf16* __restrict__ out, int Cu, int Cl, int H, int W,
                       int Co, int nhwc, int nby, int nbx, int urs,
                       int vec_lat, int vec_up, int vec_out) {
  using LT = Lat<MT>;
  using C = typename LT::C;
  using CL = typename LT::CL;
  extern __shared__ __align__(16) uint32_t smem[];
  const int nch = (Cu + 15) / 16;
  const int Q = nch > 2 ? (nch > 4 ? 16 : 8) : 2 * nch;   // a power of two
  const int upw = 8 * nch;                    // up words a position
  uint32_t* s_sum = smem;                              // [nch][XC]
  uint32_t* s_w = s_sum + nch * LT::XC;                // [nch][W_WORDS]
  uint32_t* s_lat = s_w + nch * C::W_WORDS;            // [EY][CL::RS]
  uint32_t* s_up = s_lat + CL::X_WORDS;                // [UY][urs]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wx = warp % C::WX, wy = warp / C::WX;
  int b = blockIdx.x;
  const int bx0 = (b % nbx) * C::BX;
  b /= nbx;
  const int by0 = (b % nby) * C::BY;
  const int n = b / nby;
  const int co0 = blockIdx.y * C::NW;
  const int Hu = H / 2, Wu = W / 2;

  stage_w(s_w, wt + (long long)blockIdx.y * nch * C::W_WORDS,
          nch * C::W_WORDS);
  tc::cp_async_commit();
  // this thread's 8 sum channels: their 1x1 weights and bias
  const int q = threadIdx.x % Q;
  float wq[8][8], bq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * q + i;
    bq[i] = c < Cu && bi != nullptr ? bi[c] : 0.f;
#pragma unroll
    for (int ci = 0; ci < 8; ++ci)
      wq[i][ci] = c < Cu && ci < Cl ? tc::to_f32(wi[c * Cl + ci]) : 0.f;
  }
  stage_cl<CL::EY, CL::NG, 1, CL::RS, CL::PW>(
      s_lat, lat, n, 0, Cl, H, W, by0 - 1, bx0 - 8, vec_lat, [](int rel) {
        const int h = rel - 7;
        return h >= 0 && h < CL::EX ? h : -1;
      });
  // up rows by0 / 2 - 1 ..., inputs bx0 / 2 - 1 ... (group 0 from bx0 / 2
  // - 8); a row of UX positions, 2 nch halves of 8 channels each
  {
    const long long plane = (long long)Hu * Wu;
    const int hfs = 2 * nch;
    for (int e = threadIdx.x; e < hfs * LT::UY * LT::UNG; e += kThreads) {
      const int hf = e % hfs, row = (e / hfs) % LT::UY,
                gi = e / (hfs * LT::UY);
      const int gy = by0 / 2 - 1 + row, cb = 8 * hf;
      const bool okr = gy >= 0 && gy < Hu && cb < Cu;
      const bf16* base = okr ? up + ((long long)n * Cu + cb) * plane +
                                   (long long)gy * Wu
                             : up;
      uint32_t v[8][4];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        load_span<1>(v[c], base + c * plane, bx0 / 2 - 8 + 8 * gi, Wu,
                     okr && cb + c < Cu, vec_up);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int h = 8 * gi + p - 7;
        if (h < 0 || h >= LT::UX) continue;
        const int sel = (p & 1) ? 0x7632 : 0x5410;
        sts128(s_up + row * urs + h * upw + 4 * hf,
               __byte_perm(v[0][p >> 1], v[1][p >> 1], sel),
               __byte_perm(v[2][p >> 1], v[3][p >> 1], sel),
               __byte_perm(v[4][p >> 1], v[5][p >> 1], sel),
               __byte_perm(v[6][p >> 1], v[7][p >> 1], sel));
      }
    }
  }
  __syncthreads();

  // the sum, chunk tiles channels-last
  for (int e = threadIdx.x / Q; e < C::EY * C::EX; e += kThreads / Q) {
    if (q >= 2 * nch) break;                    // no such half
    const int ry = e / C::EX, rx = e % C::EX;
    const int gy = by0 - 1 + ry, gx = bx0 - 1 + rx;
    uint32_t pk[4] = {0u, 0u, 0u, 0u};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const uint4 lv = *reinterpret_cast<const uint4*>(
          s_lat + ry * CL::RS + rx * CL::PW);
      const uint32_t lw[4] = {lv.x, lv.y, lv.z, lv.w};
      const int ur = (gy >> 1) - by0 / 2 + 1, uc = (gx >> 1) - bx0 / 2 + 1;
      const uint4 uv = *reinterpret_cast<const uint4*>(
          s_up + ur * urs + uc * upw + 4 * q);
      const uint32_t uw[4] = {uv.x, uv.y, uv.z, uv.w};
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = 0.f;
#pragma unroll
        for (int ci = 0; ci < 8; ++ci)
          a = fmaf(span_elem(lw, ci), wq[i][ci], a);
        a += bq[i];
        s[i] = bf16_rn(a) + span_elem(uw, i);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pk[i] = tc::pack_bf16(tc::from_f32<bf16>(s[2 * i]),
                              tc::from_f32<bf16>(s[2 * i + 1]));
    }
    sts128(s_sum + (q >> 1) * LT::XC + ry * C::RS + rx * C::PW + 4 * (q & 1),
           pk[0], pk[1], pk[2], pk[3]);
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  float acc[MT][1][4], part[MT][1][4];
  zero(acc, part);
  for (int ch = 0; ch < nch; ++ch)
    chunk_mma<3, 1, MT, 1, 16>(acc, part, s_sum + ch * LT::XC,
                               s_w + ch * C::W_WORDS, wy, wx, g, t);
  epilogue<MT, 1, C::BY, C::BX, C::CS>(
      acc, reinterpret_cast<float*>(smem), nullptr, nullptr, nullptr, out, n,
      by0, bx0, co0, Co, H, W, 0, nhwc, vec_out, wy, wx, g, t);
}

// ------------------------------------------------------------ launchers

// The weights laid out once per call: wt[group][chunk][tap][co NW][CK / 2
// words], word k of a (tap, co) holding channels chunk * CK + 2k, + 1
// (low half first), zero past Co and Ci, from w [Co, Ci, KK]
// (conv3d_bf16.cu's prep_weights_bf16 at KK taps).
__global__ void __launch_bounds__(kThreads)
conv2d_bf16_prep(const bf16* __restrict__ w, uint32_t* __restrict__ wt,
                 int Ci, int Co, int KK, int NW, int CK, int nch,
                 long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int pw = CK / 2;
  long long r = i / (NW * pw);
  const int word = (int)(i - r * NW * pw);
  const int col = word / pw, c = 2 * (word % pw);
  const int tap = (int)(r % KK);
  r /= KK;
  const int ch = (int)(r % nch), grp = (int)(r / nch);
  wt[i] = tc::weight_word(w, grp * NW + col, ch * CK + c, Ci, Co, KK, tap);
}

cudaError_t prep(const bf16* w, void* wt, int Ci, int Co, int KK, int NW,
                 int CK, cudaStream_t s) {
  const int groups = (Co + NW - 1) / NW, nch = (Ci + CK - 1) / CK;
  const long long words = (long long)groups * nch * KK * NW * (CK / 2);
  conv2d_bf16_prep<<<(unsigned)((words + kThreads - 1) / kThreads), kThreads,
                     0, s>>>(w, static_cast<uint32_t*>(wt), Ci, Co, KK, NW,
                             CK, nch, words);
  return cudaGetLastError();
}

template <int K, int S, int MT, int NTB, int CK>
cudaError_t launch_tc(const bf16* x, const bf16* w, const float* scale,
                      const float* shift, const bf16* up, bf16* out, void* wt,
                      int N, int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
                      int relu, int nhwc, cudaStream_t s) {
  using C = Cfg<K, S, MT, NTB, CK>;
  const int nch = (Ci + CK - 1) / CK;
  const size_t stages = sizeof(uint32_t) * C::STAGE * (nch > 1 ? 2 : 1);
  const size_t smem = stages > 4 * (size_t)C::EP ? stages : 4 * C::EP;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = conv2d_bf16_tc<K, S, MT, NTB, CK>;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  err = prep(w, wt, Ci, Co, K * K, C::NW, CK, s);
  if (err != cudaSuccess) return err;
  const int nby = (Ho + C::BY - 1) / C::BY, nbx = (Wo + C::BX - 1) / C::BX;
  const long long blocks = (long long)N * nby * nbx;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = Wi % 8 == 0 && aligned(x, 16);
  const int vec_out = nhwc ? Co % 8 == 0 && aligned(out, 16)
                           : Wo % 8 == 0 && aligned(out, 16) &&
                                 (up == nullptr || aligned(up, 8));
  dim3 grid((unsigned)blocks, (unsigned)((Co + C::NW - 1) / C::NW));
  kern<<<grid, kThreads, smem, s>>>(x, static_cast<const uint32_t*>(wt),
                                    scale, shift, up, out, Ci, Hi, Wi, Co, Ho,
                                    Wo, relu, nhwc, nby, nbx, vec, vec_out);
  return cudaGetLastError();
}

// 8-channel chunks (m16n8k8) for Ci <= 8, else 16 (m16n8k16)
template <int K, int S, int MT, int NTB>
cudaError_t by_ck(const bf16* x, const bf16* w, const float* scale,
                  const float* shift, const bf16* up, bf16* out, void* wt,
                  int N, int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
                  int relu, int nhwc, cudaStream_t s) {
  if (Ci <= 8)
    return launch_tc<K, S, MT, NTB, 8>(x, w, scale, shift, up, out, wt, N, Ci,
                                       Hi, Wi, Co, Ho, Wo, relu, nhwc, s);
  return launch_tc<K, S, MT, NTB, 16>(x, w, scale, shift, up, out, wt, N, Ci,
                                      Hi, Wi, Co, Ho, Wo, relu, nhwc, s);
}

// The tiles ops/conv2d.py's TILES_BF16 lists for each (K, S): (MT, NTB).
template <int K, int S>
cudaError_t by_tile(int mt, int ntb, const bf16* x, const bf16* w,
                    const float* scale, const float* shift, const bf16* up,
                    bf16* out, void* wt, int N, int Ci, int Hi, int Wi,
                    int Co, int Ho, int Wo, int relu, int nhwc,
                    cudaStream_t s) {
#define CONV2D_TILE(M, B)                                                  \
  if (mt == M && ntb == B)                                                 \
    return by_ck<K, S, M, B>(x, w, scale, shift, up, out, wt, N, Ci, Hi,   \
                             Wi, Co, Ho, Wo, relu, nhwc, s);
  CONV2D_TILE(2, 2)
  CONV2D_TILE(1, 4)
  CONV2D_TILE(2, 1)
  CONV2D_TILE(1, 1)
  CONV2D_TILE(1, 2)
  CONV2D_TILE(2, 4)
  if constexpr (K != 5) {
    CONV2D_TILE(4, 1)
    CONV2D_TILE(4, 2)
  }
#undef CONV2D_TILE
  return cudaErrorInvalidValue;
}

template <int MT>
cudaError_t launch_lateral(const bf16* up, const bf16* lat, const bf16* wi,
                           const float* bi, const bf16* w, bf16* out,
                           void* wt, int N, int Cu, int Cl, int H, int W,
                           int Co, int nhwc, cudaStream_t s) {
  using LT = Lat<MT>;
  using C = typename LT::C;
  const int nch = (Cu + 15) / 16;
  // up rows of UX positions, upw words each, padded so that a quarter
  // warp's staging stores (4 halves x 2 rows at Cu = 32) fall on distinct
  // banks
  const int upw = 8 * nch;
  const int urs = tc::pad_to(LT::UX * upw, 4 * (2 * nch) % 32);
  const size_t words = (size_t)nch * LT::XC + nch * C::W_WORDS +
                       LT::CL::X_WORDS + LT::UY * urs;
  const size_t smem = 4 * (words > (size_t)C::EP ? words : C::EP);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = lateral_conv2d_bf16_tc<MT>;
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  err = prep(w, wt, Cu, Co, 9, C::NW, 16, s);
  if (err != cudaSuccess) return err;
  const int nby = (H + C::BY - 1) / C::BY, nbx = (W + C::BX - 1) / C::BX;
  const long long blocks = (long long)N * nby * nbx;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec_lat = W % 8 == 0 && aligned(lat, 16);
  const int vec_up = (W / 2) % 8 == 0 && aligned(up, 16);
  const int vec_out = nhwc ? Co % 8 == 0 && aligned(out, 16)
                           : W % 8 == 0 && aligned(out, 16);
  dim3 grid((unsigned)blocks, (unsigned)((Co + C::NW - 1) / C::NW));
  kern<<<grid, kThreads, smem, s>>>(up, lat, wi, bi,
                                    static_cast<const uint32_t*>(wt), out, Cu,
                                    Cl, H, W, Co, nhwc, nby, nbx, urs,
                                    vec_lat, vec_up, vec_out);
  return cudaGetLastError();
}

}  // namespace

// The direct route (any K in {1, 3, 5}, stride in {1, 2}, padding): x, w,
// up and out bf16; scale, shift float32 or null; nhwc: out is [N, Ho, Wo,
// Co].
extern "C" int conv2d_bf16(const bf16* x, const bf16* w, const float* scale,
                           const float* shift, const bf16* up, bf16* out,
                           int N, int Ci, int Hi, int Wi, int Co, int Ho,
                           int Wo, int K, int stride, int pad, int relu,
                           int nhwc, void* stream) {
  return (int)direct(x, w, scale, shift, up, out, N, Ci, Hi, Wi, Co, Ho, Wo,
                     K, stride, pad, relu, nhwc, (cudaStream_t)stream);
}

// The tensor-core route: (K, stride) in {(3, 1), (5, 2)}, padding K / 2;
// (mt, ntb) one of ops/conv2d.py's TILES_BF16; wt: scratch of
// ceil(Co / 8ntb) * ceil(Ci / 16) * K * K * 8 * 8ntb words (Ci <= 8 uses
// half).
extern "C" int conv2d_tc_bf16(const bf16* x, const bf16* w,
                              const float* scale, const float* shift,
                              const bf16* up, bf16* out, void* wt, int N,
                              int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
                              int K, int stride, int relu, int nhwc, int mt,
                              int ntb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 3 && stride == 1)
    return (int)by_tile<3, 1>(mt, ntb, x, w, scale, shift, up, out, wt, N,
                              Ci, Hi, Wi, Co, Ho, Wo, relu, nhwc, s);
  if (K == 5 && stride == 2)
    return (int)by_tile<5, 2>(mt, ntb, x, w, scale, shift, up, out, wt, N,
                              Ci, Hi, Wi, Co, Ho, Wo, relu, nhwc, s);
  return (int)cudaErrorInvalidValue;
}

// The lateral head (3x3, padding 1): up [N, Cu, H/2, W/2], lat [N, Cl, H,
// W] with Cl <= 8, wi [Cu, Cl], bi [Cu] or null, w [Co, Cu, 3, 3], H and W
// even; wt: scratch as conv2d_tc_bf16's with Ci = Cu, K = 3; mt one of
// ops/conv2d.py's LATERAL_TILES (ntb 1).
extern "C" int lateral_conv2d_bf16(const bf16* up, const bf16* lat,
                                   const bf16* wi, const float* bi,
                                   const bf16* w, bf16* out, void* wt, int N,
                                   int Cu, int Cl, int H, int W, int Co,
                                   int nhwc, int mt, int ntb, void* stream) {
  if (Cl < 1 || Cl > 8 || H % 2 || W % 2 || ntb != 1 || Cu < 1 || Cu > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mt) {
    case 4: return (int)launch_lateral<4>(up, lat, wi, bi, w, out, wt, N, Cu,
                                          Cl, H, W, Co, nhwc, s);
    case 2: return (int)launch_lateral<2>(up, lat, wi, bi, w, out, wt, N, Cu,
                                          Cl, H, W, Co, nhwc, s);
    case 1: return (int)launch_lateral<1>(up, lat, wi, bi, w, out, wt, N, Cu,
                                          Cl, H, W, Co, nhwc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
