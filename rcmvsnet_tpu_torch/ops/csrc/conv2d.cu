// 2D convolution of the FeatureNet FPN, for Hopper: float32 (K5). The bf16
// eval path's K5-bf16 has a design of its own (conv2d_bf16.cu).
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_conv2d.py conv2d_cm
// (_band_kernel), as nn/featurenet_fast.featurenet_packed chains it, and
// also runs what that chain left to XLA: the 1x1 FPN heads (matmul_cm),
// the nearest x2 upsample-add (upsample2_cm) and, in one pass, stage 3's
// head _stage3_polyphase (out3 of the lateral sum, which is never written).
//
// out[n, co, y, x] = epilogue(sum_{ci, ky, kx} w[co, ci, ky, kx] *
//                    in[n, ci, y*s + ky - p, x*s + kx - p])   (zero padding)
// epilogue: r = acc * scale[co] + shift[co]  (folded eval BatchNorm; scale
//           may be null for 1, shift null for 0, which makes shift a bias)
//           r = max(r, 0) if relu
//           r += up[n, co, y / 2, x / 2] if up is given: the FPN's
//           intra = nearest_x2(intra) + inner(conv) in one pass.
// k in {1, 3, 5}, stride in {1, 2}; N = views are batched in one launch.
// Layouts: x, up NCHW; w [Co, Ci, K, K]; out NCHW or, with nhwc, [N, H, W,
// Co] (the warp kernels' source layout, so the heads feed K1 directly).
//
// What bounds it. At 3..32 channels a direct conv on the CUDA cores is
// bound by FMA issue (one FMA per multiply-add, 67 TFLOP/s), ~4x above
// the bytes each call must move. Two routes, picked per call by
// ops/conv2d.route:
//   * "tc" (the 3x3 and 5x5 convs with Ci >= 8): an implicit GEMM on the
//     tensor cores, M = 16 consecutive output x of a row, N = Co, K =
//     Ci * k * k in chunks of 8 input channels per tap, 3xTF32 m16n8k8
//     MMAs with the short-chain flush of tc_conv3d.cuh (one TF32 product
//     misses the 1e-4 gates). A block (8 warps, two per SM) owns a tile
//     of output rows x columns x NTB n8 tiles of Co (see Tile); per
//     8-channel chunk it stages the input tile plus its halo in shared
//     memory with cp.async (16-byte row vectors at stride 1 when rows are
//     aligned), zero-filled outside the image, stride-2 rows stored as two
//     parity halves so that a strided read is contiguous,
//     and the chunk's weights [tap][ci][co], laid out once per call by
//     prep_weights; the k * k taps read shifted windows of that one tile,
//     and two chunks are in flight where there are two. At stride 1 a
//     warp owns MT rows, so each halo row's A fragment is split hi + lo
//     once and feeds every (output row, tap row) that reads it, which
//     halves the splits on the CUDA cores at MT = 4.
//   * "direct" (conv0.0, Ci = 3, and the 1x1 heads, all bound by bytes;
//     each measured faster than its tensor-core run): one thread per
//     output pixel and CO_T output channels, the weight tile in shared
//     memory read as a broadcast.
// And the lateral head (lateral_conv2d_f32): out3 = conv3x3(nearest_x2(
// up) + inner(lat) + b) where the TPU path never writes the full-resolution
// 32-channel sum: the block stages the lateral input (8 channels) once,
// then per 8-channel chunk of the sum forms the chunk's halo tile in
// shared memory (inner's 1x1 product, + b, + the half-resolution up, zero
// outside the image) and runs the tap MMAs on it. That removes the sum's
// write and read (1.27 GB at 5 views of 864x1152).
// Measured (tools/ab_conv2d.py, PERF.md): the tensor-core calls run at
// 3-7x their floor (bytes, or 3 TF32 products per multiply-add over 495
// TFLOP/s). Halving the splits (the row reuse, against a first tile of
// one output row a warp), a third block per SM, or no register cap moved
// them by far less than that gap: what is left is the latency of each
// chunk's chain of shared-memory loads, splits and MMAs between two
// barriers.
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_conv3d.cuh"

namespace {

constexpr int kThreads = 128;

// The epilogue of one output value: r = acc * scale + shift, ReLU, and the
// upsample-add.
__device__ __forceinline__ float epilogue(float r, const float* scale,
                                          const float* shift, int relu,
                                          const float* up, long long up_idx,
                                          int co) {
  if (scale != nullptr) r *= scale[co];
  if (shift != nullptr) r += shift[co];
  if (relu) r = fmaxf(r, 0.f);
  if (up != nullptr) r = r + up[up_idx];
  return r;
}

// NHWC: out is [N, H, W, Co]; the NCHW instance is the first port's kernel.
template <int K, int CO_T, bool NHWC>
__global__ void __launch_bounds__(kThreads)
conv2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ scale,
              const float* __restrict__ shift,
              const float* __restrict__ up, float* __restrict__ out,
              int N, int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
              int stride, int pad, int relu) {
  extern __shared__ float s_w[];  // [Ci][K*K][CO_T]
  const int co0 = blockIdx.y * CO_T;
  for (int i = threadIdx.x; i < Ci * K * K * CO_T; i += blockDim.x) {
    const int j = i % CO_T;
    const int k = (i / CO_T) % (K * K);
    const int c = i / (CO_T * K * K);
    s_w[i] = w[((long long)(co0 + j) * Ci + c) * K * K + k];
  }
  __syncthreads();

  const long long out_sp = (long long)Ho * Wo;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)N * out_sp) return;
  const int n = (int)(idx / out_sp);
  const long long r = idx - (long long)n * out_sp;
  const int oy = (int)(r / Wo);
  const int ox = (int)(r - (long long)oy * Wo);
  const int y0 = oy * stride - pad, x0 = ox * stride - pad;

  float acc[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) acc[j] = 0.f;

  const long long in_sp = (long long)Hi * Wi;
  for (int c = 0; c < Ci; ++c) {
    const float* xc = x + ((long long)n * Ci + c) * in_sp;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const int yi = y0 + ky;
      if (yi < 0 || yi >= Hi) continue;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const int xi = x0 + kx;
        if (xi < 0 || xi >= Wi) continue;
        const float v = __ldg(xc + (long long)yi * Wi + xi);
        const float* wk = s_w + (c * K * K + ky * K + kx) * CO_T;
#pragma unroll
        for (int j = 0; j < CO_T; ++j) acc[j] = fmaf(v, wk[j], acc[j]);
      }
    }
  }

  const int Hu = Ho / 2, Wu = Wo / 2;
  auto result = [&](int j) {
    const int co = co0 + j;
    return epilogue(acc[j], scale, shift, relu, up,
                    (((long long)n * Co + co) * Hu + oy / 2) * Wu + ox / 2,
                    co);
  };
  if constexpr (!NHWC) {
#pragma unroll
    for (int j = 0; j < CO_T; ++j)
      out[((long long)n * Co + co0 + j) * out_sp + r] = result(j);
  } else {
    // the thread's CO_T channels are contiguous (16-byte aligned where
    // CO_T, which divides Co, is a multiple of 4)
    float* o = out + (n * out_sp + r) * Co + co0;
    if constexpr (CO_T % 4 == 0) {
#pragma unroll
      for (int j = 0; j < CO_T; j += 4)
        *reinterpret_cast<float4*>(o + j) = make_float4(
            result(j), result(j + 1), result(j + 2), result(j + 3));
    } else {
#pragma unroll
      for (int j = 0; j < CO_T; ++j) o[j] = result(j);
    }
  }
}

template <int K, int CO_T, bool NHWC>
cudaError_t launch(const float* x, const float* w, const float* scale,
                   const float* shift, const float* up, float* out, int N,
                   int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
                   int stride, int pad, int relu, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Ci * K * K * CO_T;
  cudaError_t e = cudaFuncSetAttribute(
      conv2d_kernel<K, CO_T, NHWC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n = (long long)N * Ho * Wo;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), Co / CO_T);
  conv2d_kernel<K, CO_T, NHWC><<<grid, kThreads, smem, stream>>>(
      x, w, scale, shift, up, out, N, Ci, Hi, Wi, Co, Ho, Wo, stride, pad,
      relu);
  return cudaGetLastError();
}

template <int K, int CO_T>
cudaError_t launch_layout(const float* x, const float* w, const float* scale,
                          const float* shift, const float* up, float* out,
                          int N, int Ci, int Hi, int Wi, int Co, int Ho,
                          int Wo,
                          int stride, int pad, int relu, int nhwc,
                          cudaStream_t s) {
  if (nhwc)
    return launch<K, CO_T, true>(x, w, scale, shift, up, out, N, Ci, Hi, Wi,
                                 Co, Ho, Wo, stride, pad, relu, s);
  return launch<K, CO_T, false>(x, w, scale, shift, up, out, N, Ci, Hi, Wi,
                                Co, Ho, Wo, stride, pad, relu, s);
}

template <int K>
cudaError_t dispatch_co(const float* x, const float* w, const float* scale,
                        const float* shift, const float* up, float* out,
                        int N, int Ci, int Hi, int Wi, int Co, int Ho,
                        int Wo,
                        int stride, int pad, int relu, int nhwc,
                        cudaStream_t s) {
  if (Co % 16 == 0)
    return launch_layout<K, 16>(x, w, scale, shift, up, out, N, Ci, Hi, Wi,
                                Co, Ho, Wo, stride, pad, relu, nhwc, s);
  if (Co % 8 == 0)
    return launch_layout<K, 8>(x, w, scale, shift, up, out, N, Ci, Hi, Wi,
                               Co, Ho, Wo, stride, pad, relu, nhwc, s);
  return launch_layout<K, 1>(x, w, scale, shift, up, out, N, Ci, Hi, Wi, Co,
                             Ho, Wo, stride, pad, relu, nhwc, s);
}

cudaError_t direct(const float* x, const float* w, const float* scale,
                   const float* shift, const float* up, float* out, int N,
                   int Ci, int Hi, int Wi, int Co, int Ho, int Wo, int K,
                   int stride, int pad, int relu, int nhwc, cudaStream_t s) {
  switch (K) {
    case 1: return dispatch_co<1>(x, w, scale, shift, up, out, N, Ci, Hi, Wi,
                                  Co, Ho, Wo, stride, pad, relu, nhwc, s);
    case 3: return dispatch_co<3>(x, w, scale, shift, up, out, N, Ci, Hi, Wi,
                                  Co, Ho, Wo, stride, pad, relu, nhwc, s);
    case 5: return dispatch_co<5>(x, w, scale, shift, up, out, N, Ci, Hi, Wi,
                                  Co, Ho, Wo, stride, pad, relu, nhwc, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------ tensor-core route

using tc::kCiChunk;
using tc::kWarps;

// The tile of a block: 8 warps as WY rows x WX columns (stride 1: 2 x 4;
// stride 2: 8 x 1, where a wide tile's halo would be mostly rows); warp
// (wy, wx) owns the MT output rows by0 + wy * MT + [0, MT) and the 16
// columns bx0 + 16 * wx + [0, 16), so a block covers BY = WY * MT rows x
// BX = 16 * WX columns. Its input halo is EY x EX from (S * by0 - K/2,
// S * bx0 - K/2).
// Rows in shared memory: inputs S * bx0 - 4 .. as whole four-element
// vectors (column = halo x + 4 - K/2), output positions PSTR columns
// apart; but stride 2 stores the even then the odd halo columns (column =
// (rx & 1) * XH + rx / 2), since two floats apart two lanes of a fragment
// load would share a bank.
template <int K, int S, int MT>
struct Tile {
  static constexpr int WX = S == 1 ? 4 : 1, WY = kWarps / WX;
  static constexpr int BY = WY * MT, BX = 16 * WX, PAD = K / 2;
  static constexpr int EY = S * (BY - 1) + K, EX = S * (BX - 1) + K;
  static constexpr int XH = (EX + 1) / 2;
  static constexpr bool SPLIT = S == 2;             // parity halves
  static constexpr int PSTR = SPLIT ? 1 : S;
  static constexpr int XS = SPLIT ? 2 * XH : S * BX + 8;
  static constexpr int NV = XS / 4;                 // vectors a row
  static constexpr int PS = tc::pad_to(EY * XS, 8); // channel plane stride
  static_assert(SPLIT || EX + 4 - PAD <= XS, "row fits");
  static __device__ __forceinline__ int xcol(int rx) {
    return SPLIT ? (rx & 1) * XH + (rx >> 1) : rx + 4 - PAD;
  }
};

template <int K, int S, int MT, int NTB>
struct Cfg {
  using T_ = Tile<K, S, MT>;
  using E = tc::Elem<float>;
  static constexpr int NW = 8 * NTB;                // channels per block
  static constexpr int NPS = tc::weight_stride(NW); // B loads: t*NPS + g
  // a chunk's staged tile, CK planes of PS floats
  static constexpr int X_FLOATS = E::CK * T_::PS;
  static constexpr int W_FLOATS = K * K * kCiChunk * NPS;
  static constexpr int STAGE = X_FLOATS + W_FLOATS;
};

// Channels [c0, c0 + CK) of the halo tile of sample n into s (plane
// stride PS): zero outside the image and for channels >= C. vec (rows kept
// whole, rows of x aligned for whole vectors): whole rows of four-element
// vectors; else one element a thread and step.
template <int K, int S, int MT>
__device__ __forceinline__ void load_tile(float* s, const float* x, int n,
                                          int c0, int C, int H, int W,
                                          int by0, int bx0, bool vec) {
  using Tl = Tile<K, S, MT>;
  constexpr int CK = tc::Elem<float>::CK;
  const int iy0 = S * by0 - Tl::PAD;
  if (!Tl::SPLIT && vec) {
    const int gx0 = S * bx0 - 4;
    constexpr int total = CK * Tl::EY * Tl::NV;
    for (int e = threadIdx.x; e < total; e += tc::kThreads) {
      const int v = e % Tl::NV;
      const int r = e / Tl::NV;
      const int ry = r % Tl::EY, c = r / Tl::EY;
      const int gy = iy0 + ry, gx = gx0 + 4 * v;
      const int nx = (c0 + c < C && gy >= 0 && gy < H && gx >= 0)
                         ? min(4, max(0, W - gx))
                         : 0;
      const float* src =
          nx ? x + (((long long)n * C + c0 + c) * H + gy) * W + gx : x;
      tc::cp_async_vec(s + c * Tl::PS + ry * Tl::XS + 4 * v, src, nx);
    }
    return;
  }
  const int ix0 = S * bx0 - Tl::PAD;
  constexpr int total = CK * Tl::EY * Tl::EX;
  for (int e = threadIdx.x; e < total; e += tc::kThreads) {
    const int rx = e % Tl::EX;
    const int r = e / Tl::EX;
    const int ry = r % Tl::EY, c = r / Tl::EY;
    const int gy = iy0 + ry, gx = ix0 + rx;
    const bool ok =
        c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* src =
        ok ? x + (((long long)n * C + c0 + c) * H + gy) * W + gx : x;
    tc::stage_one(s + c * Tl::PS + ry * Tl::XS + Tl::xcol(rx), src, ok);
  }
}

// B fragment of tap `tap` (b0: row t, b1: row t + 4; column g of n-tile
// nt).
template <int NPS>
__device__ __forceinline__ tc::Elem<float>::B load_b(const float* sw,
                                                     int tap, int nt, int g,
                                                     int t) {
  return tc::Elem<float>::load_b(sw + (tap * kCiChunk + t) * NPS + nt * 8 + g,
                                 NPS);
}

// A fragment at smem row `row`, x column `col` (row g / g + 8 = x, PSTR
// columns apart; the channels of the lane per tc::Elem).
template <int XS, int PS, int PSTR>
__device__ __forceinline__ tc::Elem<float>::A load_a(const float* sx,
                                                     int row, int col, int g,
                                                     int t) {
  return tc::Elem<float>::template load_a<PSTR>(sx + row * XS + col, PS, g,
                                                t);
}

// The K x K taps of one staged chunk: acc[mt][nt] += window(tap) x w[tap].
// Stride 1: per tap column kx, the K B fragments stay in registers and the
// warp walks its MT + K - 1 halo rows; each row's A fragment is loaded
// (and split) once and feeds every (output row mt, tap row ky) with mt +
// ky = that row (up to K of them). Stride 2: per tap, the MT rows'
// fragments. Short MMA chains flushed into acc after each tap column
// (stride 1) or each tap row (stride 2).
template <int K, int S, int MT, int NTB, int SS>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][NTB][4],
                                          float (&part)[MT][NTB][SS][4],
                                          const float* sx, const float* sw,
                                          int wy, int wx, int g, int t) {
  using C = Cfg<K, S, MT, NTB>;
  using Tl = typename C::T_;
  using E = typename C::E;
  if constexpr (S == 1) {
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
      typename E::B b[K][NTB];
#pragma unroll
      for (int ky = 0; ky < K; ++ky)
#pragma unroll
        for (int nt = 0; nt < NTB; ++nt)
          b[ky][nt] = load_b<C::NPS>(sw, ky * K + kx, nt, g, t);
#pragma unroll
      for (int z = 0; z < MT + K - 1; ++z) {
        const typename E::A a = load_a<Tl::XS, Tl::PS, 1>(
            sx, wy * MT + z, 16 * wx + kx + 4 - Tl::PAD, g, t);
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const int mt = z - ky;
          if (mt >= 0 && mt < MT) {
#pragma unroll
            for (int nt = 0; nt < NTB; ++nt)
              E::mma(part[mt][nt], a, b[ky][nt]);
          }
        }
      }
      tc::flush(acc, part);
    }
  } else {
#pragma unroll 1
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        typename E::B b[NTB];
#pragma unroll
        for (int nt = 0; nt < NTB; ++nt)
          b[nt] = load_b<C::NPS>(sw, ky * K + kx, nt, g, t);
        const int col = Tl::xcol(S * 16 * wx + kx);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const typename E::A a = load_a<Tl::XS, Tl::PS, Tl::PSTR>(
              sx, S * (wy * MT + mt) + ky, col, g, t);
#pragma unroll
          for (int nt = 0; nt < NTB; ++nt) E::mma(part[mt][nt], a, b[nt]);
        }
      }
      tc::flush(acc, part);
    }
  }
}

// acc: C fragment (row g / g + 8 = x position, col 2t / 2t + 1 = co) of
// output rows oy0 + mt, columns ox0 + [0, 16). In [N, H, W, Co] the two
// channels of a lane are one 8-byte store.
template <int MT, int NTB>
__device__ __forceinline__ void store_tile(
    const float (&acc)[MT][NTB][4], const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ up,
    float* __restrict__ out, int n, int oy0, int ox0, int co0, int Co, int Ho,
    int Wo, int relu, int nhwc, int g, int t) {
  const int Hu = Ho / 2, Wu = Wo / 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int oy = oy0 + mt;
    if (oy >= Ho) continue;
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = ox0 + g + 8 * h;
        const int co = co0 + nt * 8 + 2 * t;
        if (ox >= Wo || co >= Co) continue;
        float r[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = min(co + e, Co - 1);
          r[e] = epilogue(acc[mt][nt][2 * h + e], scale, shift, relu, up,
                          (((long long)n * Co + c) * Hu + oy / 2) * Wu +
                              ox / 2,
                          c);
        }
        const long long pix = ((long long)n * Ho + oy) * Wo + ox;
        if (nhwc && co + 1 < Co && Co % 2 == 0) {
          *reinterpret_cast<float2*>(out + pix * Co + co) =
              make_float2(r[0], r[1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (co + e >= Co) continue;
          out[nhwc ? pix * Co + co + e
                   : (((long long)n * Co + co + e) * Ho + oy) * Wo + ox] =
              r[e];
        }
      }
  }
}

template <int MT, int NTB, int SS>
__device__ __forceinline__ void zero(float (&acc)[MT][NTB][4],
                                     float (&part)[MT][NTB][SS][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0.f;
#pragma unroll
        for (int k = 0; k < SS; ++k) part[mt][nt][k][i] = 0.f;
      }
}

// Two blocks per SM: the compiler keeps each thread within 128 registers.
constexpr int kMinBlocks = 2;

template <int K, int S, int MT, int NTB>
__global__ void __launch_bounds__(tc::kThreads, kMinBlocks)
conv2d_tc(const float* __restrict__ x, const void* __restrict__ wt,
          const float* __restrict__ scale, const float* __restrict__ shift,
          const float* __restrict__ up, float* __restrict__ out, int Ci,
          int Hi,
          int Wi, int Co, int Ho, int Wo, int relu, int nhwc, int nby,
          int nbx, int vec) {
  using C = Cfg<K, S, MT, NTB>;
  using Tl = typename C::T_;
  using E = typename C::E;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wx = warp % Tl::WX, wy = warp / Tl::WX;
  int b = blockIdx.x;
  const int bx0 = (b % nbx) * Tl::BX;
  b /= nbx;
  const int by0 = (b % nby) * Tl::BY;
  const int n = b / nby;
  const int co0 = blockIdx.y * C::NW;

  float acc[MT][NTB][4], part[MT][NTB][E::S][4];
  zero(acc, part);
  const int nch = (Ci + E::CK - 1) / E::CK;
  auto stage = [&](int ch) -> float* {
    return smem + (nch > 1 ? (ch & 1) * C::STAGE : 0);
  };
  auto load = [&](int ch) {
    float* s = stage(ch);
    load_tile<K, S, MT>(s, x, n, ch * E::CK, Ci, Hi, Wi, by0, bx0, vec);
    tc::load_weights<K * K, C::NW, C::NPS>(
        s + C::X_FLOATS,
        static_cast<const uint32_t*>(wt) +
            ((long long)blockIdx.y * nch + ch) * K * K * kCiChunk * C::NW);
    tc::cp_async_commit();
  };

  load(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load(ch + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = stage(ch);
    chunk_mma<K, S, MT, NTB>(acc, part, st, st + C::X_FLOATS, wy, wx, g, t);
    __syncthreads();
  }
  store_tile(acc, scale, shift, up, out, n, by0 + wy * MT, bx0 + 16 * wx,
             co0, Co, Ho, Wo, relu, nhwc, g, t);
}

// The lateral head: out = conv3x3(sum) with sum = nearest_x2(up) +
// (inner . lat + bi), formed per chunk of sum in shared memory and never
// written. up [N, Cu, H/2, W/2], lat [N, Cl, H, W] (Cl <= 8), wi [Cu, Cl],
// bi [Cu]; the sum's rounding is the direct kernel's for the 1x1 conv
// with its up-add: fma over ci in order, + bi, + up. Each thread forms
// whole halo positions: the 8 lateral channels in registers, then the
// chunk's CK sums.
template <int MT, int NTB>
__global__ void __launch_bounds__(tc::kThreads, kMinBlocks)
lateral_conv2d_tc(const float* __restrict__ up, const float* __restrict__ lat,
                  const float* __restrict__ wi, const float* __restrict__ bi,
                  const void* __restrict__ wt, float* __restrict__ out,
                  int Cu, int Cl, int H, int W, int Co, int nhwc, int nby,
                  int nbx, int vec) {
  using C = Cfg<3, 1, MT, NTB>;
  using Tl = typename C::T_;
  constexpr int CK = C::E::CK;
  extern __shared__ __align__(16) float smem[];
  float* s_lat = smem;                               // [CK][PS]
  float* sx = smem + C::X_FLOATS;                    // [CK][PS]
  float* sw = smem + 2 * C::X_FLOATS;                // [9][8][NPS]
  float* s_wi = sw + C::W_FLOATS;                    // [Cu][8]
  float* s_bi = s_wi + Cu * kCiChunk;                // [Cu]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wx = warp % Tl::WX, wy = warp / Tl::WX;
  int b = blockIdx.x;
  const int bx0 = (b % nbx) * Tl::BX;
  b /= nbx;
  const int by0 = (b % nby) * Tl::BY;
  const int n = b / nby;
  const int co0 = blockIdx.y * C::NW;
  const int iy0 = by0 - 1, ix0 = bx0 - 1;
  const int Hu = H / 2, Wu = W / 2;
  const long long up_plane = (long long)Hu * Wu;

  load_tile<3, 1, MT>(s_lat, lat, n, 0, Cl, H, W, by0, bx0, vec);
  tc::cp_async_commit();
  for (int i = threadIdx.x; i < Cu * kCiChunk; i += tc::kThreads) {
    const int c = i / kCiChunk, ci = i % kCiChunk;
    s_wi[i] = ci < Cl ? wi[c * Cl + ci] : 0.f;
  }
  for (int i = threadIdx.x; i < Cu; i += tc::kThreads)
    s_bi[i] = bi != nullptr ? bi[i] : 0.f;

  float acc[MT][NTB][4], part[MT][NTB][C::E::S][4];
  zero(acc, part);
  const int nch = (Cu + CK - 1) / CK;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();              // the last chunk's MMAs are done with sx
    tc::load_weights<9, C::NW, C::NPS>(
        sw, static_cast<const uint32_t*>(wt) +
                ((long long)blockIdx.y * nch + ch) * 9 * kCiChunk * C::NW);
    tc::cp_async_commit();
    if (ch == 0) {
      tc::cp_async_wait<1>();     // the lateral tile has landed
      __syncthreads();
    }
    const int c0 = ch * CK;
    for (int e = threadIdx.x; e < Tl::EY * Tl::EX; e += tc::kThreads) {
      const int rx = e % Tl::EX, ry = e / Tl::EX;
      const int gy = iy0 + ry, gx = ix0 + rx;
      const int off = ry * Tl::XS + Tl::xcol(rx);
      float v[CK];
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float l[kCiChunk];
#pragma unroll
        for (int ci = 0; ci < kCiChunk; ++ci)
          l[ci] = s_lat[ci * Tl::PS + off];
        const float* upp = up + ((long long)n * Cu + c0) * up_plane +
                       (long long)(gy >> 1) * Wu + (gx >> 1);
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          v[c] = 0.f;
          if (c0 + c < Cu) {
            const float* wc = s_wi + (c0 + c) * kCiChunk;
            float a = 0.f;
#pragma unroll
            for (int ci = 0; ci < kCiChunk; ++ci) a = fmaf(l[ci], wc[ci], a);
            a += s_bi[c0 + c];
            v[c] = a + __ldg(upp + c * up_plane);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < CK; ++c) v[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) sx[c * Tl::PS + off] = v[c];
    }
    tc::cp_async_wait<0>();
    __syncthreads();
    chunk_mma<3, 1, MT, NTB>(acc, part, sx, sw, wy, wx, g, t);
  }
  store_tile(acc, nullptr, nullptr, static_cast<const float*>(nullptr), out,
             n,
             by0 + wy * MT, bx0 + 16 * wx, co0, Co, H, W, 0, nhwc, g, t);
}

template <class Kern>
cudaError_t allow(Kern* kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Every block's row vectors need rows of x aligned to a vector's bytes.
int vec_rows(const float* x, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <int K, int S, int MT, int NTB>
cudaError_t launch_tc(const float* x, const float* w, const float* scale,
                      const float* shift, const float* up, float* out,
                      void* wt,
                      int N, int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
                      int relu, int nhwc, cudaStream_t s) {
  using C = Cfg<K, S, MT, NTB>;
  const int nch = (Ci + C::E::CK - 1) / C::E::CK;
  const size_t smem = sizeof(float) * C::STAGE * (nch > 1 ? 2 : 1);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = allow(conv2d_tc<K, S, MT, NTB>, smem);
  if (err != cudaSuccess) return err;
  err = tc::prep(w, wt, Ci, Co, K * K, C::NW, s);
  if (err != cudaSuccess) return err;
  const int nby = (Ho + C::T_::BY - 1) / C::T_::BY;
  const int nbx = (Wo + C::T_::BX - 1) / C::T_::BX;
  const long long blocks = (long long)N * nby * nbx;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)((Co + C::NW - 1) / C::NW));
  conv2d_tc<K, S, MT, NTB><<<grid, tc::kThreads, smem, s>>>(
      x, wt, scale, shift, up, out, Ci, Hi, Wi, Co, Ho, Wo, relu, nhwc, nby,
      nbx, C::T_::SPLIT ? 0 : vec_rows(x, Wi));
  return cudaGetLastError();
}

// The tiles ops/conv2d.py's TILES lists for each (K, S): (MT, NTB).
template <int K, int S>
cudaError_t by_tile(int mt, int ntb, const float* x, const float* w,
                    const float* scale, const float* shift, const float* up,
                    float* out, void* wt, int N, int Ci, int Hi, int Wi,
                    int Co, int Ho, int Wo, int relu, int nhwc,
                    cudaStream_t s) {
#define CONV2D_TILE(M, B)                                                  \
  if (mt == M && ntb == B)                                                 \
    return launch_tc<K, S, M, B>(x, w, scale, shift, up, out, wt, N, Ci,   \
                                 Hi, Wi, Co, Ho, Wo, relu, nhwc, s);
  CONV2D_TILE(2, 2)
  CONV2D_TILE(1, 4)
  CONV2D_TILE(2, 1)
  CONV2D_TILE(1, 1)
  CONV2D_TILE(1, 2)
  if constexpr (K != 5) {
    CONV2D_TILE(4, 1)
  }
#undef CONV2D_TILE
  return cudaErrorInvalidValue;
}

cudaError_t tensor_cores(const float* x, const float* w, const float* scale,
                         const float* shift, const float* up, float* out,
                         void* wt,
                         int N, int Ci, int Hi, int Wi, int Co, int Ho,
                         int Wo, int K, int stride, int relu, int nhwc,
                         int mt, int ntb, cudaStream_t s) {
  if (K == 3 && stride == 1)
    return by_tile<3, 1>(mt, ntb, x, w, scale, shift, up, out, wt, N, Ci, Hi,
                         Wi, Co, Ho, Wo, relu, nhwc, s);
  if (K == 5 && stride == 2)
    return by_tile<5, 2>(mt, ntb, x, w, scale, shift, up, out, wt, N, Ci, Hi,
                         Wi, Co, Ho, Wo, relu, nhwc, s);
  return cudaErrorInvalidValue;
}

template <int MT, int NTB>
cudaError_t launch_lateral(const float* up, const float* lat,
                           const float* wi, const float* bi, const float* w,
                           float* out, void* wt,
                           int N, int Cu, int Cl, int H, int W, int Co,
                           int nhwc, cudaStream_t s) {
  using C = Cfg<3, 1, MT, NTB>;
  const size_t smem =
      sizeof(float) * (2 * C::X_FLOATS + C::W_FLOATS + Cu * (kCiChunk + 1));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = allow(lateral_conv2d_tc<MT, NTB>, smem);
  if (err != cudaSuccess) return err;
  err = tc::prep(w, wt, Cu, Co, 9, C::NW, s);
  if (err != cudaSuccess) return err;
  const int nby = (H + C::T_::BY - 1) / C::T_::BY;
  const int nbx = (W + C::T_::BX - 1) / C::T_::BX;
  const long long blocks = (long long)N * nby * nbx;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)((Co + C::NW - 1) / C::NW));
  lateral_conv2d_tc<MT, NTB><<<grid, tc::kThreads, smem, s>>>(
      up, lat, wi, bi, wt, out, Cu, Cl, H, W, Co, nhwc, nby, nbx,
      vec_rows(lat, W));
  return cudaGetLastError();
}

cudaError_t lateral(const float* up, const float* lat, const float* wi,
                    const float* bi, const float* w, float* out, void* wt,
                    int N, int Cu, int Cl,
                    int H, int W, int Co, int nhwc, int mt, int ntb,
                    cudaStream_t s) {
  if (Cl < 1 || Cl > kCiChunk || H % 2 || W % 2) return cudaErrorInvalidValue;
#define LATERAL_TILE(M, B)                                                 \
  if (mt == M && ntb == B)                                                 \
    return launch_lateral<M, B>(up, lat, wi, bi, w, out, wt, N, Cu, Cl, H, \
                                W, Co, nhwc, s);
  LATERAL_TILE(4, 1)
  LATERAL_TILE(2, 1)
  LATERAL_TILE(1, 1)
#undef LATERAL_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// The direct route. scale, shift and up may be null (see the epilogue
// above); nhwc: out is [N, Ho, Wo, Co].
extern "C" int conv2d_f32(const float* x, const float* w, const float* scale,
                          const float* shift, const float* up, float* out,
                          int N, int Ci, int Hi, int Wi, int Co, int Ho,
                          int Wo, int K, int stride, int pad, int relu,
                          int nhwc, void* stream) {
  return (int)direct(x, w, scale, shift, up, out, N, Ci, Hi, Wi, Co, Ho, Wo,
                     K, stride, pad, relu, nhwc, (cudaStream_t)stream);
}

// The tensor-core route: (K, stride) in {(3, 1), (5, 2)}, padding K / 2;
// (mt, ntb) one of ops/conv2d.py's TILES; wt: scratch of ceil(Co / 8ntb)
// * ceil(Ci / 8) * K * K * 8 * 8ntb words.
extern "C" int conv2d_tc_f32(const float* x, const float* w,
                             const float* scale, const float* shift,
                             const float* up, float* out, void* wt, int N,
                             int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
                             int K, int stride, int relu, int nhwc, int mt,
                             int ntb, void* stream) {
  return (int)tensor_cores(x, w, scale, shift, up, out, wt, N, Ci, Hi, Wi,
                           Co, Ho, Wo, K, stride, relu, nhwc, mt, ntb,
                           (cudaStream_t)stream);
}

// The lateral head (3x3, padding 1): up [N, Cu, H/2, W/2], lat [N, Cl, H,
// W] with Cl <= 8, wi [Cu, Cl], bi [Cu] or null, w [Co, Cu, 3, 3]; wt:
// scratch as conv2d_tc_f32's with Ci = Cu, K = 3; (mt, ntb) one of
// ops/conv2d.py's LATERAL_TILES.
extern "C" int lateral_conv2d_f32(const float* up, const float* lat,
                                  const float* wi, const float* bi,
                                  const float* w, float* out, void* wt,
                                  int N, int Cu, int Cl, int H, int W, int Co,
                                  int nhwc, int mt, int ntb, void* stream) {
  return (int)lateral(up, lat, wi, bi, w, out, wt, N, Cu, Cl, H, W, Co, nhwc,
                      mt, ntb, (cudaStream_t)stream);
}
