// 3x3x3 convolution of the cost-volume U-Net on Hopper's tensor cores: an
// implicit GEMM, M = output positions, N = Co, K = 27 * Ci, float32 with
// 3xTF32 products. The bf16 instance (K2-bf16) has its own design in
// conv3d_bf16.cu.
//
// Replaces the TPU kernels rcmvsnet_tpu/ops/pallas_costreg.py conv_lanes
// (_conv_lanes_kernel, _conv_lanes_k9_kernel, composed by costreg_lanes;
// their body is jnp.dot(w, x_cat) on the MXU) AND
// rcmvsnet_tpu/ops/pallas_resample.py subsample_lanes / stuff_lanes
// (_sub_kernel, _stuff_kernel): those copies exist only because the TPU
// U-Net keeps a lane layout. Here they fold into the addressing:
//   mode 0  stride 1, padding 1:   in = out + k - 1
//   mode 1  stride 2, padding 1:   in = 2*out + k - 1 (the stride-2
//           outputs directly; nothing is computed twice)
//   mode 2  transposed, k3 s2 p1 output_padding 1, as 8 parity classes of
//           the input grid (tc_conv3d.cuh): output 2*b + p, no stuffed
//           zero ever multiplied. Do/Ho/Wo may be 2*in - 1 per axis (the
//           adjoint of a stride-2 conv over an odd size): the last output
//           row is then not written.
// Epilogue: + bias (the eval BatchNorm is folded into weight and bias by
// the caller), optional ReLU, optional skip add AFTER the ReLU (the
// decoder's conv_k + deconv(x)), as in costreg_lanes.
//
// Layouts: x [N, Ci, Di, Hi, Wi]; w [Co, Ci, 27] (for mode 2 the caller
// hands the ConvTranspose3d weight [Ci, Co, 3, 3, 3] transposed to
// [Co, Ci, 27]), laid out per block group and chunk by prep_weights into
// the caller's scratch wt; bias [Co] float32; skip and out [N, Co, Do,
// Ho, Wo].
//
// Design. A block (8 warps) owns a brick of MT x 8 x 16 base positions
// (warp w: the MT rows of 16 x positions at y = w, one m16 tile each) and
// NTB n8 tiles of output channels (Co padded with zeros to a multiple of
// 8; blocks along gridDim.y cover the rest); in mode 2 it computes all 8
// parity classes of its brick. Per 8-channel chunk of Ci it stages the
// halo brick (16-byte row vectors in modes 0 and 2) and the chunk's
// weights [tap][ci][co] (laid out once per call by prep_weights) in shared
// memory with cp.async, double-buffered so the next chunk loads while the
// tensor cores work on this one. The 27 taps read shifted windows of that
// one brick: an input value leaves device memory once per block, not once
// per tap. In mode 0 each halo row is split once per (ky, kx) and feeds
// every (tile, kz) that reads it. Products are 3xTF32 m16n8k8 MMAs into
// three accumulators, flushed every 9 taps (tc_conv3d.cuh).
//
// Bound: at these widths (Ci, Co 1..64) the MMAs are small (k = 8 per
// chunk and tap), so staging, fragment loads and the hi/lo splits on the
// CUDA cores, not HBM, bound it, staging and compute both a large share;
// the compute floor counts 3 TF32 products per multiply-add.
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_conv3d.cuh"

namespace {

using namespace tc;

template <int MODE, int MT, int NTB, class T>
struct Cfg {
  using E = Elem<T>;
  static constexpr int BZ = MT, BY = kWarps;
  static constexpr int NCLS = MODE == 2 ? 8 : 1;    // parity classes
  using Hl = Halo<MODE, BZ, BY, T>;
  static constexpr int PS = pad_to(Hl::PLANE, 8);   // A loads: t*PS + g
  static constexpr int NW = 8 * NTB;                // channels per block
  static constexpr int NPS = weight_stride(NW);     // B loads: t*NPS + g
  // a chunk's staged input, CK planes of PS elements, in 4-byte words
  static constexpr int X_FLOATS = E::CK * PS * (int)sizeof(T) / 4;
  static constexpr int STAGE = X_FLOATS + 27 * kCiChunk * NPS;
  static constexpr size_t SMEM = 2 * STAGE * sizeof(float);
  static_assert(E::CK * sizeof(T) == 32, "a chunk is 32 bytes a position");
};

// One tap of one chunk: acc[mt][nt] += window(rz, ry, xc) x w[tap].
// (rz0, ry) is the halo-brick row of the warp's first tile for this tap,
// dz the row step between its tiles, xc the smem column of x position 0.
template <int MODE, int MT, int NTB, class T, int S>
__device__ __forceinline__ void tap_mma(float (&acc)[MT][NTB][S][4],
                                        const T* sx, const float* sw,
                                        int tap, int rz0, int dz, int ry,
                                        int xc, int g, int t) {
  using C = Cfg<MODE, MT, NTB, T>;
  using E = typename C::E;
  using Hl = typename C::Hl;
  typename E::B b[NTB];
#pragma unroll
  for (int nt = 0; nt < NTB; ++nt)
    b[nt] = E::load_b(sw + (tap * kCiChunk + t) * C::NPS + nt * 8 + g,
                      C::NPS);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const typename E::A a = E::load_a(
        sx + ((rz0 + mt * dz) * Hl::EY + ry) * Hl::XS + xc, C::PS, g, t);
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt) E::mma(acc[mt][nt], a, b[nt]);
  }
}

// Mode 0, one (ky, kx) for all kz: the warp's MT tiles sit at z = mt, so
// tile mt with tap kz reads halo row z = mt + kz. Each of the MT + 2 rows
// is loaded (and split) once and feeds every (mt, kz) that reads it.
template <int MT, int NTB, class T, int S>
__device__ __forceinline__ void s1_column(float (&part)[MT][NTB][S][4],
                                          const T* sx, const float* sw,
                                          int ky, int kx, int warp, int g,
                                          int t) {
  using C = Cfg<0, MT, NTB, T>;
  using E = typename C::E;
  using Hl = typename C::Hl;
  typename E::B b[3][NTB];
#pragma unroll
  for (int kz = 0; kz < 3; ++kz)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
      b[kz][nt] = E::load_b(
          sw + ((kz * 9 + ky * 3 + kx) * kCiChunk + t) * C::NPS + nt * 8 + g,
          C::NPS);
#pragma unroll
  for (int z = 0; z < MT + 2; ++z) {
    const typename E::A a = E::load_a(
        sx + (z * Hl::EY + warp + ky) * Hl::XS + Hl::xcol(kx), C::PS, g, t);
#pragma unroll
    for (int kz = 0; kz < 3; ++kz) {
      const int mt = z - kz;
      if (mt >= 0 && mt < MT) {
#pragma unroll
        for (int nt = 0; nt < NTB; ++nt) E::mma(part[mt][nt], a, b[kz][nt]);
      }
    }
  }
}

// The taps of parity class CLS (mode 2) into part, then flushed to acc.
template <int MT, int NTB, int CLS, class T, int S>
__device__ __forceinline__ void class_taps(float (&acc)[MT][NTB][4],
                                           float (&part)[MT][NTB][S][4],
                                           const T* sx, const float* sw,
                                           int warp, int g, int t) {
  constexpr int pz = CLS >> 2, py = (CLS >> 1) & 1, px = CLS & 1;
#pragma unroll
  for (int iz = 0; iz <= pz; ++iz) {
    int kz, oz;
    t2_tap(pz, iz, kz, oz);
#pragma unroll
    for (int iy = 0; iy <= py; ++iy) {
      int ky, oy;
      t2_tap(py, iy, ky, oy);
#pragma unroll
      for (int ix = 0; ix <= px; ++ix) {
        int kx, ox;
        t2_tap(px, ix, kx, ox);
        tap_mma<2, MT, NTB>(part, sx, sw, kz * 9 + ky * 3 + kx, oz, 1,
                            warp + oy, Cfg<2, MT, NTB, T>::Hl::xcol(ox), g,
                            t);
      }
    }
  }
  flush(acc, part);
}

// T: the element type of x, w and the staged operands; TO: of skip and
// out (float).
template <int MODE, int MT, int NTB, class T, class TO>
__global__ void __launch_bounds__(kThreads)
conv3d_tc(const T* __restrict__ x, const void* __restrict__ wt,
          const float* __restrict__ bias, const TO* __restrict__ skip,
          TO* __restrict__ out, int Ci, int Di, int Hi, int Wi, int Co,
          int Do, int Ho, int Wo, int relu, int nbz, int nby, int nbx,
          int vec) {
  using C = Cfg<MODE, MT, NTB, T>;
  using E = typename C::E;
  constexpr int S = E::S;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  int b = blockIdx.x;
  const int bx0 = (b % nbx) * kBX;
  b /= nbx;
  const int by0 = (b % nby) * C::BY;
  b /= nby;
  const int bz0 = (b % nbz) * C::BZ;
  const int n = b / nbz;
  const int co0 = blockIdx.y * C::NW;

  // acc: the float32 totals (one per parity class); part: the MMAs of at
  // most 9 taps, one accumulator per product of a step (3xTF32: 3), before
  // they are flushed into acc
  float acc[C::NCLS][MT][NTB][4], part[MT][NTB][S][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < S; ++k) part[mt][nt][k][i] = 0.f;
#pragma unroll
        for (int k = 0; k < C::NCLS; ++k) acc[k][mt][nt][i] = 0.f;
      }

  const int nch = (Ci + E::CK - 1) / E::CK;
  auto stage = [&](int ch) -> float* { return smem + (ch & 1) * C::STAGE; };
  auto load = [&](int ch) {
    float* s = stage(ch);
    load_halo<MODE, C::BZ, C::BY, C::PS>(reinterpret_cast<T*>(s), x, n,
                                         ch * E::CK, Ci, Di, Hi, Wi, bz0,
                                         by0, bx0, vec);
    load_weights<27, C::NW, C::NPS>(
        s + C::X_FLOATS,
        static_cast<const uint32_t*>(wt) +
            ((long long)blockIdx.y * nch + ch) * 27 * kCiChunk * C::NW);
    cp_async_commit();
  };

  load(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sx = reinterpret_cast<const T*>(stage(ch));
    const float* sw = stage(ch) + C::X_FLOATS;
    if constexpr (MODE == 0) {
      // s1: row z = mt + kz, y = warp + ky, x = r + kx; flush every 9 taps
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          s1_column<MT, NTB>(part, sx, sw, ky, kx, warp, g, t);
        flush(acc[0], part);
      }
    } else if constexpr (MODE == 1) {
      // s2: row z = 2 mt + kz, y = 2 warp + ky, x = 2 r + kx (parity half)
#pragma unroll 1
      for (int kz = 0; kz < 3; ++kz) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            tap_mma<MODE, MT, NTB>(part, sx, sw, kz * 9 + ky * 3 + kx, kz,
                                   2, 2 * warp + ky, C::Hl::xcol(kx), g, t);
          }
        }
        flush(acc[0], part);
      }
    } else {
      class_taps<MT, NTB, 0>(acc[0], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, 1>(acc[1], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, 2>(acc[2], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, 3>(acc[3], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, 4>(acc[4], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, 5>(acc[5], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, 6>(acc[6], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, 7>(acc[7], part, sx, sw, warp, g, t);
    }
    __syncthreads();
  }

  // epilogue: C fragment (row g / g + 8 = x position, col 2t / 2t + 1),
  // float32 throughout, rounded to TO at the store
#pragma unroll
  for (int cls = 0; cls < C::NCLS; ++cls) {
    const int pz = cls >> 2, py = (cls >> 1) & 1, px = cls & 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int bz = bz0 + mt, by = by0 + warp;
      const int oz = MODE == 2 ? 2 * bz + pz : bz;
      const int oy = MODE == 2 ? 2 * by + py : by;
      if (oz >= Do || oy >= Ho) continue;
#pragma unroll
      for (int nt = 0; nt < NTB; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bx = bx0 + g + ((i & 2) ? 8 : 0);
          const int ox = MODE == 2 ? 2 * bx + px : bx;
          const int co = co0 + nt * 8 + 2 * t + (i & 1);
          if (ox >= Wo || co >= Co) continue;
          const long long o =
              ((((long long)n * Co + co) * Do + oz) * Ho + oy) * Wo + ox;
          float r = acc[cls][mt][nt][i] + bias[co];
          if (relu) r = fmaxf(r, 0.f);
          if (skip != nullptr) r += to_f32(skip[o]);
          out[o] = from_f32<TO>(r);
        }
      }
    }
  }
}

template <int MODE, int MT, int NTB, class T, class TO>
cudaError_t launch(const T* x, const T* w, const float* bias, const TO* skip,
                   TO* out, void* wt, int N, int Ci, int Di, int Hi, int Wi,
                   int Co, int Do, int Ho, int Wo, int relu,
                   cudaStream_t stream) {
  using C = Cfg<MODE, MT, NTB, T>;
  static_assert(C::SMEM <= 227 * 1024, "shared memory per block");
  auto kern = conv3d_tc<MODE, MT, NTB, T, TO>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kern, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int bd = MODE == 2 ? Di : Do, bh = MODE == 2 ? Hi : Ho,
            bw = MODE == 2 ? Wi : Wo;
  const int nbz = (bd + C::BZ - 1) / C::BZ, nby = (bh + C::BY - 1) / C::BY,
            nbx = (bw + kBX - 1) / kBX;
  const long long bricks = (long long)N * nbz * nby * nbx;
  if (bricks <= 0 || bricks > 0x7fffffffLL) return cudaErrorInvalidValue;
  err = prep(w, wt, Ci, Co, 27, C::NW, stream);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)bricks, (unsigned)((Co + C::NW - 1) / C::NW));
  // four-element row vectors need rows of x aligned to a vector's bytes
  const int vec = C::Hl::VEC && Wi % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  kern<<<grid, kThreads, C::SMEM, stream>>>(x, wt, bias, skip, out, Ci, Di,
                                            Hi, Wi, Co, Do, Ho, Wo, relu,
                                            nbz, nby, nbx, vec);
  return cudaGetLastError();
}

// The tiles ops/conv3d.py's TILES lists for each mode: (MT, NTB).
template <int MODE, class T, class TO>
cudaError_t by_tile(int mt, int ntb, const T* x, const T* w,
                    const float* bias, const TO* skip, TO* out, void* wt,
                    int N, int Ci, int Di, int Hi, int Wi, int Co, int Do,
                    int Ho, int Wo, int relu, cudaStream_t s) {
#define CONV3D_TILE(M, B)                                                   \
  if (mt == M && ntb == B)                                                  \
    return launch<MODE, M, B>(x, w, bias, skip, out, wt, N, Ci, Di, Hi, Wi, \
                              Co, Do, Ho, Wo, relu, s);
  CONV3D_TILE(1, 1)
  CONV3D_TILE(1, 2)
  if constexpr (MODE != 2) {
    CONV3D_TILE(1, 4)
  }
  if constexpr (MODE != 1) {
    CONV3D_TILE(2, 1)
  }
  if constexpr (MODE == 0) {
    CONV3D_TILE(2, 2)
    CONV3D_TILE(4, 1)
  }
#undef CONV3D_TILE
  return cudaErrorInvalidValue;
}

template <class T, class TO>
cudaError_t by_mode(int mode, int mt, int ntb, const T* x, const T* w,
                    const float* bias, const TO* skip, TO* out, void* wt,
                    int N, int Ci, int Di, int Hi, int Wi, int Co, int Do,
                    int Ho, int Wo, int relu, cudaStream_t s) {
  switch (mode) {
    case 0: return by_tile<0>(mt, ntb, x, w, bias, skip, out, wt, N, Ci, Di,
                              Hi, Wi, Co, Do, Ho, Wo, relu, s);
    case 1: return by_tile<1>(mt, ntb, x, w, bias, skip, out, wt, N, Ci, Di,
                              Hi, Wi, Co, Do, Ho, Wo, relu, s);
    case 2: return by_tile<2>(mt, ntb, x, w, bias, skip, out, wt, N, Ci, Di,
                              Hi, Wi, Co, Do, Ho, Wo, relu, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 stride 1, 1 stride 2, 2 transposed (see above). skip may be null.
// mt, ntb: the block tile (rows of 16 x positions per warp, n8 channel
// tiles per block), one of ops/conv3d.py's TILES[mode]. wt: scratch for
// the prepared weights, ceil(Co / 8ntb) * ceil(Ci / 8) * 27 * 8 * 8ntb
// words.
extern "C" int conv3d_f32(const float* x, const float* w, const float* bias,
                          const float* skip, float* out, void* wt, int N,
                          int Ci, int Di, int Hi, int Wi, int Co, int Do,
                          int Ho, int Wo, int mode, int relu, int mt, int ntb,
                          void* stream) {
  return (int)by_mode(mode, mt, ntb, x, w, bias, skip, out, wt, N, Ci, Di,
                      Hi, Wi, Co, Do, Ho, Wo, relu, (cudaStream_t)stream);
}
