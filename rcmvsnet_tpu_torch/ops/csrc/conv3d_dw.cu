// Weight gradient of the cost-volume U-Net's 3x3x3 convolution (float32)
// on Hopper's tensor cores: a split-K GEMM
//   dW[co, (ci, k)] = sum over positions o of g[co, o] * x[ci, tap(o, k)]
// with M = Co (padded to 16 per m16 tile), N = 8 input channels per tap,
// K = positions.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_costreg_train.py
// _conv_dw (_dw_kernel), the weight half of conv_lanes_t's custom VJP.
// Modes and layouts are conv3d.cu's: x [N, Ci, Di, Hi, Wi]; g [N, Co, Do,
// Ho, Wo]; dw [Co, Ci, 27] (for mode 2 the caller transposes it back to
// the ConvTranspose3d layout [Ci, Co, 3, 3, 3]); partial [chunks, Co, Ci,
// 27] of scratch.
//
// Design. Pass 1: a block (8 warps) owns one 8-channel chunk of Ci
// (gridDim.y), one group of up to 64 output channels (four m16 tiles) and,
// in mode 2, one parity class (gridDim.z = classes x Co groups, the class
// fastest), and a run of consecutive bricks of base positions (gridDim.x:
// the split-K chunks ops/conv3d_train.dw_chunks plans). For Co <= 64 there
// is one group, in ceil(Co / 16) m16 tiles; for Co > 64 every group runs
// the four-tile instance and masks the rows past Co. Each block stages
// only its group's rows of g and writes only its group's rows of the
// partials; the chunk sum does not see the groups. For each brick it
// stages the brick of g (its Co group; in mode 2 the class's outputs
// 2*b + p) and the halo brick of x (tc_conv3d.cuh) in shared memory with
// cp.async (16-byte row vectors where the rows allow: x in modes 0 and 2,
// g in modes 0 and 1),
// the next brick loading while the tensor cores work on this one, and
// accumulates 3xTF32 m16n8k8 MMAs over the brick's positions in
// registers, flushed into float32 totals after every brick: in modes 0
// and 1 warp w owns taps w, w + 8, w + 16, w + 24; in mode 2 the class has
// T = 1, 2, 4 or 8 taps, each owned by 8 / T warps that split the brick's
// k8 steps and are summed in shared memory in a fixed order. Each block
// writes one partial [Co, 8 ci, its taps]. Pass 2 sums the chunks in
// order. No atomics: the result is the same bit for bit from run to run.
// x and g leave device memory once per brick (mode 2: once per class).
//
// Bound: as conv3d.cu, staging, fragment loads and the hi/lo splits at
// these widths, not HBM; the compute floor counts 3 TF32 products per
// multiply-add.
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_conv3d.cuh"

namespace {

using namespace tc;

constexpr int kCoGroup = 64;       // output channels a block owns: MT <= 4

template <int MODE, int MT>
struct DwCfg {
  static constexpr int BZ = 1, BY = MODE == 1 ? 4 : 8;   // dw_chunks' BRICK
  static constexpr int S = MT <= 2 ? 3 : 1;             // accumulators/MMA
  using Hl = Halo<MODE, BZ, BY>;
  static constexpr int P = BZ * BY * kBX;               // positions / brick
  static constexpr int KSTEPS = P / 8;
  static constexpr int PS = pad_to(Hl::PLANE, 4);       // B loads: g*PS + t
  static constexpr int PG = pad_to(P, 4);               // A loads: g*PG + t
  static constexpr int X_FLOATS = kCiChunk * PS;
  static constexpr int STAGE = X_FLOATS + 16 * MT * PG;
  static constexpr size_t SMEM = 2 * STAGE * sizeof(float);
};

// Stage g of the brick's positions (mode 2: outputs 2*b + p) for the
// group's channels co0 + co, co < 16 MT, into s[co][position]; zero past
// Co and outside the output. vec (modes 0
// and 1, rows of g 16-byte aligned): 4 vectors per row of 16 positions;
// else one row per half-warp, one float per lane.
template <int MODE, int MT>
__device__ __forceinline__ void load_g(float* s, const float* g, int n,
                                       int co0, int Co, int Do, int Ho,
                                       int Wo,
                                       int bz0, int by0, int bx0, int pz,
                                       int py, int px, bool vec) {
  using C = DwCfg<MODE, MT>;
  constexpr int rows = 16 * MT * C::BZ * C::BY;
  if (MODE != 2 && vec) {
    for (int e = threadIdx.x; e < 4 * rows; e += kThreads) {
      const int v = e & 3, r = e >> 2;
      const int ry = r % C::BY, rz = (r / C::BY) % C::BZ,
                co = r / (C::BY * C::BZ);
      const int oz = bz0 + rz, oy = by0 + ry, ox = bx0 + 4 * v;
      const int cg = co0 + co;
      const int nx =
          cg < Co && oz < Do && oy < Ho ? min(4, max(0, Wo - ox)) : 0;
      const float* src =
          nx ? g + ((((long long)n * Co + cg) * Do + oz) * Ho + oy) * Wo + ox
             : g;
      cp_async16(s + co * C::PG + (rz * C::BY + ry) * kBX + 4 * v, src,
                 4 * nx);
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rx = lane & 15;
  for (int r = 2 * warp + (lane >> 4); r < rows; r += 2 * kWarps) {
    const int ry = r % C::BY, rz = (r / C::BY) % C::BZ,
              co = r / (C::BY * C::BZ);
    const int oz = MODE == 2 ? 2 * (bz0 + rz) + pz : bz0 + rz;
    const int oy = MODE == 2 ? 2 * (by0 + ry) + py : by0 + ry;
    const int ox = MODE == 2 ? 2 * (bx0 + rx) + px : bx0 + rx;
    const int cg = co0 + co;
    const bool ok = cg < Co && oz < Do && oy < Ho && ox < Wo;
    const float* src =
        ok ? g + ((((long long)n * Co + cg) * Do + oz) * Ho + oy) * Wo + ox
           : g;
    cp_async4(s + co * C::PG + (rz * C::BY + ry) * kBX + rx, src, ok);
  }
}

// One k8 step of positions [p0, p0 + 8) for one tap:
// acc[mt] += g[mt tile, p0..] x x[tap window of p0.., 8 ci]. (rz, ry) is
// the halo row and xc the smem column of the step's first position.
template <int MODE, int MT>
__device__ __forceinline__ void step_mma(
    float (&acc)[MT][DwCfg<MODE, MT>::S][4], const uint32_t (&ah)[MT][4],
    const uint32_t (&al)[MT][4], const float* sx, int rz, int ry, int xc,
    int g, int t) {
  using C = DwCfg<MODE, MT>;
  using Hl = typename C::Hl;
  const float* bp = sx + g * C::PS + (rz * Hl::EY + ry) * Hl::XS + xc + t;
  uint32_t bh[2], bl[2];
  split_tf32(bp[0], bh[0], bl[0]);
  split_tf32(bp[4], bh[1], bl[1]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt], ah[mt], al[mt], bh, bl);
}

// A fragments (g) of k8 step p0 for every m16 tile, split hi/lo.
template <int MODE, int MT>
__device__ __forceinline__ void load_a(uint32_t (&ah)[MT][4],
                                       uint32_t (&al)[MT][4],
                                       const float* sg, int p0, int g,
                                       int t) {
  using C = DwCfg<MODE, MT>;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* ap = sg + (mt * 16 + g) * C::PG + p0 + t;
    split_tf32(ap[0], ah[mt][0], al[mt][0]);
    split_tf32(ap[8 * C::PG], ah[mt][1], al[mt][1]);
    split_tf32(ap[4], ah[mt][2], al[mt][2]);
    split_tf32(ap[8 * C::PG + 4], ah[mt][3], al[mt][3]);
  }
}

template <int MODE, int MT>
__global__ void __launch_bounds__(kThreads)
conv3d_dw_tc(const float* __restrict__ x, const float* __restrict__ gr,
             float* __restrict__ partial, int Ci, int Di, int Hi, int Wi,
             int Co, int Do, int Ho, int Wo, int nbz, int nby, int nbx,
             long long bricks, long long per_chunk, int vec_x, int vec_g) {
  using C = DwCfg<MODE, MT>;
  using Hl = typename C::Hl;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.y * kCiChunk;
  // gridDim.z = classes x Co groups, the class fastest
  const int cls = MODE == 2 ? blockIdx.z & 7 : 0;
  const int co0 = (MODE == 2 ? blockIdx.z >> 3 : blockIdx.z) * kCoGroup;
  const int pz = cls >> 2, py = (cls >> 1) & 1, px = cls & 1;
  // mode 2: T taps in the class, warp -> (tap ti, k-step group pg of npg)
  const int T = 1 << (pz + py + px);
  const int ti = warp % T, pg = warp / T, npg = kWarps / T;
  int kz2, oz2, ky2, oy2, kx2, ox2;
  {
    int bit = 0;
    t2_tap(pz, pz ? (ti >> bit++) & 1 : 0, kz2, oz2);
    t2_tap(py, py ? (ti >> bit++) & 1 : 0, ky2, oy2);
    t2_tap(px, px ? (ti >> bit++) & 1 : 0, kx2, ox2);
  }

  // acc: the float32 total; part: the MMAs of one brick (<= 48 products),
  // in C::S accumulators
  float acc[4][MT][4], part[4][MT][C::S][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[j][mt][i] = 0.f;
#pragma unroll
        for (int k = 0; k < C::S; ++k) part[j][mt][k][i] = 0.f;
      }

  const long long b_begin = (long long)blockIdx.x * per_chunk;
  const long long b_end =
      b_begin + per_chunk < bricks ? b_begin + per_chunk : bricks;
  const int nb = b_end > b_begin ? (int)(b_end - b_begin) : 0;
  auto stage = [&](int i) -> float* { return smem + (i & 1) * C::STAGE; };
  auto load = [&](int i) {
    long long b = b_begin + i;
    const int bx0 = (int)(b % nbx) * kBX;
    b /= nbx;
    const int by0 = (int)(b % nby) * C::BY;
    b /= nby;
    const int bz0 = (int)(b % nbz) * C::BZ;
    const int n = (int)(b / nbz);
    float* s = stage(i);
    load_halo<MODE, C::BZ, C::BY, C::PS>(s, x, n, c0, Ci, Di, Hi, Wi, bz0,
                                         by0, bx0, vec_x);
    load_g<MODE, MT>(s + C::X_FLOATS, gr, n, co0, Co, Do, Ho, Wo, bz0, by0,
                     bx0, pz, py, px, vec_g);
    cp_async_commit();
  };

  if (nb > 0) load(0);
  for (int i = 0; i < nb; ++i) {
    if (i + 1 < nb) {
      load(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = stage(i);
    const float* sg = sx + C::X_FLOATS;
    if (MODE != 2) {
#pragma unroll 1
      for (int ks = 0; ks < C::KSTEPS; ++ks) {
        const int p0 = ks * 8, row = p0 / kBX, xo = p0 % kBX;
        const int rzb = row / C::BY, ryb = row % C::BY;
        uint32_t ah[MT][4], al[MT][4];
        load_a<MODE, MT>(ah, al, sg, p0, g, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tap = warp + 8 * j;
          if (tap < 27) {
            const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
            // s1: input x = position + kx; s2: 2 * position + kx
            if (MODE == 0)
              step_mma<MODE, MT>(part[j], ah, al, sx, rzb + kz, ryb + ky,
                                 Hl::xcol(xo + kx), g, t);
            else
              step_mma<MODE, MT>(part[j], ah, al, sx, 2 * rzb + kz,
                                 2 * ryb + ky,
                                 (kx & 1) * Hl::XH + xo + (kx >> 1), g, t);
          }
        }
      }
    } else {
#pragma unroll 1
      for (int ks = pg; ks < C::KSTEPS; ks += npg) {
        const int p0 = ks * 8, row = p0 / kBX, xo = p0 % kBX;
        const int rzb = row / C::BY, ryb = row % C::BY;
        uint32_t ah[MT][4], al[MT][4];
        load_a<MODE, MT>(ah, al, sg, p0, g, t);
        step_mma<MODE, MT>(part[0], ah, al, sx, rzb + oz2, ryb + oy2,
                           Hl::xcol(xo + ox2), g, t);
      }
    }
    flush(acc, part);
    __syncthreads();
  }

  // D fragment: row g / g + 8 = co within the m16 tile, col 2t / 2t + 1 = ci
  float* out = partial + (long long)blockIdx.x * Co * Ci * 27;
  if (MODE != 2) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tap = warp + 8 * j;
      if (tap >= 27) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int co = co0 + mt * 16 + g + ((i & 2) ? 8 : 0);
          const int ci = c0 + 2 * t + (i & 1);
          if (co < Co && ci < Ci)
            out[((long long)co * Ci + ci) * 27 + tap] = acc[j][mt][i];
        }
    }
  } else {
    // sum the npg k-step groups of each tap in order 0, 1, ...
    constexpr int F = MT * 4 * 32;
    float* red = smem;                      // the staging buffers are free
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(pg * T + ti) * F + (mt * 4 + i) * 32 + lane] = acc[0][mt][i];
    __syncthreads();
    if (pg == 0) {
      const int tap = kz2 * 9 + ky2 * 3 + kx2;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = 0.f;
          for (int q = 0; q < npg; ++q)
            s += red[(q * T + ti) * F + (mt * 4 + i) * 32 + lane];
          const int co = co0 + mt * 16 + g + ((i & 2) ? 8 : 0);
          const int ci = c0 + 2 * t + (i & 1);
          if (co < Co && ci < Ci)
            out[((long long)co * Ci + ci) * 27 + tap] = s;
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sum_chunks(const float* __restrict__ partial, float* __restrict__ dw,
           int chunks, long long n_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[c * n_out + i];
  dw[i] = s;
}

template <int MODE, int MT>
cudaError_t launch(const float* x, const float* g, float* partial, float* dw,
                   int N, int Ci, int Di, int Hi, int Wi, int Co, int Do,
                   int Ho, int Wo, int chunks, long long per_chunk,
                   cudaStream_t s) {
  using C = DwCfg<MODE, MT>;
  static_assert(C::SMEM <= 227 * 1024, "shared memory per block");
  static_assert(MODE != 2 || 8 * MT * 4 * 32 <= 2 * C::STAGE,
                "mode 2 reduction fits the staging buffers");
  auto kern = conv3d_dw_tc<MODE, MT>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kern, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int bd = MODE == 2 ? Di : Do, bh = MODE == 2 ? Hi : Ho,
            bw = MODE == 2 ? Wi : Wo;
  const int nbz = (bd + C::BZ - 1) / C::BZ, nby = (bh + C::BY - 1) / C::BY,
            nbx = (bw + kBX - 1) / kBX;
  const long long bricks = (long long)N * nbz * nby * nbx;
  // the plan must cover every brick exactly once with `chunks` runs
  if (per_chunk < 1 || (long long)chunks * per_chunk < bricks ||
      (long long)(chunks - 1) * per_chunk >= bricks)
    return cudaErrorInvalidValue;
  const unsigned co_groups = (unsigned)((Co + kCoGroup - 1) / kCoGroup);
  dim3 grid((unsigned)chunks, (unsigned)((Ci + kCiChunk - 1) / kCiChunk),
            (MODE == 2 ? 8u : 1u) * co_groups);
  // 16-byte row vectors need 16-byte aligned rows
  const int vec_x = Wi % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_g = Wo % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  kern<<<grid, kThreads, C::SMEM, s>>>(x, g, partial, Ci, Di, Hi, Wi, Co, Do,
                                       Ho, Wo, nbz, nby, nbx, bricks,
                                       per_chunk, vec_x, vec_g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_out = (long long)Co * Ci * 27;
  sum_chunks<<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0,
               s>>>(partial, dw, chunks, n_out);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t by_mt(const float* x, const float* g, float* partial, float* dw,
                  int N, int Ci, int Di, int Hi, int Wi, int Co, int Do,
                  int Ho, int Wo, int chunks, long long per_chunk,
                  cudaStream_t s) {
  // Co > 64: groups of 64 channels, each in four m16 tiles
  switch (min((Co + 15) / 16, kCoGroup / 16)) {
    case 1: return launch<MODE, 1>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co,
                                   Do, Ho, Wo, chunks, per_chunk, s);
    case 2: return launch<MODE, 2>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co,
                                   Do, Ho, Wo, chunks, per_chunk, s);
    case 3: return launch<MODE, 3>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co,
                                   Do, Ho, Wo, chunks, per_chunk, s);
    case 4: return launch<MODE, 4>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co,
                                   Do, Ho, Wo, chunks, per_chunk, s);
    default: return cudaErrorInvalidValue;   // Co < 1
  }
}

}  // namespace

// mode: 0 stride 1, 1 stride 2, 2 transposed (conv3d.cu's modes).
// chunks x per_chunk: the split-K plan of ops/conv3d_train.dw_chunks
// (runs of per_chunk consecutive bricks, the last one shorter); brick_y,
// the plan's brick height, must be this build's. partial holds chunks x
// Co x Ci x 27 floats of scratch.
extern "C" int conv3d_dw_f32(const float* x, const float* g, float* partial,
                             float* dw, int N, int Ci, int Di, int Hi, int Wi,
                             int Co, int Do, int Ho, int Wo, int mode,
                             int chunks, long long per_chunk, int brick_y,
                             void* stream) {
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      if (brick_y != DwCfg<0, 1>::BY) return (int)cudaErrorInvalidValue;
      return (int)by_mt<0>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do, Ho,
                           Wo, chunks, per_chunk, s);
    case 1:
      if (brick_y != DwCfg<1, 1>::BY) return (int)cudaErrorInvalidValue;
      return (int)by_mt<1>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do, Ho,
                           Wo, chunks, per_chunk, s);
    case 2:
      if (brick_y != DwCfg<2, 1>::BY) return (int)cudaErrorInvalidValue;
      return (int)by_mt<2>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do, Ho,
                           Wo, chunks, per_chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
