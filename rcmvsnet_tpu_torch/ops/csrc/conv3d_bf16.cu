// 3x3x3 convolution of the cost-volume U-Net, bf16 (K2-bf16, the bf16
// eval and train paths): bf16 x, w and skip, float32 bias, one bf16
// product per multiply-add on the tensor cores, float32 accumulation,
// bias, ReLU and skip add, the output rounded to bf16 once (the prob head
// writes float32), as pallas_costreg.conv_lanes computes at compute_dtype
// bf16 (:356-379, the skip upcast and added before the output cast, :379).
//
// Replaces the TPU kernels rcmvsnet_tpu/ops/pallas_costreg.py conv_lanes
// (:383 -> pallas_call :469) and pallas_resample.py subsample_lanes /
// stuff_lanes (K3) at compute dtype bf16, as conv3d.cu does for float32:
// the same modes (0 stride 1, 1 stride 2, 2 transposed as 8 parity
// classes of the input grid, Do/Ho/Wo of 2 in - 1 allowed), the same
// epilogue and layouts (x [N, Ci, Di, Hi, Wi]; w [Co, Ci, 27]; bias [Co]
// float32; skip and out [N, Co, Do, Ho, Wo]), the same block tiles
// (ops/conv3d.py TILES: MT x 8 x 16 base positions, NTB n8 tiles of Co)
// and the same flush of the tensor cores' sums into float32 totals every
// <= 9 taps.
//
// Design: an implicit GEMM, M = output positions (a warp's m16 tiles are
// rows of 16 x positions), N = Co, K = Ci x 27 in chunks of CK channels
// a tap: CK = 16 (m16n8k16), or CK = 8 (m16n8k8) when Ci <= 8 in modes 0
// and 1 -- the full-resolution convs of every U-Net, which a 16-channel
// chunk would pad with zeros to twice their products and staged bytes.
// Per chunk the block stages its halo brick CHANNELS-LAST: CK channels,
// 2 CK bytes, a position, transposed from the channel planes of x in
// registers while staging (tc_bf16.cuh). An A fragment is then two loads
// (positions g and g + 8; CK = 16: 8 bytes, channels 4t..4t+3; CK = 8: 4
// bytes, channels 2t, 2t + 1) for every tap, where the float32 design's
// channel planes made it 8 16-bit loads packed by hand, once per tap and
// tile. A tap's x shift is a shift by whole positions, so no tap
// misaligns a load; stride-2 rows are stored as their even and odd
// inputs, so the 16 outputs of a tile read 16 consecutive positions. The
// weights are laid out once per call by prep_weights_bf16 as
// [group][chunk][tap][co][CK channels] and staged with 16-byte cp.async:
// a B fragment is one load. In mode 0 each halo row is loaded once per
// (ky, kx) and feeds every (tile, kz) that reads it. Two stages when Ci
// takes more than one chunk: the next chunk is staged while the tensor
// cores work on this one. The epilogue goes through shared memory, so
// that bias, ReLU, the skip and the output move as 16-byte vectors of 8
// consecutive x. A build of mode 0 on warpgroup MMAs (wgmma m64nNk16, A
// from these registers, the weights behind a descriptor) measured slower
// at N = Co = 8..32 (PERF.md section 6), so the products are mma.sync.
//
// Bound: the bytes of x, the skip and the output bound it at these
// widths (Ci, Co 1..64: 0.86 ms of bytes against 0.05 ms of bf16
// products a DTU map); what it pays beyond them is the halo (x re-read
// from L2 for 1.25-3 rows in y and z), the 8-element groups of the
// staged rows (32 inputs read for 18 used in s1), the A fragments' shared
// memory traffic (an m16 tile's A feeds NTB products, and up to 3 kz taps
// in mode 0), one barrier a chunk, and n8 tiles padded past Co (Co = 1:
// one column of 8). x is not staged by TMA: it goes from device memory
// through registers (the transpose) into shared memory in one pass, where
// a box would add a raw buffer of the halo and a second shared-memory
// pass; and at Ci <= 16, most of the U-Nets' convs, a block has one
// chunk, so there is no ring to keep full: co-resident blocks overlap
// each other's loads instead.
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_bf16.cuh"

namespace {

using namespace tcb;

template <int MODE, int MT, int NTB, int CK>
struct Cfg {
  static constexpr int BZ = MT, BY = kWarps;
  static constexpr int NCLS = MODE == 2 ? 8 : 1;
  static constexpr int EZ = MODE == 0 ? BZ + 2 : MODE == 1 ? 2 * BZ + 1
                                                           : BZ + 1;
  static constexpr int EY = MODE == 0 ? BY + 2 : MODE == 1 ? 2 * BY + 1
                                                           : BY + 1;
  // 8-input groups of a row read from device memory: s1 inputs bx0 - 8 ..
  // bx0 + 23, s2 2 bx0 - 8 .. 2 bx0 + 31, t2 bx0 .. bx0 + 23 (the end
  // inputs past the 16 under a brick row sit in the neighbouring 32-byte
  // sectors, so reading them alone saves no sector)
  static constexpr int NG = MODE == 2 ? 3 : MODE == 1 ? 5 : 4;
  // positions stored a row: s1 inputs bx0 - 1 .. bx0 + 16; s2 2 bx0 - 1 ..
  // 2 bx0 + 31 as 17 even then 16 odd ones; t2 bx0 .. bx0 + 16
  static constexpr int EX = MODE == 0 ? 18 : MODE == 1 ? 33 : 17;
  static constexpr int PW = CK / 2;                  // words a position
  static constexpr int HF = CK / 8;                  // 8-channel halves
  static constexpr int X_WORDS = EZ * EY * EX * PW;
  static constexpr int NW = 8 * NTB;                 // channels a block
  static constexpr int W_WORDS = 27 * NW * PW;
  static constexpr int STAGE = X_WORDS + W_WORDS;
  static constexpr int ITEMS = EZ * EY * NG * HF;    // (row, group, half)
  // the epilogue tile ep[cls][co][mt][y][16 x] in floats; a co's rows are
  // 4 (mod 32) words apart, so a fragment's stores fall on distinct banks
  static constexpr int CS = MT * BY * kBX + 4;
  static constexpr int EP = NCLS * NW * CS;
  static constexpr size_t SMEM =
      4 * (size_t)(2 * STAGE > EP ? 2 * STAGE : EP);
};

// Column of input rel (relative to the row's first group) in a stored
// row, or -1 when it is not stored.
template <int MODE>
__device__ __forceinline__ int x_col(int rel) {
  if (MODE == 0) return rel >= 7 && rel < 25 ? rel - 7 : -1;
  if (MODE == 2) return rel < 17 ? rel : -1;
  const int h = rel - 7;          // s2: halo index 0..32
  if (h < 0 || h > 32) return -1;
  return (h & 1) ? 17 + (h >> 1) : (h >> 1);
}

// Column of output x position j (0..15 of the brick row) at tap kx (t2:
// input offset ox)
template <int MODE>
__device__ __forceinline__ int tap_col(int j, int kx) {
  if (MODE == 1) return kx == 1 ? 17 + j : j + (kx >> 1);
  return j + kx;
}

// Stage channels [c0, c0 + CK) of the halo brick channels-last into s
// (words): item (row, group, half) reads 8 channels x 8 inputs and writes,
// for each stored input, the half (8 channels, 16 bytes) of its position.
template <int MODE, int MT, int NTB, int CK>
__device__ __forceinline__ void stage_x(uint32_t* s, const bf16* x, int n,
                                        int c0, int Ci, int Di, int Hi,
                                        int Wi, int bz0, int by0, int bx0,
                                        bool vec) {
  using C = Cfg<MODE, MT, NTB, CK>;
  const int iz0 = MODE == 0 ? bz0 - 1 : MODE == 1 ? 2 * bz0 - 1 : bz0;
  const int iy0 = MODE == 0 ? by0 - 1 : MODE == 1 ? 2 * by0 - 1 : by0;
  const int xg0 = MODE == 0 ? bx0 - 8 : MODE == 1 ? 2 * bx0 - 8 : bx0;
  const long long plane = (long long)Di * Hi * Wi;
  for (int e = threadIdx.x; e < C::ITEMS; e += kThreads) {
    const int gi = e % C::NG, hf = (e / C::NG) % C::HF;
    const int row = e / (C::HF * C::NG);           // hz * EY + hy
    const int gz = iz0 + row / C::EY, gy = iy0 + row % C::EY;
    const int cb = c0 + 8 * hf;                    // the half's channel 0
    const bool okr = gz >= 0 && gz < Di && gy >= 0 && gy < Hi && cb < Ci;
    const int x0 = xg0 + 8 * gi;
    const bf16* base =
        okr ? x + (((long long)n * Ci + cb) * Di + gz) * Hi * Wi +
                  (long long)gy * Wi
            : x;
    uint32_t v[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      load_span<1>(v[c], base + c * plane, x0, Wi, okr && cb + c < Ci,
                   vec);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int col = x_col<MODE>(8 * gi + p);
      if (col < 0) continue;
      const int sel = (p & 1) ? 0x7632 : 0x5410;
      uint32_t* d = s + (row * C::EX + col) * C::PW + 4 * hf;
      sts128(d, __byte_perm(v[0][p >> 1], v[1][p >> 1], sel),
             __byte_perm(v[2][p >> 1], v[3][p >> 1], sel),
             __byte_perm(v[4][p >> 1], v[5][p >> 1], sel),
             __byte_perm(v[6][p >> 1], v[7][p >> 1], sel));
    }
  }
}

template <int NTB, int CK>
__device__ __forceinline__ void load_b(typename Frag<CK>::B (&b)[NTB],
                                       const uint32_t* sw, int tap, int g,
                                       int t) {
#pragma unroll
  for (int nt = 0; nt < NTB; ++nt)
    b[nt] = Frag<CK>::load_b(sw, (tap * NTB + nt) * 8 + g, t);
}

template <int NTB, int CK>
__device__ __forceinline__ void mma_row(float (&part)[NTB][4],
                                        const typename Frag<CK>::A& a,
                                        const typename Frag<CK>::B (&b)[NTB]) {
#pragma unroll
  for (int nt = 0; nt < NTB; ++nt) Frag<CK>::mma(part[nt], a, b[nt]);
}

// The taps of parity class CLS (mode 2) into part, then flushed to acc.
template <int MT, int NTB, int CK, int CLS>
__device__ __forceinline__ void class_taps(float (&acc)[MT][NTB][4],
                                           float (&part)[MT][NTB][4],
                                           const uint32_t* sx,
                                           const uint32_t* sw, int warp,
                                           int g, int t) {
  using C = Cfg<2, MT, NTB, CK>;
  using F = Frag<CK>;
  constexpr int pz = CLS >> 2, py = (CLS >> 1) & 1, px = CLS & 1;
#pragma unroll
  for (int iz = 0; iz <= pz; ++iz) {
    int kz, oz;
    tc::t2_tap(pz, iz, kz, oz);
#pragma unroll
    for (int iy = 0; iy <= py; ++iy) {
      int ky, oy;
      tc::t2_tap(py, iy, ky, oy);
#pragma unroll
      for (int ix = 0; ix <= px; ++ix) {
        int kx, ox;
        tc::t2_tap(px, ix, kx, ox);
        typename F::B b[NTB];
        load_b<NTB, CK>(b, sw, kz * 9 + ky * 3 + kx, g, t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const typename F::A a = F::load_a(
              sx, ((mt + oz) * C::EY + warp + oy) * C::EX + tap_col<2>(g, ox),
              t);
          mma_row<NTB, CK>(part[mt], a, b);
        }
      }
    }
  }
  flush(acc, part);
}

// TO: the element type of skip and out (float for the prob head)
template <int MODE, int MT, int NTB, int CK, class TO>
__global__ void __launch_bounds__(kThreads)
conv3d_bf16_tc(const bf16* __restrict__ x, const uint32_t* __restrict__ wt,
               const float* __restrict__ bias, const TO* __restrict__ skip,
               TO* __restrict__ out, int Ci, int Di, int Hi, int Wi, int Co,
               int Do, int Ho, int Wo, int relu, int nbz, int nby, int nbx,
               int vec, int vec_out) {
  using C = Cfg<MODE, MT, NTB, CK>;
  using F = Frag<CK>;
  extern __shared__ __align__(16) uint32_t smem[];
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
  // most 9 taps before they are flushed into acc
  float acc[C::NCLS][MT][NTB][4], part[MT][NTB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[mt][nt][i] = 0.f;
#pragma unroll
        for (int k = 0; k < C::NCLS; ++k) acc[k][mt][nt][i] = 0.f;
      }

  const int nch = (Ci + CK - 1) / CK;
  auto stage = [&](int ch) -> uint32_t* { return smem + (ch & 1) * C::STAGE; };
  auto load = [&](int ch) {
    uint32_t* s = stage(ch);
    stage_w(s + C::X_WORDS,
            wt + ((long long)blockIdx.y * nch + ch) * C::W_WORDS, C::W_WORDS);
    tc::cp_async_commit();
    stage_x<MODE, MT, NTB, CK>(s, x, n, ch * CK, Ci, Di, Hi, Wi, bz0, by0,
                               bx0, vec);
  };

  load(0);
  for (int ch = 0; ch < nch; ++ch) {
    tc::cp_async_wait<0>();
    __syncthreads();
    if (ch + 1 < nch) load(ch + 1);
    const uint32_t* sx = stage(ch);
    const uint32_t* sw = sx + C::X_WORDS;
    if constexpr (MODE == 0) {
      // s1: tile mt, tap (kz, ky, kx) reads halo row z = mt + kz, y =
      // warp + ky, column x + kx; each row feeds every (mt, kz) reading it
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          typename F::B bk[3][NTB];
#pragma unroll
          for (int kz = 0; kz < 3; ++kz)
            load_b<NTB, CK>(bk[kz], sw, kz * 9 + ky * 3 + kx, g, t);
#pragma unroll
          for (int z = 0; z < MT + 2; ++z) {
            const typename F::A a =
                F::load_a(sx, (z * C::EY + warp + ky) * C::EX + g + kx, t);
#pragma unroll
            for (int kz = 0; kz < 3; ++kz) {
              const int mt = z - kz;
              if (mt >= 0 && mt < MT) mma_row<NTB, CK>(part[mt], a, bk[kz]);
            }
          }
        }
        flush(acc[0], part);
      }
    } else if constexpr (MODE == 1) {
      // s2: row z = 2 mt + kz, y = 2 warp + ky, column of input 2 x + kx - 1
#pragma unroll 1
      for (int kz = 0; kz < 3; ++kz) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            typename F::B bk[NTB];
            load_b<NTB, CK>(bk, sw, kz * 9 + ky * 3 + kx, g, t);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const typename F::A a = F::load_a(
                  sx,
                  ((2 * mt + kz) * C::EY + 2 * warp + ky) * C::EX +
                      tap_col<1>(g, kx),
                  t);
              mma_row<NTB, CK>(part[mt], a, bk);
            }
          }
        }
        flush(acc[0], part);
      }
    } else {
      class_taps<MT, NTB, CK, 0>(acc[0], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, CK, 1>(acc[1], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, CK, 2>(acc[2], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, CK, 3>(acc[3], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, CK, 4>(acc[4], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, CK, 5>(acc[5], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, CK, 6>(acc[6], part, sx, sw, warp, g, t);
      class_taps<MT, NTB, CK, 7>(acc[7], part, sx, sw, warp, g, t);
    }
  }

  // epilogue: C fragment (row g / g + 8 = x position, col 2t / 2t + 1),
  // + bias, ReLU, into ep[cls][co][mt][y][x] (float32); then 8 consecutive
  // output x a thread: + skip, rounded to TO, stored
  __syncthreads();
  float* ep = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int cls = 0; cls < C::NCLS; ++cls)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTB; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int co = nt * 8 + 2 * t + (i & 1);
          float r = acc[cls][mt][nt][i] +
                    (co0 + co < Co ? __ldg(bias + co0 + co) : 0.f);
          if (relu) r = fmaxf(r, 0.f);
          ep[(cls * C::NW + co) * C::CS + (mt * C::BY + warp) * kBX + g +
             ((i & 2) ? 8 : 0)] = r;
        }
  __syncthreads();
  // output rows (co, mt, y; t2: pz, py), each 16 x (t2: 32 x, px
  // interleaved) as vectors of 8
  constexpr int RV = MODE == 2 ? 4 : 2;          // vectors a row
  constexpr int ROWS = C::NW * MT * C::BY * (MODE == 2 ? 4 : 1);
  for (int e = threadIdx.x; e < ROWS * RV; e += kThreads) {
    const int v = e % RV;
    int r = e / RV;
    int pz = 0, py = 0;
    if (MODE == 2) {
      py = r & 1;
      pz = (r >> 1) & 1;
      r >>= 2;
    }
    const int y = r % C::BY, mt = (r / C::BY) % MT, co = r / (C::BY * MT);
    const int cg = co0 + co;
    const int oz = MODE == 2 ? 2 * (bz0 + mt) + pz : bz0 + mt;
    const int oy = MODE == 2 ? 2 * (by0 + y) + py : by0 + y;
    const int ox0 = (MODE == 2 ? 2 * bx0 : bx0) + 8 * v;
    if (cg >= Co || oz >= Do || oy >= Ho || ox0 >= Wo) continue;
    float val[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // output x ox0 + k: t2 class px = k & 1 at j = 4v + k / 2
      const int cls = MODE == 2 ? pz * 4 + py * 2 + (k & 1) : 0;
      const int j = MODE == 2 ? 4 * v + (k >> 1) : 8 * v + k;
      val[k] = ep[(cls * C::NW + co) * C::CS + (mt * C::BY + y) * kBX + j];
    }
    const long long o =
        ((((long long)n * Co + cg) * Do + oz) * Ho + oy) * Wo + ox0;
    if (vec_out && ox0 + 8 <= Wo) {
      if constexpr (sizeof(TO) == 2) {
        if (skip != nullptr) {
          const uint4 sv = __ldg(reinterpret_cast<const uint4*>(skip + o));
          const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int k = 0; k < 8; ++k)
            val[k] += __uint_as_float(
                (k & 1) ? sw[k >> 1] & 0xffff0000u : sw[k >> 1] << 16);
        }
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = tc::pack_bf16(tc::from_f32<bf16>(val[2 * k]),
                               tc::from_f32<bf16>(val[2 * k + 1]));
        *reinterpret_cast<uint4*>(out + o) = make_uint4(w[0], w[1], w[2],
                                                        w[3]);
      } else {
        if (skip != nullptr)
#pragma unroll
          for (int k = 0; k < 8; ++k) val[k] += skip[o + k];
        float4* d = reinterpret_cast<float4*>(out + o);
        d[0] = make_float4(val[0], val[1], val[2], val[3]);
        d[1] = make_float4(val[4], val[5], val[6], val[7]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (ox0 + k >= Wo) break;
        float r = val[k];
        if (skip != nullptr) r += tc::to_f32(skip[o + k]);
        out[o + k] = tc::from_f32<TO>(r);
      }
    }
  }
}

// The weights laid out once per call: wt[group][chunk][tap][co NW][CK / 2
// words], word k of a (tap, co) holding channels chunk * CK + 2k, + 1
// (low half first), zero past Co and Ci, from w [Co, Ci, 27].
__global__ void __launch_bounds__(kThreads)
prep_weights_bf16(const bf16* __restrict__ w, uint32_t* __restrict__ wt,
                  int Ci, int Co, int NW, int CK, int nch,
                  long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int pw = CK / 2;
  long long r = i / (NW * pw);
  const int word = (int)(i - r * NW * pw);
  const int col = word / pw, c = 2 * (word % pw);
  const int tap = (int)(r % 27);
  r /= 27;
  const int ch = (int)(r % nch), grp = (int)(r / nch);
  wt[i] = tc::weight_word(w, grp * NW + col, ch * CK + c, Ci, Co, 27, tap);
}

template <int MODE, int MT, int NTB, int CK, class TO>
cudaError_t launch(const bf16* x, const bf16* w, const float* bias,
                   const TO* skip, TO* out, void* wt, int N, int Ci, int Di,
                   int Hi, int Wi, int Co, int Do, int Ho, int Wo, int relu,
                   cudaStream_t stream) {
  using C = Cfg<MODE, MT, NTB, CK>;
  static_assert(C::SMEM <= 227 * 1024, "shared memory per block");
  auto kern = conv3d_bf16_tc<MODE, MT, NTB, CK, TO>;
  static bool smem_set = false;
  cudaError_t err = tc::allow_smem(kern, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int bd = MODE == 2 ? Di : Do, bh = MODE == 2 ? Hi : Ho,
            bw = MODE == 2 ? Wi : Wo;
  const int nbz = (bd + C::BZ - 1) / C::BZ, nby = (bh + C::BY - 1) / C::BY,
            nbx = (bw + kBX - 1) / kBX;
  const long long bricks = (long long)N * nbz * nby * nbx;
  if (bricks <= 0 || bricks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int groups = (Co + C::NW - 1) / C::NW, nch = (Ci + CK - 1) / CK;
  const long long words = (long long)groups * nch * C::W_WORDS;
  prep_weights_bf16<<<(unsigned)((words + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(
      w, static_cast<uint32_t*>(wt), Ci, Co, C::NW, CK, nch,
      words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)bricks, (unsigned)groups);
  // 16-byte row vectors need rows of x, skip and out aligned to them
  const int vec = Wi % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_out =
      Wo % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(skip) % 16 == 0;
  // one stage when Ci takes one chunk
  const size_t stages = (nch > 1 ? 2 : 1) * C::STAGE * sizeof(uint32_t);
  const size_t smem = stages > 4 * (size_t)C::EP ? stages : 4 * C::EP;
  kern<<<grid, kThreads, smem, stream>>>(
      x, static_cast<const uint32_t*>(wt), bias, skip, out, Ci, Di, Hi, Wi,
      Co, Do, Ho, Wo, relu, nbz, nby, nbx, vec, vec_out);
  return cudaGetLastError();
}

// CK = 8 for Ci <= 8 in modes 0 and 1, else 16
template <int MODE, int MT, int NTB, class TO>
cudaError_t by_ck(const bf16* x, const bf16* w, const float* bias,
                  const TO* skip, TO* out, void* wt, int N, int Ci, int Di,
                  int Hi, int Wi, int Co, int Do, int Ho, int Wo, int relu,
                  cudaStream_t s) {
  if constexpr (MODE != 2) {
    if (Ci <= 8)
      return launch<MODE, MT, NTB, 8>(x, w, bias, skip, out, wt, N, Ci, Di,
                                      Hi, Wi, Co, Do, Ho, Wo, relu, s);
  }
  return launch<MODE, MT, NTB, 16>(x, w, bias, skip, out, wt, N, Ci, Di, Hi,
                                   Wi, Co, Do, Ho, Wo, relu, s);
}

// The tiles ops/conv3d.py's TILES lists for each mode: (MT, NTB).
template <int MODE, class TO>
cudaError_t by_tile(int mt, int ntb, const bf16* x, const bf16* w,
                    const float* bias, const TO* skip, TO* out, void* wt,
                    int N, int Ci, int Di, int Hi, int Wi, int Co, int Do,
                    int Ho, int Wo, int relu, cudaStream_t s) {
#define CONV3D_TILE(M, B)                                                  \
  if (mt == M && ntb == B)                                                 \
    return by_ck<MODE, M, B>(x, w, bias, skip, out, wt, N, Ci, Di, Hi, Wi, \
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

}  // namespace

// mode: 0 stride 1, 1 stride 2, 2 transposed. x, w bf16; bias float32;
// skip and out bf16, or with out_f32 (mode 0 only: the prob head) out
// float32 and no skip. mt, ntb: the block tile, one of ops/conv3d.py's
// TILES[mode]. wt: scratch for the prepared weights, ceil(Co / 8ntb) *
// ceil(Ci / 16) * 27 * 8 * 8ntb words (Ci <= 8 in modes 0 and 1 uses half).
extern "C" int conv3d_bf16(const bf16* x, const bf16* w, const float* bias,
                           const void* skip, void* out, void* wt, int N,
                           int Ci, int Di, int Hi, int Wi, int Co, int Do,
                           int Ho, int Wo, int mode, int relu, int out_f32,
                           int mt, int ntb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (out_f32) {
    if (mode != 0 || skip != nullptr) return (int)cudaErrorInvalidValue;
    return (int)by_tile<0>(mt, ntb, x, w, bias,
                           static_cast<const float*>(nullptr),
                           static_cast<float*>(out), wt, N, Ci, Di, Hi, Wi,
                           Co, Do, Ho, Wo, relu, s);
  }
  const bf16* sk = static_cast<const bf16*>(skip);
  bf16* o = static_cast<bf16*>(out);
  switch (mode) {
    case 0: return (int)by_tile<0>(mt, ntb, x, w, bias, sk, o, wt, N, Ci, Di,
                                   Hi, Wi, Co, Do, Ho, Wo, relu, s);
    case 1: return (int)by_tile<1>(mt, ntb, x, w, bias, sk, o, wt, N, Ci, Di,
                                   Hi, Wi, Co, Do, Ho, Wo, relu, s);
    case 2: return (int)by_tile<2>(mt, ntb, x, w, bias, sk, o, wt, N, Ci, Di,
                                   Hi, Wi, Co, Do, Ho, Wo, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
