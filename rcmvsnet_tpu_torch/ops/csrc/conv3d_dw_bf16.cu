// Weight gradient of the cost-volume U-Net's 3x3x3 convolution, bf16
// (K8dw-bf16, the bf16 train path): x and g bf16 (the caller rounds a
// float32 cotangent, the prob head's, to bf16 first, as _dw_kernel casts
// its masked cotangent to the compute dtype,
// pallas_costreg_train.py:197-203), dW float32.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_costreg_train.py
// _conv_dw (_dw_kernel, :163 -> pallas_call :258) at compute dtype bf16.
// Modes and layouts are conv3d.cu's: x [N, Ci, Di, Hi, Wi]; g [N, Co, Do,
// Ho, Wo]; dw [Co, Ci, 27] (for mode 2 the caller transposes it back to
// the ConvTranspose3d layout); partial [chunks, Co, Ci, 27] of scratch.
//
// The GEMM, oriented for narrow Co:
//   dW^T[(ci, tap), co] = sum over positions p of x[ci, tap(p)] * g[co, p]
// M = Ci x 27 (A = x, im2col'd while staging), N = Co (B = g), K =
// positions. An m16 tile is one octet of input channels at two taps:
// rows 0-7 channels c0..c0+7 at tap a, rows 8-15 the same channels at tap
// b; the 27 taps pair into 14 tiles an octet (the last half empty). In
// the transposed mode ("t2") a tile's two taps belong to one parity class
// (its B is that class's outputs 2b + p); the classes' 1, 2, 2, 4, 2, 4,
// 4, 8 taps also pair into 14 tiles, and a block runs all 8 classes of
// its bricks, so x is staged once for all of them. Co = 8, every
// full-resolution level of the U-Nets, is one n8 tile with no padding;
// wider Co is more n8 tiles. m16n8k16 mma.sync with bf16 operands, one
// product per multiply-add, float32 accumulation.
//
// Staging: per brick of base positions (BZ x BY x 16: s1 4 x 8 x 16, s2
// 2 x 4 x 16, t2 1 x 8 x 16; the base grid is the output, t2's the input;
// ops/conv3d_train.BRICK_BF16) the block reads, for its octet, the halo
// rows of x as one TMA box, [8 ci][EZ z][EY y][2 RW inputs] from input
// XV - 8 (s1 XV = bx0, s2 2 bx0; t2 from bx0: a box starts on a 16-byte
// boundary of a row), zero past the volume's ends, and the brick's g rows
// of its Co tiles with 16-byte cp.async, into a ring of four slots (three
// where four do not fit), NS - 1 bricks ahead; one thread issues the
// box and slot s's mbarrier counts its bytes. (Rows not 16-byte aligned,
// W % 8 != 0, are read element by element into the same layout.) A
// transform pass then writes the kx-shifted copies of every halo row --
// copy kx of row (ci, z, y) holds the 16 inputs that brick positions
// 0..15 read at tap kx (s1: x + kx - 1; s2: 2x + kx - 1, so the stride-2
// gather is done here; t2: x + ox, ox = 0, 1), made with byte permutes
// in registers (a one-element shift cannot be a copy-engine copy) --
// and, t2, splits each row of 32 outputs of g into its two x classes.
// Every A and B word is then one aligned half of an 8-byte load for every
// tap and both strides (the float32 kernel packs them element by
// element). Two barriers a brick: brick i landed, its copies written.
//
// Work: a block owns one run of consecutive bricks (the split-K chunk,
// gridDim.x), 14 m16 tiles of one octet (Co <= 8) or 7 of them and two
// n8 tiles of Co (gridDim.y, gridDim.z): the plan ops/conv3d_train.
// dw_plan_bf16 sizes the runs by all three. A warp owns BZ x BY / 8 brick
// rows (k16 steps: s1 four, row y of each z; s2 and t2 one) for every
// tile of the block; it loads 7 (Co > 8: 4) tiles' A fragments and
// issues their MMAs before adding the sums, so the MMAs of a warp
// overlap. Each tile's chain in the tensor cores is its brick rows (one
// to four MMAs), added into a float32 total with round-to-nearest: the
// two-level flush of tc_conv3d.cuh, once a brick. An empty tile half (tap
// 27; t2's classes of odd tap counts) reads a row of zeros. At the end of
// its run the block sums its 8 warps' totals in order in shared memory
// and writes its part of one partial; pass 2 sums the chunks in a fixed
// order. No atomics: the result is the same bit for bit from run to run.
//
// Bound: the bytes of x and g (read once) bound it (0.37 ms for the 43
// shapes of a bf16 train step against 0.05 ms of bf16 products). What it
// pays beyond them is shared memory: each m16n8k16 product reads a fresh
// 512-byte A fragment (at Co = 8 it feeds one n8 tile), 2 8-byte loads a
// lane, and the staging writes the halo 3 times over (the copies); x is
// re-read from L2 for the halo (1.5 z rows and 1.25 y rows a row in s1,
// and the box's inputs past the taps' reach) and once per Co block; one
// block an SM (its ring) waits on two barriers a brick. A build on
// warpgroup MMAs (wgmma m64nNk16: A, four warps' m16 tiles, from
// registers; B, a brick row of g, through a descriptor) measured slower
// at these widths (PERF.md section 6): at N = Co = 8 its A fragments
// cost the same shared-memory loads and each step's products wait on
// them. Co = 1 (the prob head) uses one of 8 MMA columns.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_bf16.cuh"

namespace {

using namespace tcb;

constexpr int kTiles = 14;       // m16 tiles of one octet of Ci

// The brick of base positions, BZ x BY x 16 (ops/conv3d_train.BRICK_BF16):
// R = BZ x BY rows of 16 positions (k16 steps), KW = R / 8 of them a warp.
template <int MODE>
struct DwB {
  static constexpr int BZ = MODE == 0 ? 4 : MODE == 1 ? 2 : 1;
  static constexpr int BY = MODE == 1 ? 4 : 8;
  static constexpr int R = BZ * BY;
  static constexpr int KW = R / kWarps;
  static_assert(KW * kWarps == R, "whole rows a warp");
  // halo rows in z and y
  static constexpr int EZ = MODE == 0 ? BZ + 2 : MODE == 1 ? 2 * BZ + 1
                                                           : BZ + 1;
  static constexpr int EY = MODE == 0 ? BY + 2 : MODE == 1 ? 2 * BY + 1
                                                           : BY + 1;
  static constexpr int NCP = MODE == 2 ? 2 : 3;      // x copies (kx, ox)
  // a raw x row: NV 16-byte vectors from input XV (s1 bx0, s2 2 bx0, t2
  // bx0) and the 4-byte pairs of inputs XV - 2, - 1 (LO: s1, s2) and XV +
  // 16, + 17 (HI: s1, t2), the inputs the taps read beyond the vectors
  static constexpr int NV = MODE == 1 ? 4 : 2;
  static constexpr bool LO = MODE != 2, HI = MODE != 1;
  // the row as one span of words from input XV - 2 LO
  static constexpr int NW = 4 * NV + LO + HI;
  // a raw row as staged: RW words from input XV - 8 LO (one TMA box row:
  // a box starts on a 16-byte boundary of the row), an odd number of
  // 16-byte units; span word k is raw word k + SW
  static constexpr int SW = LO ? 3 : 0;
  static constexpr int RW = ((SW + NW + 3) / 4 | 1) * 4;
  static constexpr int NVG = MODE == 2 ? 4 : 2;      // g span
  // 32-byte rows a channel plane of copies: = 1 (mod 4), so the 8-byte
  // loads of four planes (one half-warp) fall on distinct banks
  static constexpr int PR = EZ * EY + ((1 - EZ * EY % 4) + 4) % 4;
  static constexpr int P = R * kBX;                  // positions a brick
  static constexpr int PG = P + 16;                  // g row: 32 (mod 128) B
  static constexpr int X_WORDS = NCP * 8 * PR * 8;
  static constexpr int X_ITEMS = 8 * EZ * EY;        // raw x rows
  // a k-step of a warp's second row: the next halo z (s1) or row of g
  static constexpr int A_STEP = (MODE == 1 ? 2 : 1) * EY * 8;   // words
  static constexpr int B_STEP = kWarps * kBX / 2;               // words
};

template <int MODE, int MW, int NB>
struct DwK {
  using Bs = DwB<MODE>;
  static_assert(MW == 7 || MW == 14, "a block's tiles split an octet");
  static constexpr int G_ITEMS = NB * 8 * Bs::R * (MODE == 2 ? 4 : 1);
  // a ring slot: the brick's raw x rows ([ci][hz][hy][RW words], the
  // TMA box; RW / 4 is odd, so the transform's 16-byte loads of 8
  // consecutive rows fall on distinct banks) and its raw g rows (s1, s2:
  // already the compute layout [co][row][16] with co stride PG; t2: whole
  // rows of 32 outputs, 5 vectors apart)
  static constexpr int RAWX = Bs::X_ITEMS * Bs::RW;
  static constexpr int RGS = 4 * (Bs::NVG | 1);
  static constexpr int RAWG = MODE == 2 ? G_ITEMS * RGS : NB * 8 * Bs::PG / 2;
  static constexpr int SLOT = RAWX + RAWG;
  static_assert(RAWX % 32 == 0 && SLOT % 32 == 0, "TMA boxes 128-B aligned");
  // the copies of the brick being computed (t2: and its g by class), and
  // zeros that an empty tile half reads (KW rows of them)
  static constexpr int G_WORDS = MODE == 2 ? 8 * NB * 8 * Bs::PG / 2 : 0;
  static constexpr int ZERO = Bs::KW * Bs::A_STEP;
  static constexpr int WORK = Bs::X_WORDS + G_WORDS + ZERO;
  static constexpr int RED = kWarps * MW * NB * 4 * 32;        // floats
  static constexpr int ring(int ns) { return ns * SLOT + WORK; }
  static constexpr int NS = 4 * ring(4) <= 200 * 1024 ? 4 : 3;  // ring
  static_assert(RED <= NS * SLOT, "the sums leave the mbarriers alone");
  // the ring's mbarriers (8 bytes each) after the copies
  static constexpr int MBAR = ring(NS);
  static constexpr int WORDS = MBAR + 2 * NS;
  static constexpr size_t SMEM = 4 * (size_t)WORDS + 128;   // + alignment
  // MMAs issued before their sums are added: G tiles at a time
  static constexpr int G = NB == 1 ? 7 : 4;
};

// Elements [x0, x0 + 2 N) of a row of bf16 (any x0) as N words, element
// by element, zero outside [0, W) and everywhere when !ok
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N], const bf16* row,
                                           int x0, int W, bool ok) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int x = x0 + 2 * i;
    const uint32_t lo = ok && x >= 0 && x < W ? r[x] : 0u;
    const uint32_t hi = ok && x + 1 >= 0 && x + 1 < W ? r[x + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
}

// Tap i of t2 parity class c, in the order of tc::t2_tap's bits (z first)
__device__ __forceinline__ void t2_class_tap(int c, int i, int& k, int& oz,
                                             int& oy, int& ox) {
  const int pz = c >> 2, py = (c >> 1) & 1, px = c & 1;
  int bit = 0, kz, ky, kx;
  tc::t2_tap(pz, pz ? (i >> bit++) & 1 : 0, kz, oz);
  tc::t2_tap(py, py ? (i >> bit++) & 1 : 0, ky, oy);
  tc::t2_tap(px, px ? (i >> bit++) & 1 : 0, kx, ox);
  k = kz * 9 + ky * 3 + kx;
}

// Half h (rows 8h..8h+7) of tile q for brick row (rz, ry): its tap (-1:
// empty), x copy, halo row (hz, hy) and parity class (t2; else 0).
template <int MODE>
__device__ __forceinline__ int tile_half(int q, int h, int rz, int ry,
                                         int& cp, int& hz, int& hy,
                                         int& cls) {
  cls = 0;
  if (MODE != 2) {
    const int tap = 2 * q + h;
    if (tap >= 27) return -1;
    const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
    cp = kx;
    hz = (MODE == 0 ? rz : 2 * rz) + kz;
    hy = (MODE == 0 ? ry : 2 * ry) + ky;
    return tap;
  }
  // classes 0..7 take (1 << popcount) taps: 1, 1, 1, 2, 1, 2, 2, 4 tiles
  int c = 0, start = 0;
  for (; c < 7; ++c) {
    const int n = ((1 << __popc(c)) + 1) >> 1;
    if (q < start + n) break;
    start += n;
  }
  const int i = 2 * (q - start) + h;
  cls = c;
  if (i >= (1 << __popc(c))) return -1;
  int k, oz, oy, ox;
  t2_class_tap(c, i, k, oz, oy, ox);
  cp = ox;
  hz = rz + oz;
  hy = ry + oy;
  return k;
}

// The ring's mbarriers: one arrival a phase (the thread that issues the
// brick's TMA box) and the box's bytes
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// x's box [8 ci][EZ][EY][RW words] at (input x0, y0, z0, channel c0, n),
// zero past the volume's ends, its completion counted by mbarrier bar
__device__ __forceinline__ void tma_box(uint32_t dst, uint64_t map,
                                        uint32_t bar, uint32_t bytes, int x0,
                                        int y0, int z0, int c0, int n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(x0), "r"(y0),
      "r"(z0), "r"(c0), "r"(n)
      : "memory");
}

template <int MODE, int MW, int NB>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_dw_bf16_tc(const __grid_constant__ CUtensorMap xmap,
                  const bf16* __restrict__ x, const bf16* __restrict__ gr,
                  float* __restrict__ partial, int Ci, int Di, int Hi,
                  int Wi, int Co, int Do, int Ho, int Wo, int nbz, int nby,
                  int nbx, long long bricks, long long per_chunk,
                  int qblocks, int tma_x, int vec_g) {
  using K = DwK<MODE, MW, NB>;
  using Bs = DwB<MODE>;
  // TMA boxes land at 128-byte aligned shared addresses
  extern __shared__ __align__(128) uint32_t smem_raw[];
  uint32_t* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127) / 4;
  const uint32_t mbar = smem_addr(smem + K::MBAR);  // slot s: mbar + 8 s
  // the tensor map where it lies, in the kernel's parameters
  const uint64_t xmap_at = reinterpret_cast<uint64_t>(&xmap);
  uint32_t* work = smem + K::NS * K::SLOT;   // copies (+ t2: g by class)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the warp's brick rows: (rz, ry) and, KW = 2, (rz + 1, ry)
  const int rz = MODE == 1 ? warp / Bs::BY : 0, ry = warp % Bs::BY;
  const int c0 = (blockIdx.y / qblocks) * 8;
  const int q0 = (blockIdx.y % qblocks) * MW;
  const int co0 = blockIdx.z * NB * 8;

  // the warp's tiles q0 + mt: A word offsets of both halves in the
  // copies (lane's channel g, elements 4t..4t+3; an empty half reads
  // zeros) and the B offset of the tile's class (t2)
  int offA[MW][2], offG[MW];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int cp = 0, hz = 0, hy = 0, cls = 0;
      const int tap = tile_half<MODE>(q0 + mt, h, rz, ry, cp, hz, hy, cls);
      if (h == 0) offG[mt] = cls * NB * 8 * Bs::PG / 2;
      offA[mt][h] =
          tap < 0 ? Bs::X_WORDS + K::G_WORDS + 2 * t
                  : ((cp * 8 + g) * Bs::PR + hz * Bs::EY + hy) * 8 + 2 * t;
    }
  }
  const int offB = (g * Bs::PG + (rz * Bs::BY + ry) * kBX + 4 * t) / 2;
  for (int i = threadIdx.x; i < K::ZERO; i += kThreads)
    work[Bs::X_WORDS + K::G_WORDS + i] = 0u;
  if (tma_x && threadIdx.x == 0) {
    for (int s = 0; s < K::NS; ++s) mbar_init(mbar + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[MW][NB][4];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nb][i] = 0.f;

  const long long b_begin = (long long)blockIdx.x * per_chunk;
  const long long b_end =
      b_begin + per_chunk < bricks ? b_begin + per_chunk : bricks;
  const int nbk = b_end > b_begin ? (int)(b_end - b_begin) : 0;

  // Read brick i's raw rows into ring slot s: x as one TMA box where its
  // rows allow (zero-filled outside the volume), g a row a thread with
  // 16-byte cp.async; else element by element (plain loads and stores,
  // visible after the barrier that follows).
  auto issue = [&](int i, uint32_t* s) {
    long long b = b_begin + i;
    const int bx0 = (int)(b % nbx) * kBX;
    b /= nbx;
    const int by0 = (int)(b % nby) * Bs::BY;
    b /= nby;
    const int bz0 = (int)(b % nbz) * Bs::BZ;
    const int n = (int)(b / nbz);
    // the halo's first input row, column and plane
    const int x0 = (MODE == 1 ? 2 * bx0 : bx0) - 8 * Bs::LO;
    const int y0 = MODE == 0 ? by0 - 1 : MODE == 1 ? 2 * by0 - 1 : by0;
    const int z0 = MODE == 0 ? bz0 - 1 : MODE == 1 ? 2 * bz0 - 1 : bz0;
    if (tma_x) {
      // one box a brick, issued by one thread; mbarrier i % NS counts it
      if (threadIdx.x == 0)
        tma_box(smem_addr(s), xmap_at, mbar + 8 * (i % K::NS), 4 * K::RAWX,
                x0, y0, z0, c0, n);
    } else {
      // rows not 16-byte aligned: element by element into the same
      // layout (plain stores, visible after the barrier that follows)
      for (int e = threadIdx.x; e < Bs::X_ITEMS; e += kThreads) {
        const int ci = e / (Bs::EZ * Bs::EY), hz = (e / Bs::EY) % Bs::EZ,
                  hy = e % Bs::EY;
        const int gz = z0 + hz, gy = y0 + hy;
        const bool okr = c0 + ci < Ci && gz >= 0 && gz < Di && gy >= 0 &&
                         gy < Hi;
        const bf16* row =
            okr ? x + (((long long)n * Ci + c0 + ci) * Di + gz) * Hi * Wi +
                      (long long)gy * Wi
                : x;
        uint32_t w[Bs::RW];
        load_words(w, row, x0, Wi, okr);
        uint32_t* d = s + e * Bs::RW;
#pragma unroll
        for (int k = 0; k < Bs::RW; k += 4)
          sts128(d + k, w[k], w[k + 1], w[k + 2], w[k + 3]);
      }
    }
    for (int e = threadIdx.x; e < K::G_ITEMS; e += kThreads) {
      // g row e: (co, brick row rz, ry[, pz, py]) and its first output x
      int co, oz, oy, gx0;
      uint32_t* d;
      if (MODE != 2) {
        co = e / Bs::R;
        const int rr = e % Bs::R;
        oz = bz0 + rr / Bs::BY;
        oy = by0 + rr % Bs::BY;
        gx0 = bx0;
        d = s + K::RAWX + (co * Bs::PG + rr * kBX) / 2;
      } else {
        co = e / (4 * Bs::R);
        const int rem = e % (4 * Bs::R);
        oz = 2 * bz0 + ((rem >> 1) & 1);
        oy = 2 * (by0 + (rem >> 2)) + (rem & 1);
        gx0 = 2 * bx0;
        d = s + K::RAWX + e * K::RGS;
      }
      const int cg = co0 + co;
      const bool okr = cg < Co && oz < Do && oy < Ho;
      const bf16* row =
          okr ? gr + (((long long)n * Co + cg) * Do + oz) * Ho * Wo +
                    (long long)oy * Wo
              : gr;
      if (vec_g) {
#pragma unroll
        for (int k = 0; k < Bs::NVG; ++k) {
          const int xs = gx0 + 8 * k;
          const bool in = okr && xs < Wo;
          tc::cp_async16(reinterpret_cast<float*>(d + 4 * k),
                         reinterpret_cast<const float*>(in ? row + xs : gr),
                         in ? 16 : 0);
        }
      } else {
        uint32_t w[4 * Bs::NVG];
        load_span<Bs::NVG>(w, row, gx0, Wo, okr, false);
#pragma unroll
        for (int k = 0; k < Bs::NVG; ++k)
          sts128(d + 4 * k, w[4 * k], w[4 * k + 1], w[4 * k + 2],
                 w[4 * k + 3]);
      }
    }
  };

  // The raw x rows of slot s into the kx-shifted copies; t2: the raw g
  // rows into the 8 classes' rows.
  auto transform = [&](const uint32_t* s) {
    for (int e = threadIdx.x; e < Bs::X_ITEMS; e += kThreads) {
      const int ci = e / (Bs::EZ * Bs::EY), hz = (e / Bs::EY) % Bs::EZ,
                hy = e % Bs::EY;
      // the row as one span of words from input XV - 2 LO: raw word k +
      // SW of the row's RW words
      const uint32_t* r = s + e * Bs::RW;
      uint32_t raw[Bs::RW];
#pragma unroll
      for (int k = 0; k < Bs::RW; k += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(r + k);
        raw[k] = v.x;
        raw[k + 1] = v.y;
        raw[k + 2] = v.z;
        raw[k + 3] = v.w;
      }
      uint32_t w[Bs::NW];
#pragma unroll
      for (int k = 0; k < Bs::NW; ++k) w[k] = raw[k + Bs::SW];
#pragma unroll
      for (int cp = 0; cp < Bs::NCP; ++cp) {
        uint32_t* d = work + ((cp * 8 + ci) * Bs::PR + hz * Bs::EY + hy) * 8;
        // positions 2k, 2k + 1 of copy cp: s1 span elements 1 + cp + 2k,
        // + 1 (inputs bx0 - 1 + cp + 2k, + 1); s2 4k + cp + 1, + 2 (inputs
        // 2 (bx0 + 2k) + cp - 1, + 2); t2 2k + cp, + 1
        uint32_t v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if constexpr (MODE == 0)
            v[k] = pair_word(w, 1 + cp + 2 * k, 1);
          else if constexpr (MODE == 1)
            v[k] = pair_word(w, 4 * k + cp + 1, 2);
          else
            v[k] = pair_word(w, 2 * k + cp, 1);
        }
        sts128(d, v[0], v[1], v[2], v[3]);
        sts128(d + 4, v[4], v[5], v[6], v[7]);
      }
    }
    if constexpr (MODE == 2) {
      uint32_t* sg = work + Bs::X_WORDS;
      for (int e = threadIdx.x; e < K::G_ITEMS; e += kThreads) {
        uint32_t w[4 * Bs::NVG];
#pragma unroll
        for (int k = 0; k < Bs::NVG; ++k) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              s + K::RAWX + e * K::RGS + 4 * k);
          w[4 * k] = v.x;
          w[4 * k + 1] = v.y;
          w[4 * k + 2] = v.z;
          w[4 * k + 3] = v.w;
        }
        // (co, ry, pz, py): outputs 2 (bx0 + j) + px of class (pz, py, px)
        const int co = e / (4 * Bs::R), rem = e % (4 * Bs::R);
        const int ry2 = rem >> 2, pz = (rem >> 1) & 1, py = rem & 1;
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          const int cls = pz * 4 + py * 2 + px;
          uint32_t* d = sg + ((cls * NB * 8 + co) * Bs::PG + ry2 * kBX) / 2;
          uint32_t v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = pair_word(w, 4 * k + px, 2);
          sts128(d, v[0], v[1], v[2], v[3]);
          sts128(d + 4, v[4], v[5], v[6], v[7]);
        }
      }
    }
  };

  // The warp's KW k16 steps for every tile: G tiles at a time, their A
  // fragments loaded and their MMAs issued before the sums are added (a
  // chain of KW products in the tensor cores, then one round-to-nearest
  // add into acc: the flush, once a brick)
  auto compute = [&](const uint32_t* sg) {
    uint2 bq[Bs::KW][NB];
    if (MODE != 2) {
#pragma unroll
      for (int k = 0; k < Bs::KW; ++k)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          bq[k][nb] = lds64(sg + offB + k * Bs::B_STEP + nb * 8 * Bs::PG / 2);
    }
#pragma unroll
    for (int m0 = 0; m0 < MW; m0 += K::G) {
      float d[K::G][NB][4];
#pragma unroll
      for (int k = 0; k < Bs::KW; ++k) {
        uint2 lo[K::G], hi[K::G];
#pragma unroll
        for (int j = 0; j < K::G; ++j) {
          if (m0 + j >= MW) continue;
          lo[j] = lds64(work + offA[m0 + j][0] + k * Bs::A_STEP);
          hi[j] = lds64(work + offA[m0 + j][1] + k * Bs::A_STEP);
        }
#pragma unroll
        for (int j = 0; j < K::G; ++j) {
          if (m0 + j >= MW) continue;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const uint2 b =
                MODE == 2 ? lds64(sg + offG[m0 + j] + offB + nb * 8 * Bs::PG / 2)
                          : bq[k][nb];
            if (k == 0)
              mma_zero(d[j][nb], lo[j].x, hi[j].x, lo[j].y, hi[j].y, b.x,
                       b.y);
            else
              mma_acc(d[j][nb], lo[j].x, hi[j].x, lo[j].y, hi[j].y, b.x,
                      b.y);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < K::G; ++j) {
        if (m0 + j >= MW) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m0 + j][nb][i] += d[j][nb][i];
      }
    }
  };

  // a ring of NS slots: brick i + NS - 1 is read while brick i is
  // transformed and computed; one cp.async group a brick (empty past the
  // run's end), so wait_group<NS - 2> leaves brick i's g landed, and
  // slot i % NS's mbarrier completes phase i / NS when x's box has landed
#pragma unroll
  for (int j = 0; j < K::NS - 1; ++j) {
    if (j < nbk) issue(j, smem + j * K::SLOT);
    tc::cp_async_commit();
  }
  for (int i = 0; i < nbk; ++i) {
    tc::cp_async_wait<K::NS - 2>();
    if (tma_x) mbar_wait(mbar + 8 * (i % K::NS), (i / K::NS) & 1);
    __syncthreads();           // brick i landed; brick i - 1's slot is free
    if (i + K::NS - 1 < nbk)
      issue(i + K::NS - 1, smem + ((i + K::NS - 1) % K::NS) * K::SLOT);
    tc::cp_async_commit();
    const uint32_t* slot = smem + (i % K::NS) * K::SLOT;
    transform(slot);
    __syncthreads();
    compute(MODE == 2 ? work + Bs::X_WORDS : slot + K::RAWX);
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // each warp holds its brick rows' sums of every tile: sum the warps in
  // order in shared memory (the ring is free now)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(((warp * MW + mt) * NB + nb) * 4 + i) * 32 + lane] =
            acc[mt][nb][i];
  __syncthreads();
  // warp w writes tiles w, w + 8 (MW <= 14)
  float* out = partial + (long long)blockIdx.x * Co * Ci * 27;
  for (int mt = warp; mt < MW; mt += kWarps) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int cp, hz, hy, cls;
      const int tap = tile_half<MODE>(q0 + mt, h, 0, 0, cp, hz, hy, cls);
      const int ci = c0 + g;
      if (tap < 0 || ci >= Ci) continue;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 2 * h + j;
          const int co = co0 + nb * 8 + 2 * t + j;
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            sum += red[(((w * MW + mt) * NB + nb) * 4 + i) * 32 + lane];
          if (co < Co) out[((long long)co * Ci + ci) * 27 + tap] = sum;
        }
    }
  }
}

// dw[i] = the sum of partial[c][i] over the chunks c in a fixed order: 32
// strands (strand y: chunks y, y + 32, ...) each summed in order, then the
// strands in order; a block of 32 x 32 threads owns 32 consecutive outputs.
__global__ void __launch_bounds__(1024)
sum_chunks_bf16(const float* __restrict__ partial, float* __restrict__ dw,
           int chunks, long long n_out) {
  __shared__ float strand[32][33];
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < n_out)
    for (int c = threadIdx.y; c < chunks; c += 32)
      s += partial[c * n_out + i];
  strand[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || i >= n_out) return;
  float total = 0.f;
  for (int y = 0; y < 32; ++y) total += strand[y][threadIdx.x];
  dw[i] = total;
}

// The driver's cuTensorMapEncodeTiled, found once through the runtime
// (no link to the driver library)
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// x [N, Ci, Di, Hi, Wi] as a TMA tensor with boxes of [8][EZ][EY][2 RW]
// elements (zero past its ends)
template <int MODE>
cudaError_t x_map(CUtensorMap* map, const bf16* x, int N, int Ci, int Di,
                  int Hi, int Wi) {
  using Bs = DwB<MODE>;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[5] = {(cuuint64_t)Wi, (cuuint64_t)Hi, (cuuint64_t)Di,
                              (cuuint64_t)Ci, (cuuint64_t)N};
  const cuuint64_t row = 2 * (cuuint64_t)Wi;
  const cuuint64_t strides[4] = {row, row * Hi, row * Hi * Di,
                                 row * Hi * Di * Ci};
  const cuuint32_t box[5] = {2 * Bs::RW, Bs::EY, Bs::EZ, 8, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<bf16*>(x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MODE, int MW, int NB>
cudaError_t launch(const bf16* x, const bf16* g, float* partial, float* dw,
                   int N, int Ci, int Di, int Hi, int Wi, int Co, int Do,
                   int Ho, int Wo, int chunks, long long per_chunk,
                   cudaStream_t s) {
  using K = DwK<MODE, MW, NB>;
  using Bs = DwB<MODE>;
  static_assert(K::SMEM <= 227 * 1024, "shared memory per block");
  auto kern = conv3d_dw_bf16_tc<MODE, MW, NB>;
  static bool smem_set = false;
  cudaError_t err = tc::allow_smem(kern, K::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int bd = MODE == 2 ? Di : Do, bh = MODE == 2 ? Hi : Ho,
            bw = MODE == 2 ? Wi : Wo;
  const int nbz = (bd + Bs::BZ - 1) / Bs::BZ, nby = (bh + Bs::BY - 1) / Bs::BY,
            nbx = (bw + kBX - 1) / kBX;
  const long long bricks = (long long)N * nbz * nby * nbx;
  // the plan must cover every brick exactly once with `chunks` runs
  if (per_chunk < 1 || (long long)chunks * per_chunk < bricks ||
      (long long)(chunks - 1) * per_chunk >= bricks)
    return cudaErrorInvalidValue;
  const int qblocks = kTiles / MW;
  dim3 grid((unsigned)chunks, (unsigned)(((Ci + 7) / 8) * qblocks),
            (unsigned)((Co + 8 * NB - 1) / (8 * NB)));
  // TMA needs 16-byte rows and a 16-byte aligned base
  const int tma_x = Wi % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_g = Wo % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  CUtensorMap map{};
  if (tma_x) {
    err = x_map<MODE>(&map, x, N, Ci, Di, Hi, Wi);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, K::SMEM, s>>>(map, x, g, partial, Ci, Di, Hi, Wi,
                                       Co, Do, Ho, Wo, nbz, nby, nbx, bricks,
                                       per_chunk, qblocks, tma_x, vec_g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_out = (long long)Co * Ci * 27;
  sum_chunks_bf16<<<(unsigned)((n_out + 31) / 32), dim3(32, 32), 0, s>>>(
      partial, dw, chunks, n_out);
  return cudaGetLastError();
}

// (m16 tiles a block, n8 tiles a block) per Co: ops/conv3d_train.
// dw_plan_bf16 plans the grid from the same rule
template <int MODE>
cudaError_t by_co(const bf16* x, const bf16* g, float* partial, float* dw,
                  int N, int Ci, int Di, int Hi, int Wi, int Co, int Do,
                  int Ho, int Wo, int chunks, long long per_chunk,
                  cudaStream_t s) {
  if (Co < 1) return cudaErrorInvalidValue;
  if (Co <= 8)
    return launch<MODE, 14, 1>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do,
                               Ho, Wo, chunks, per_chunk, s);
  return launch<MODE, 7, 2>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do, Ho,
                            Wo, chunks, per_chunk, s);
}

}  // namespace

// mode: 0 stride 1, 1 stride 2, 2 transposed (conv3d.cu's modes).
// chunks x per_chunk: the split-K runs of ops/conv3d_train.dw_plan_bf16
// (runs of per_chunk consecutive bricks of BZ x BY x 16 base positions,
// the last one shorter); brick_y, the plan's BY, must be this build's.
// partial holds chunks x Co x Ci x 27 floats of scratch.
extern "C" int conv3d_dw_bf16(const bf16* x, const bf16* g, float* partial,
                              float* dw, int N, int Ci, int Di, int Hi,
                              int Wi, int Co, int Do, int Ho, int Wo,
                              int mode, int chunks, long long per_chunk,
                              int brick_y, void* stream) {
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      if (brick_y != DwB<0>::BY) return (int)cudaErrorInvalidValue;
      return (int)by_co<0>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do, Ho,
                           Wo, chunks, per_chunk, s);
    case 1:
      if (brick_y != DwB<1>::BY) return (int)cudaErrorInvalidValue;
      return (int)by_co<1>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do, Ho,
                           Wo, chunks, per_chunk, s);
    case 2:
      if (brick_y != DwB<2>::BY) return (int)cudaErrorInvalidValue;
      return (int)by_co<2>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do, Ho,
                           Wo, chunks, per_chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
