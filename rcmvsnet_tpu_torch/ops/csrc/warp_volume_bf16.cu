// The bf16 stage-1 train volume, forward (K7-bf16) and backward
// (K7bwd-bf16), designed for Hopper on their own. K7's float32 kernels stay
// in warp_volume.cu; these share K1-bf16's and K6-bf16's pieces
// (warp_bf16.cuh).
//
// K7-bf16 replaces rcmvsnet_tpu/ops/pallas_warp_volume.py
// plane_sweep_volume_fused_train (:263) at compute and output dtype bf16
// (_warp_vol_fwd_kernel :101, pallas_call :340; the stacked features and
// images rounded :300-308, the x hat weights :78-91). In one sweep over
// (depth plane d, reference pixel) it writes
//   var     variance over all V views (reference included) [C, D, h, w]
//   vol     the render branch's volume_feature [3 (V-1) + C, D, h, w]:
//           the V-1 warped source images, view-major, then the variance
//           over the V-1 source views divided by V (the no-ref variance).
// Each element is the arithmetic of the float32 template's bf16 instance
// that it replaces (warp_volume.cu's VolumeEpi on bf16 features and
// images) operation for operation: each
// source view sampled at its projection (warp_common.cuh) with the x
// weights rounded to bf16 (features and images: taps 0..3, one fused
// multiply-add each), the source views' sums from zero in view order
// (__fadd_rn, x^2 by one FMA), the IEEE division by V (x * (1/V) where V is
// a power of two: the same correctly rounded quotient), the reference
// added last, each output rounded to bf16 once. So var and vol equal that
// instance's in every bit (tools/ab_warp_fwd.py holds builds to each
// other with torch.equal).
//
// What held the template instance back (1.03 ms at stage 1 against a bound
// of 0.045 ms; PERF.md): C/4 lanes a pixel gathering 8 bytes a tap, the
// plane's 2C + 3(V-1) rows staged as floats and written by scalar 2-byte
// stores (64-byte runs a row at C = 32), view v's RGB sampled by the lane
// that projected it in 3 two-byte loads a tap while the rest of its group
// waited, and each plane's projection computed after the last plane's
// gathers. What this design does about it, on K1-bf16's levers:
//   * kFwdCh = 8 channels a lane, L = C/8 lanes a pixel, one 16-byte gather
//     a tap;
//   * the projections shared (lane q projects views q, q + L, ... and the
//     group passes the taps on with __shfl_sync), plane d + 1's computed
//     while plane d's gathers are in flight (warpb::next_plane);
//   * the images: the wrapper lays them out as a [V, h, w, 4] bf16 copy
//     (channel 3 unused; 0.66 MB at stage 1, one small copy), so the lane
//     that projected view v samples its RGB in one 8-byte load a tap, 4 a
//     view instead of 12. The other choice, the group's lanes splitting a
//     view's taps and channels, leaves a lane at C = 32 with as many loads
//     as before (9 (view, channel) pairs over 4 lanes: 3 pairs, 12 loads)
//     and nothing to split at C = 8 (one lane a pixel);
//   * each plane's rows staged in bf16, rows of PS = P + 32/L (P + 8 at L =
//     1), channel c = 8q + i of var and of the no-ref variance at staged
//     row i L + q, so that the L lanes of a pixel, storing channel i,
//     fall on distinct banks (the 16-byte reads below need rows that start
//     on 16 bytes, and at such a stride 8 consecutive rows of one lane
//     share a bank); written as 16-byte vectors, runs of P = 2048/C pixels
//     a row (warpb::store_rows), element by element where h*w % 8 != 0 or
//     var or vol does not start on 16 bytes (K1-bf16's vec rule);
//   * the train step's V = 4 an instance of its own (view loops without a
//     run-time bound, x * (1/4) for the divisions).
// Bound: device-memory bytes, (2C + 3(V-1)) bf16 written per plane and
// pixel (143.5 MB at stage 1); the gathers hit L1/L2.
//
// K7bwd-bf16 replaces the backward of the same function at compute and
// output dtype bf16 (_warp_vol_bwd_kernel :178, pallas_call :406, dfeat
// and dimg cast :429-430). With x_v the bf16 forward's sample of source
// view v (bf16 x weights), mean = (ref + sum_v x_v) / V and mean_nr =
// sum_v x_v / V:
//   dL/dx_v   = (2/V) g_var (x_v - mean) + (2/V) g_nr (x_v - mean_nr)
//   dL/dref   = (2/V) g_var (ref - mean), summed over the planes
//   dL/dimg_v = g_img of view v,
// each source cotangent applied through Warp_v^T: tap k of a sample
// receives bf16(e * wy_k) * bf16(wx_k) of the float32 cotangent e
// (warp_bwd.cuh's bf16 note), summed in warp_bwd.cuh's 64-bit fixed point
// (runs of planes that share a top-left tap, flushed as integer adds), so
// the output repeats bit for bit; dfeat and dimg are rounded to bf16 once
// and dimg[0] is zero. Each channel's float sequence is the template
// instance's that it replaces (warp_volume.cu's warp_volume_bwd_kernel on
// bf16): the sources' sum from zero in view order, the IEEE
// divisions by V (x * (1/V) where V is a power of two: the same correctly
// rounded quotient), the cotangent expression as the template spells it,
// the image channels' runs per channel. So its output equals that
// instance's in every bit (tools/ab_warp_bwd.py holds builds to each other
// with torch.equal).
//
// What held the template instance back (2.31 ms a train step against a
// bound of 0.048 ms; PERF.md): not bytes and not its integer adds, but the
// work each lane repeats per plane. C lanes a pixel each projected every
// source view (two IEEE divisions a view), kept every view's run
// bookkeeping, rounded bf16(wx_k) once a channel and gathered 2 bytes a
// tap; the cotangents were staged by scalar loads, 4 planes a barrier.
// What this design does about it, on K6-bf16's (warp_variance_bf16.cu):
//   * kBwdCh = 4 channels a lane, L = C / 4 lanes a pixel, one 8-byte
//     gather a tap; lane q projects views q, q + L, ... and the group
//     passes the taps on with __shfl_sync; the run bookkeeping and
//     bf16(wx_k) are worked out once for 4 channels;
//   * plane d + 1's projection and gathers issued before plane d's
//     multiply-adds and run updates;
//   * g_var, g_nr and the g_img rows staged along pixels in 16-byte bf16
//     vectors, 8 planes a barrier, into rows padded so that the lanes of a
//     pixel read distinct banks;
//   * a flush hands the group's feature sums over through shared memory,
//     so that each integer add instruction covers L consecutive words;
//   * the image cotangent of view v goes through the same runs: the lane
//     that projects view v keeps its 3 channels' sums and adds them into
//     the image quanta [V-1, h, w, 4], one 32-byte sector a pixel;
//   * the train step's V = 4 is an instance of its own (view loops without
//     a run-time bound).
// tests/test_torch_warp_bf16_lanes.py emulates both lane maps, K7-bf16's
// image lanes, staging and stores, and K7bwd-bf16's flush on the CPU.
//
// Layouts: feats / dfeat [V, h, w, C] bf16 channels-last (feats 16-byte
// aligned), imgs4 [V, h, w, 4] bf16 (K7-bf16; 8-byte aligned), dimg [V, h,
// w, 3] bf16; rel [V, 16] float (row 0 unused); lo, step [h, w] float; var,
// g_var, g_nr [C, D, h, w], vol [3 (V-1) + C, D, h, w], g_img [3 (V-1), D,
// h, w] bf16 (the caller passes g_img and g_nr as the two row slices of
// vol's cotangent). K7bwd-bf16's scratch: warp_bwd.cuh's Aux, int64
// feature quanta [V-1, h, w, C], int64 image quanta [V-1, h, w, 4].
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

constexpr int kFwdCh = 8;          // K7-bf16: channels a lane
constexpr int kBwdCh = 4;          // K7bwd-bf16: channels a lane
constexpr int kPlaneChunk = 8;     // K7bwd-bf16: planes of cotangents
                                   // staged a barrier
static_assert(kThreads == warp::kFwdThreads, "K7-bf16's grid: fwd_plan");

// ------------------------------------------------------------ K7-bf16

// The staging of one K7-bf16 block at C channels and at most NV source
// views: two buffers (planes alternate) of 2C + 3 NV rows of PS bf16.
template <int C, int NV>
struct FwdSmem {
  static constexpr int L = C / kFwdCh, P = kThreads / L;
  static constexpr int PS = P + (L > 1 ? 32 / L : 8);
  static constexpr int ROWS = 2 * C + 3 * NV;
  static constexpr int BYTES = 2 * ROWS * PS * 2;
  static_assert(PS % 8 == 0, "staged rows start on 16 bytes");
};

// The staged row of channel c = 8q + i of var (and, from row C + 3 nv, of
// the no-ref variance): i L + q, so that the L lanes of a pixel storing
// channel i write consecutive rows; and back.
template <int L>
__device__ __forceinline__ int staged_row(int q, int i) { return i * L + q; }
template <int L>
__device__ __forceinline__ int channel_of(int r) {
  return (r % L) * kFwdCh + r / L;
}

// View v's RGB at taps t from its [H, W, 4] image copy base (channel 3
// unused): one 8-byte load a tap, then warp_volume.cu's sample_rgb rule
// (taps 0..3, one fused multiply-add each with bf16(wx_k) * wy_k, a tap
// outside the image adding nothing).
__device__ __forceinline__ void sample_rgb4(const bf16* base, const Taps& t,
                                            int H, int W, float (&rgb)[3]) {
  unsigned w[4][2];
  load_taps<4, 4>(base, t, H, W, 0, w);
  float val[4];
  fma_taps<4>(t, H, W, w, val);
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = val[c];
}

// A block: P consecutive reference pixels (L = C/8 lanes each, lane q
// channels [8q, 8q + 8) and the images of the views it projects) over the
// planes [d0, d0 + DC) of its chunk. NV bounds the source views; EXACT:
// exactly NV (the train step's V = 4). vec: var and vol take 16-byte
// stores (h*w % 8 == 0, both 16-byte aligned).
template <int C, int NV, bool EXACT>
__global__ void __launch_bounds__(kThreads)
warp_volume_bf16_kernel(const bf16* __restrict__ feats,
                        const bf16* __restrict__ imgs4,
                        const float* __restrict__ rel,
                        const float* __restrict__ lo,
                        const float* __restrict__ step,
                        bf16* __restrict__ var, bf16* __restrict__ vol,
                        int V, int H, int W, int D, int DC, bool vec) {
  using M = FwdSmem<C, NV>;
  constexpr int N = kFwdCh, L = M::L, P = M::P, PS = M::PS;
  constexpr int S = (NV + L - 1) / L;       // views a lane projects
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_rel[kMaxViews * 16];
  bf16* s_out = reinterpret_cast<bf16*>(smem);
  for (int i = threadIdx.x; i < V * 16; i += blockDim.x) s_rel[i] = rel[i];
  __syncthreads();

  const long long HW = (long long)H * W, plane = (long long)D * HW;
  const int j = threadIdx.x / L, q = threadIdx.x % L;
  const long long p0 = (long long)blockIdx.x * P;
  // a pixel past the image computes the last one (its lanes take part in
  // the shuffles) and writes nothing
  const long long pix = min(p0 + j, HW - 1);
  const int y = (int)(pix / W);
  const float fx = (float)(pix - (long long)y * W), fy = (float)y;
  const float lo_p = lo[pix], step_p = step[pix];
  const int nv = EXACT ? NV : V - 1;        // EXACT: nv, fv, pow2 constant
  const int nr0 = C + 3 * nv;               // the no-ref rows' first
  const float fv = (float)(nv + 1);
  // x / V, rounded once: for V a power of two x * (1/V) is the same
  // correctly rounded quotient
  const bool pow2 = ((nv + 1) & nv) == 0;
  const float inv_v = __fdiv_rn(1.f, fv);
  auto over_v = [&](float x) {
    return pow2 ? __fmul_rn(x, inv_v) : __fdiv_rn(x, fv);
  };
  float ref[N];
  load_bf16<N>(feats + pix * C + N * q, ref);

  float rr[S][3];
  rot_rows<S, L>(rr, s_rel, q, nv, fx, fy);
  const int d0 = blockIdx.y * DC, d1 = min(D, d0 + DC);
  Taps next[S];
  project_mine<S, L>(next, rr, s_rel, q, nv,
                     warp::plane_depth(lo_p, step_p, d0), H, W);
  for (int d = d0; d < d1; ++d) {
    Taps mine[S];
    next_plane<S, L>(mine, next, rr, s_rel, q, nv, lo_p, step_p, d, H, W);
    float sum[N], sq[N];                     // source views only
#pragma unroll
    for (int i = 0; i < N; ++i) sum[i] = sq[i] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!EXACT && v >= nv) break;          // the same in the whole warp
      const Taps t = taps_of_view<S, L>(mine, v);
      unsigned w[4][N / 2];
      float val[N];
      load_taps<C, N>(feats + (long long)(v + 1) * HW * C, t, H, W, N * q,
                      w);
      fma_taps<N>(t, H, W, w, val);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        sum[i] = __fadd_rn(sum[i], val[i]);
        sq[i] = __fmaf_rn(val[i], val[i], sq[i]);
      }
    }
    bf16* so = s_out + ((d - d0) & 1) * M::ROWS * PS;
    // the images of the views this lane projected, at its own taps
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int v = s * L + q;
      if (v >= nv) break;
      float rgb[3];
      sample_rgb4(imgs4 + (long long)(v + 1) * HW * 4, mine[s], H, W, rgb);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        so[(C + 3 * v + c) * PS + j] = __float2bfloat16_rn(rgb[c]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float m_nr = over_v(sum[i]);
      so[(nr0 + staged_row<L>(q, i)) * PS + j] = __float2bfloat16_rn(
          __fmaf_rn(-m_nr, m_nr, over_v(sq[i])));
      const float r = ref[i];
      const float m = over_v(__fadd_rn(sum[i], r));
      so[staged_row<L>(q, i) * PS + j] = __float2bfloat16_rn(
          __fmaf_rn(-m, m, over_v(__fmaf_rn(r, r, sq[i]))));
    }
    __syncthreads();
    // 2C + 3 nv runs of P consecutive bf16 of var's and vol's rows at
    // plane d; the two staging buffers alternate between planes, so one
    // barrier a plane suffices
    store_rows<P>(so, PS, C + nr0,
                  [&](int r) {
                    return r < C ? var + channel_of<L>(r) * plane
                         : r < nr0 ? vol + (r - C) * plane
                         : vol + (3 * nv + channel_of<L>(r - nr0)) * plane;
                  },
                  (long long)d * HW + p0, p0, HW, vec);
  }
}

template <int C, int NV, bool EXACT>
cudaError_t launch_fwd(const bf16* feats, const bf16* imgs4,
                       const float* rel, const float* lo, const float* step,
                       bf16* var, bf16* vol, int V, int H, int W, int D,
                       bool vec, cudaStream_t stream) {
  using M = FwdSmem<C, NV>;
  auto kern = warp_volume_bf16_kernel<C, NV, EXACT>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, M::BYTES);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  // a block walks all D planes where the pixel blocks alone fill the
  // card, else a chunk of them (warp_fwd.cuh)
  const warp::Plan p = warp::fwd_plan(H, W, C, D, kFwdCh);
  kern<<<dim3((unsigned)p.nx, (unsigned)p.nz), kThreads, M::BYTES,
         stream>>>(feats, imgs4, rel, lo, step, var, vol, V, H, W, D, p.dc,
                   vec);
  return cudaGetLastError();
}

template <int C>
cudaError_t fwd_views(const bf16* feats, const bf16* imgs4, const float* rel,
                      const float* lo, const float* step, bf16* var,
                      bf16* vol, int V, int H, int W, int D, bool vec,
                      cudaStream_t s) {
  if (V == 4)
    return launch_fwd<C, 3, true>(feats, imgs4, rel, lo, step, var, vol, V,
                                  H, W, D, vec, s);
  if (V <= 4)
    return launch_fwd<C, 3, false>(feats, imgs4, rel, lo, step, var, vol, V,
                                   H, W, D, vec, s);
  if (V <= 8)
    return launch_fwd<C, 7, false>(feats, imgs4, rel, lo, step, var, vol, V,
                                   H, W, D, vec, s);
  return launch_fwd<C, 15, false>(feats, imgs4, rel, lo, step, var, vol, V,
                                  H, W, D, vec, s);
}

// ------------------------------------------------------------ K7bwd-bf16

// The shared memory of one block at C channels and NV source views: the
// staged cotangents g_var, g_nr [kPlaneChunk][C][PG] and g_img
// [kPlaneChunk][3 NV][PG] (bf16), then each pixel's flush hand-over
// [P][4][C] (float).
template <int C, int NV>
struct Smem {
  static constexpr int L = C / kBwdCh, P = kThreads / L;
  // a staged row: P pixels and a pad that puts the L lanes of a pixel,
  // reading rows q * 4 + i, on distinct banks
  static constexpr int PG = P + 64 / C;
  static constexpr int RI = 3 * NV;
  static constexpr int GV = 0, GN = GV + kPlaneChunk * C * PG * 2,
                       GI = GN + kPlaneChunk * C * PG * 2,
                       FL = GI + kPlaneChunk * RI * PG * 2;
  static constexpr int BYTES = FL + P * 4 * C * 4;
  static_assert(PG % 2 == 0 && P % 8 == 0, "staging rows of whole words");
  static_assert(FL % 16 == 0, "the hand-over starts 16-byte aligned");
};

// The image cotangent's run sums of one view: per tap k and channel c.
struct ImgRun {
  float acc[4][3];
};

// Tap k of the image run receives bf16(gi_c * wy_k) * bf16(wx_k), channel
// c (warp_bwd.cuh's bf16 rule, channel by channel).
__device__ __forceinline__ void img_add(ImgRun& r, const Taps& t,
                                        const float (&gi)[3]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wy = (k >> 1) ? t.wy : __fsub_rn(1.f, t.wy);
    const float wx = bf16_rn((k & 1) ? t.wx : __fsub_rn(1.f, t.wx));
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r.acc[k][c] = __fmaf_rn(wx, bf16_rn(__fmul_rn(gi[c], wy)),
                              r.acc[k][c]);
  }
}

// Add the image run's sums, in quanta, into dst [H, W, 4] at the taps of
// (x0, y0) inside the image (warp::flush_taps on 3 of the 4 words).
__device__ __forceinline__ void img_flush(unsigned long long* dst,
                                          const ImgRun& r, int x0, int y0,
                                          int H, int W, double to_q) {
  if (!(to_q > 0.0)) return;          // all-zero or non-finite inputs
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    unsigned long long* p = dst + ((long long)yi * W + xi) * 4;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      atomicAdd(p + c, (unsigned long long)llrint((double)r.acc[k][c] * to_q));
  }
}

__device__ __forceinline__ void img_clear(ImgRun& r) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.acc[k][c] = 0.f;
}

// A block: P consecutive reference pixels, L = C / kBwdCh lanes each
// (lane q channels [4q, 4q + 4), and the image runs of views q, q + L,
// ...), walking all D planes in order, the cotangents staged kPlaneChunk
// planes at a time. NV bounds the source views; EXACT: exactly NV (the
// train step's V = 4).
template <int C, int NV, bool EXACT>
__global__ void __launch_bounds__(kThreads)
warp_volume_bwd_bf16_kernel(const bf16* __restrict__ feats,
                            const float* __restrict__ rel,
                            const float* __restrict__ lo,
                            const float* __restrict__ step,
                            const bf16* __restrict__ g_var,
                            const bf16* __restrict__ g_nr,
                            const bf16* __restrict__ g_img,
                            bf16* __restrict__ dfeat,
                            unsigned long long* __restrict__ acc_f,
                            unsigned long long* __restrict__ acc_i,
                            const warp::Quantum* __restrict__ quantum,
                            int V, int H, int W, int D, bool vec) {
  using M = Smem<C, NV>;
  constexpr int N = kBwdCh, L = M::L, P = M::P, PG = M::PG, RI = M::RI;
  constexpr int S = (NV + L - 1) / L;       // views a lane projects
  static_assert(L < 32, "a group is part of a warp");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_rel[kMaxViews * 16];
  auto* s_gv = reinterpret_cast<bf16 (*)[C][PG]>(smem + M::GV);
  auto* s_gn = reinterpret_cast<bf16 (*)[C][PG]>(smem + M::GN);
  auto* s_gi = reinterpret_cast<bf16 (*)[RI][PG]>(smem + M::GI);
  auto* s_fl = reinterpret_cast<float (*)[4][C]>(smem + M::FL);
  for (int i = threadIdx.x; i < V * 16; i += blockDim.x) s_rel[i] = rel[i];
  __syncthreads();

  const long long HW = (long long)H * W;
  const int j = threadIdx.x / L, q = threadIdx.x % L, c0 = N * q;
  // this lane's group of L lanes in its warp
  const unsigned mask = ((1u << L) - 1u) << (threadIdx.x % 32 / L * L);
  const long long p0 = (long long)blockIdx.x * P;
  // a pixel past the image computes the last one (its lanes take part in
  // the shuffles) and adds and writes nothing
  const bool live = p0 + j < HW;
  const long long pix = live ? p0 + j : HW - 1;
  const int y = (int)(pix / W);
  const float fx = (float)(pix - (long long)y * W), fy = (float)y;
  const float lo_p = lo[pix], step_p = step[pix];
  const double to_qf = quantum[0].to_q, to_qi = quantum[1].to_q;
  const int nv = EXACT ? NV : V - 1;
  const float fv = (float)V;
  const float scale = __fdiv_rn(2.f, fv);
  // x / V, rounded once: for V a power of two x * (1/V) is the same
  // correctly rounded quotient
  const bool pow2 = (V & (V - 1)) == 0;
  const float inv_v = __fdiv_rn(1.f, fv);
  float ref[N];
  load_bf16<N>(feats + pix * C + c0, ref);

  float rr[S][3];
  rot_rows<S, L>(rr, s_rel, q, nv, fx, fy);
  Run<N> run[NV];
  ImgRun img[S];                             // views s * L + q
#pragma unroll
  for (int v = 0; v < NV; ++v) run_clear(run[v]);
#pragma unroll
  for (int s = 0; s < S; ++s) img_clear(img[s]);
  float dref[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dref[i] = 0.f;

  // plane d's taps and loaded words of each view, fetched while plane
  // d - 1 adds up its cotangents
  Taps tn[NV];
  unsigned wn[NV][4][N / 2];
  auto fetch = [&](int d) {
    fetch_views<C, N, L, S, NV, EXACT>(tn, wn, rr, s_rel, feats, HW, q, nv,
                                       warp::plane_depth(lo_p, step_p, d),
                                       H, W, c0);
  };
  fetch(0);
  for (int d0 = 0; d0 < D; d0 += kPlaneChunk) {
    __syncthreads();                 // the last chunk's reads are done
    stage_g<C, P, PG, kPlaneChunk>(s_gv, g_var, p0, HW, d0, D, vec);
    stage_g<C, P, PG, kPlaneChunk>(s_gn, g_nr, p0, HW, d0, D, vec);
    stage_g<RI, P, PG, kPlaneChunk>(s_gi, g_img, p0, HW, d0, D, vec,
                                    3 * nv);
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
      for (int i = 0; i < N; ++i) sum[i] = 0.f;   // source views only
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!EXACT && v >= nv) break;
        fma_taps<N>(t[v], H, W, w[v], x[v]);
#pragma unroll
        for (int i = 0; i < N; ++i) sum[i] = __fadd_rn(sum[i], x[v][i]);
      }
      float m[N], m_nr[N], gv[N], gn[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float all = __fadd_rn(sum[i], ref[i]);
        m[i] = pow2 ? __fmul_rn(all, inv_v) : __fdiv_rn(all, fv);
        m_nr[i] = pow2 ? __fmul_rn(sum[i], inv_v) : __fdiv_rn(sum[i], fv);
        gv[i] = __fmul_rn(scale, __bfloat162float(s_gv[dd][c0 + i][j]));
        gn[i] = __fmul_rn(scale, __bfloat162float(s_gn[dd][c0 + i][j]));
        dref[i] = __fmaf_rn(gv[i], __fsub_rn(ref[i], m[i]), dref[i]);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!EXACT && v >= nv) break;
        if (run[v].x0 != t[v].x0 || run[v].y0 != t[v].y0) {
          // view v's runs end: its feature sums (the group) and image
          // sums (the lane that projects v)
          if (live) {
            flush<C, N, L>(acc_f + (long long)v * HW * C, run[v], s_fl[j],
                           mask, H, W, q, to_qf);
            if (v % L == q)
              img_flush(acc_i + (long long)v * HW * 4, img[v / L],
                        run[v].x0, run[v].y0, H, W, to_qi);
          }
          run_clear(run[v]);
          run[v].x0 = t[v].x0;
          run[v].y0 = t[v].y0;
          if (v % L == q) img_clear(img[v / L]);
        }
        // the template's gv (x - m) + gn (x - m_nr) as nvcc contracted it
        // there: one fused multiply-add into the second product
        float cot[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          cot[i] = __fmaf_rn(gv[i], __fsub_rn(x[v][i], m[i]),
                             __fmul_rn(gn[i], __fsub_rn(x[v][i], m_nr[i])));
        run_add<N>(run[v], t[v], cot);
        if (v % L == q) {
          float gi[3];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            gi[c] = __bfloat162float(s_gi[dd][3 * v + c][j]);
          img_add(img[v / L], t[v], gi);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!EXACT && v >= nv) break;
    flush<C, N, L>(acc_f + (long long)v * HW * C, run[v], s_fl[j], mask, H,
                   W, q, to_qf);
    if (v % L == q)
      img_flush(acc_i + (long long)v * HW * 4, img[v / L], run[v].x0,
                run[v].y0, H, W, to_qi);
  }
  static_assert(N == 4, "one 8-byte store of dref");
  *reinterpret_cast<uint2*>(dfeat + pix * C + c0) =
      make_uint2(pack_rn(dref[0], dref[1]), pack_rn(dref[2], dref[3]));
}

template <int C, int NV, bool EXACT>
cudaError_t launch_bwd(const bf16* feats, const float* rel, const float* lo,
                       const float* step, const bf16* g_var,
                       const bf16* g_nr, const bf16* g_img, bf16* dfeat,
                       unsigned long long* acc_f, unsigned long long* acc_i,
                       const warp::Quantum* q, int V, int H, int W, int D,
                       bool vec, cudaStream_t stream) {
  using M = Smem<C, NV>;
  auto kern = warp_volume_bwd_bf16_kernel<C, NV, EXACT>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, M::BYTES);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const long long HW = (long long)H * W;
  kern<<<(unsigned)((HW + M::P - 1) / M::P), kThreads, M::BYTES, stream>>>(
      feats, rel, lo, step, g_var, g_nr, g_img, dfeat, acc_f, acc_i, q, V,
      H, W, D, vec);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd_views(const bf16* feats, const float* rel, const float* lo,
                      const float* step, const bf16* g_var, const bf16* g_nr,
                      const bf16* g_img, bf16* dfeat,
                      unsigned long long* acc_f, unsigned long long* acc_i,
                      const warp::Quantum* q, int V, int H, int W, int D,
                      bool vec, cudaStream_t s) {
  if (V == 4)
    return launch_bwd<C, 3, true>(feats, rel, lo, step, g_var, g_nr, g_img,
                                  dfeat, acc_f, acc_i, q, V, H, W, D, vec, s);
  if (V <= 4)
    return launch_bwd<C, 3, false>(feats, rel, lo, step, g_var, g_nr, g_img,
                                   dfeat, acc_f, acc_i, q, V, H, W, D, vec,
                                   s);
  if (V <= 8)
    return launch_bwd<C, 7, false>(feats, rel, lo, step, g_var, g_nr, g_img,
                                   dfeat, acc_f, acc_i, q, V, H, W, D, vec,
                                   s);
  return launch_bwd<C, 15, false>(feats, rel, lo, step, g_var, g_nr, g_img,
                                  dfeat, acc_f, acc_i, q, V, H, W, D, vec, s);
}

}  // namespace

// K7-bf16: var [C, D, h, w] and vol [3 (V-1) + C, D, h, w] bf16 (the
// warped source images, view-major, then the no-ref variance) from feats
// [V, h, w, C] (16-byte aligned) and imgs4 [V, h, w, 4] (the images with
// a fourth, unused channel; 8-byte aligned) bf16.
extern "C" int warp_volume_bf16(const bf16* feats, const bf16* imgs4,
                                const float* rel, const float* lo,
                                const float* step, bf16* var, bf16* vol,
                                int V, int H, int W, int C, int D,
                                void* stream) {
  if (V < 2 || V > kMaxViews || D < 1 || (long long)H * W < 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(feats) || reinterpret_cast<uintptr_t>(imgs4) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (long long)H * W % 8 == 0 && aligned16(var) &&
                   aligned16(vol);
  switch (C) {
    case 8: return (int)fwd_views<8>(feats, imgs4, rel, lo, step, var, vol,
                                     V, H, W, D, vec, s);
    case 16: return (int)fwd_views<16>(feats, imgs4, rel, lo, step, var,
                                       vol, V, H, W, D, vec, s);
    case 32: return (int)fwd_views<32>(feats, imgs4, rel, lo, step, var,
                                       vol, V, H, W, D, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bytes of the scratch warp_volume_bwd_bf16 takes (any contents): the
// template instance's layout.
extern "C" long long warp_volume_bf16_bwd_scratch_bytes(int V, int H, int W,
                                                        int C) {
  return warp::kAuxBytes + 8LL * (V - 1) * H * W * (C + 4);
}

// K7bwd-bf16. feats, the cotangents, dfeat and dimg bf16 (feats and dfeat
// 8-byte aligned); every element of dfeat and dimg is written; scratch
// holds warp_volume_bf16_bwd_scratch_bytes(V, H, W, C) bytes.
extern "C" int warp_volume_bwd_bf16(const bf16* feats, const float* rel,
                                    const float* lo, const float* step,
                                    const bf16* g_var, const bf16* g_nr,
                                    const bf16* g_img, bf16* dfeat,
                                    bf16* dimg, void* scratch, int V, int H,
                                    int W, int C, int D, void* stream) {
  if (V < 2 || V > kMaxViews || D < 1 || (long long)H * W < 1)
    return (int)cudaErrorInvalidValue;
  if (C != 8 && C != 16 && C != 32) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(feats) % (2 * kBwdCh) != 0 ||
      reinterpret_cast<uintptr_t>(dfeat) % (2 * kBwdCh) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const long long HW = (long long)H * W;
  warp::Aux* aux = static_cast<warp::Aux*>(scratch);
  auto* acc_f = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + warp::kAuxBytes);
  unsigned long long* acc_i = acc_f + (V - 1) * HW * C;
  const long long plane = (long long)D * HW;
  warp::AbsMaxArgs a{{feats, g_var, g_nr, g_img},
                     {V * HW * C, C * plane, C * plane, 3 * (V - 1) * plane},
                     {true, true, true, true}};
  warp::prepare_scratch(scratch,
                        warp_volume_bf16_bwd_scratch_bytes(V, H, W, C), a,
                        plane, V, true, s);
  const bool vec = HW % 8 == 0 && aligned16(g_var) && aligned16(g_nr) &&
                   aligned16(g_img);
  cudaError_t err;
  switch (C) {
    case 8: err = bwd_views<8>(feats, rel, lo, step, g_var, g_nr, g_img,
                               dfeat, acc_f, acc_i, aux->q, V, H, W, D, vec,
                               s); break;
    case 16: err = bwd_views<16>(feats, rel, lo, step, g_var, g_nr, g_img,
                                 dfeat, acc_f, acc_i, aux->q, V, H, W, D,
                                 vec, s); break;
    default: err = bwd_views<32>(feats, rel, lo, step, g_var, g_nr, g_img,
                                 dfeat, acc_f, acc_i, aux->q, V, H, W, D,
                                 vec, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  cudaMemsetAsync(dimg, 0, sizeof(bf16) * HW * 3, s);
  warp::finish_quanta(acc_f, dfeat + HW * C, (V - 1) * HW * C, C, C, aux->q,
                      s);
  warp::finish_quanta(acc_i, dimg + HW * 3, (V - 1) * HW * 3, 4, 3,
                      aux->q + 1, s);
  return (int)cudaGetLastError();
}
