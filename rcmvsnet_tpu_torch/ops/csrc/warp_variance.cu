// Fused plane-sweep warp + multi-view variance (float32) and its
// backward, for Hopper. The bf16 pair (K1-bf16, K6-bf16) has a source of
// its own, warp_variance_bf16.cu.
//
// Forward (K1) replaces the TPU kernel rcmvsnet_tpu/ops/pallas_warp2.py
// plane_sweep_variance_lanes (planes mode: _warp_var_plane_kernel, coords
// _coords_inkernel). What it computes, per (depth plane d, ref pixel):
//   dv = lo + d * step                          (per-pixel hypothesis)
//   each source view v sampled at its projection (warp_common.cuh)
//   the reference view is read in place (identity warp)
//   sum, sum of squares over the V views in float32 registers
//   variance = sum_sq * (1/V) - (sum * (1/V))^2, written once,
// every step rounded on its own, in the order ops/warp_view.py's
// plane_sweep_variance_views takes over the per-view warps (K10), so the
// two routes give the same variance (gated at 1e-5 of its largest value).
// No warped per-view volume ever reaches device memory.
//
// What bounds K1. Its only unavoidable traffic is the output (C * D * h
// * w floats written once), yet a sample is a gather of 4 taps x C
// channels. The first port (one thread per (plane, pixel) holding all C
// channels) had a warp's float4 load touch 32 rows 4C bytes apart (32 L1
// wavefronts an instruction at C = 32) and a plane-major grid that swept
// whole source images once per plane. This design (the block skeleton
// in warp_fwd.cuh, which K7's forward shares; VarianceEpi below):
//   * lanes across channels: a group of C / 4 lanes owns a reference
//     pixel, each lane one float4 of its channels, so one
//     gather reads whole 4C-byte rows (C = 32: one 128-byte line a pixel)
//     and a lane keeps 8 sums instead of 2C;
//   * the plane loop inside the block: a block owns P consecutive
//     reference pixels and walks a chunk of planes (all D where the grid
//     fills the card; warp::fwd_plan), so the source neighbourhood it
//     samples stays in L1/L2 from plane to plane; rot * [x, y, 1] of each
//     view is computed once per pixel, and each tap's offset, bounds and
//     weight once per view (warp::sample_quad);
//   * projections shared: lane q projects views q, q + C/4, ... and the
//     group passes each view's taps on with __shfl_sync (every lane
//     projecting every view measured 1.4x slower at C = 32);
//   * coalesced writes: per plane the block stages its P x C results in
//     shared memory and writes C runs of P consecutive floats of
//     out[c, d, :, :].
// Measured (tools/ab_warp_fwd.py, PERF.md): 2.4x faster at C = 32, 1.5x
// at 16, even at 8, where the first port already read whole 32-byte
// rows. What is left is neither bytes (6-9x the output's write time) nor
// wavefronts: per warp and plane a chain of projection (two IEEE
// divisions), shuffles and 4(V-1) dependent gathers; half as many lanes
// a pixel (two float4s a lane), two or four planes between barriers, and
// 5-6 blocks per SM (with spills) all measured the same or slower.
// The arithmetic per channel is the first port's, operation for operation
// (reference first, taps 0..3 with one fma each, then views in order), so
// the output is the same bit for bit (tools/ab_warp_fwd.py checks builds
// with torch.equal).
//
// Backward (K6) replaces the backward kernel of
// rcmvsnet_tpu/ops/pallas_warp_train.py plane_sweep_variance_fused_train
// (:306; _warp_var_bwd_kernel :108, pallas_call :374). With x_v the warped
// view v, mean = sum_v x_v / V and g the cotangent of the variance,
//   dL/dx_v = (2/V) * g * (x_v - mean),   dL/dsrc_v = Warp_v^T dL/dx_v,
// and no cotangent reaches the projections or the depth planes (the
// sampling grid carries no gradient, as in the reference). A group of C
// lanes owns one reference pixel, one lane per channel, and walks the
// planes in order (the TPU kernel's sequential plane grid): per plane each
// lane projects the V-1 views (the forward's taps, bit for bit), samples
// its channel of each once and keeps x_v in registers, forms the mean and
// the cotangents, sums the reference view's cotangent over the planes in a
// register (stored once, no atomic: the group owns that pixel) and merges
// each source view's cotangent into its run of planes with one top-left
// tap. Runs are flushed as 64-bit fixed-point integer adds
// (warp_bwd.cuh), so the result is the same bit for bit in every run, as
// the TPU kernel's is. No float atomics.
//
// Layouts: src and dsrc [V, h, w, C] channels-last (one tap reads C
// contiguous floats); rel [V, 16] row-major relative projections (row 0
// unused); lo, step [h, w]; out and g [C, D, h, w], the layout the 3D
// U-Net kernel (conv3d.cu) reads and writes. The backward's scratch:
// warp_bwd.cuh's Aux, then int64 quanta [V-1, h, w, C].
//
// Backward bound. The old float-atomic backward was bound by its
// atomics, one per tap and channel of every sample, each lane on its own
// sector. Here they are one integer add per flushed in-image tap and
// channel (fewer by the merge factor, the group's C lanes in one
// coalesced request) and no longer set the time: a build that flushes
// every plane, with 4-7x the adds, takes 3-33 % longer
// (tools/ab_warp_bwd.py, PERF.md). What bounds it is the work per plane
// and lane: V-1 projections, 4(V-1) gathers and the run bookkeeping, done
// by each lane of a group. The bytes of g are small (one read, plus one
// for its maximum), but g is [C, D, h, w], so a group's lanes would read
// it at stride D*h*w, C sectors for C floats: a block stages 8 planes of
// g for its 256 / C consecutive pixels in shared memory, read in runs of
// 256 / C consecutive floats, and each lane reads its own channel from
// there.
#include <cuda_runtime.h>

#include "warp_bwd.cuh"
#include "warp_common.cuh"
#include "warp_fwd.cuh"

namespace {

using warp::kMaxViews;

// K1's epilogue of the forward sweep (warp_fwd.cuh): sum x and sum x^2 start
// at the reference view, each source view adds its float4, and the plane
// stages its C variances, one row per channel of out [C, D, h, w].
struct VarianceEpi {
  float* out;
  float inv_v;
  long long plane;                         // D * h * w
  float4 ref, ref_sq;

  __device__ void begin(float4 r) {
    ref = r;
    ref_sq = make_float4(__fmul_rn(r.x, r.x), __fmul_rn(r.y, r.y),
                         __fmul_rn(r.z, r.z), __fmul_rn(r.w, r.w));
  }
  __device__ void start(float4& sum, float4& sq) const {
    sum = ref;
    sq = ref_sq;
  }
  __device__ void add(float4& sum, float4& sq, const float4& val) const {
    sum.x = __fadd_rn(sum.x, val.x);
    sum.y = __fadd_rn(sum.y, val.y);
    sum.z = __fadd_rn(sum.z, val.z);
    sum.w = __fadd_rn(sum.w, val.w);
    sq.x = __fadd_rn(sq.x, __fmul_rn(val.x, val.x));
    sq.y = __fadd_rn(sq.y, __fmul_rn(val.y, val.y));
    sq.z = __fadd_rn(sq.z, __fmul_rn(val.z, val.z));
    sq.w = __fadd_rn(sq.w, __fmul_rn(val.w, val.w));
  }
  // variance of the 4 channels into staging rows 4q .. 4q + 3
  template <int L, int S>
  __device__ void stage(float* so, int PS, int j, int q, const float4& sum,
                        const float4& sq, const warp::Taps (&)[S]) const {
    const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
    const float q4[4] = {sq.x, sq.y, sq.z, sq.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float mean = __fmul_rn(s4[k], inv_v);
      so[(4 * q + k) * PS + j] =
          __fsub_rn(__fmul_rn(q4[k], inv_v), __fmul_rn(mean, mean));
    }
  }
  __device__ float* row(int r) const { return out + r * plane; }
};

// K1: the forward sweep with VarianceEpi; NV bounds the source views
// (V - 1), the grid is fwd_plan's.
template <int C, int NV>
__global__ void __launch_bounds__(warp::kFwdThreads)
warp_variance_kernel(const float* __restrict__ src,
                     const float* __restrict__ rel,
                     const float* __restrict__ lo,
                     const float* __restrict__ step,
                     float* __restrict__ out,
                     int V, int H, int W, int D, int DC) {
  __shared__ float s_rel[kMaxViews * 16];
  __shared__ float s_out[2 * C * warp::FwdLanes<C, NV>::PS];
  VarianceEpi epi{out, 1.f / (float)V, (long long)D * H * W};
  warp::fwd_sweep<C, NV>(epi, s_rel, rel, src, lo, step, s_out, C, V, H, W,
                         D, DC);
}

constexpr int kPlaneChunk = 8;     // planes of g staged per __syncthreads

// K6: one group of C lanes per reference pixel (256 / C pixels a block);
// NV bounds the source views (V - 1) the registers hold.
template <int C, int NV>
__global__ void __launch_bounds__(warp::kBwdThreads)
warp_variance_bwd_kernel(const float* __restrict__ src,
                         const float* __restrict__ rel,
                         const float* __restrict__ lo,
                         const float* __restrict__ step,
                         const float* __restrict__ g,
                         float* __restrict__ dsrc,
                         unsigned long long* __restrict__ acc,
                         const warp::Quantum* __restrict__ quantum,
                         int V, int H, int W, int D) {
  constexpr int P = warp::kBwdThreads / C;
  __shared__ float s_rel[kMaxViews * 16];
  __shared__ float s_g[kPlaneChunk][P][C + 1];
  for (int i = threadIdx.x; i < V * 16; i += blockDim.x) s_rel[i] = rel[i];

  const long long HW = (long long)H * W;
  const int j = threadIdx.x / C, c = threadIdx.x % C;
  const long long p0 = (long long)blockIdx.x * P;
  const long long pix = p0 + j;
  const bool live = pix < HW;
  const int y = live ? (int)(pix / W) : 0;
  const float fx = live ? (float)(pix - (long long)y * W) : 0.f;
  const float fy = (float)y;
  const float lo_p = live ? lo[pix] : 0.f, step_p = live ? step[pix] : 0.f;
  const float ref = live ? warp::load1(src + pix * C + c) : 0.f;
  const double to_q = quantum->to_q;
  const int nv = V - 1;
  const float fv = (float)V;
  const float scale = 2.f / fv;

  warp::TapRun run[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) warp::run_start(run[v]);
  float dref = 0.f;

  for (int d0 = 0; d0 < D; d0 += kPlaneChunk) {
    __syncthreads();               // s_rel loaded; last chunk's reads done
    for (int i = threadIdx.x; i < kPlaneChunk * C * P; i += blockDim.x) {
      const int jj = i % P, cc = (i / P) % C, dd = i / (P * C);
      const long long pp = p0 + jj;
      const int d = d0 + dd;
      s_g[dd][jj][cc] = pp < HW && d < D
          ? warp::load1(g + ((long long)cc * D + d) * HW + pp) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int dn = min(kPlaneChunk, D - d0);
    for (int dd = 0; dd < dn; ++dd) {
      const float dv = warp::plane_depth(lo_p, step_p, d0 + dd);
      warp::Taps t[NV];
      float x[NV];
      float sum = ref;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v >= nv) break;
        const long long vo = (long long)(v + 1) * HW * C;
        t[v] = warp::project(s_rel + (v + 1) * 16, fx, fy, dv, H, W);
        x[v] = warp::sample_lane<C>(src + vo, t[v], H, W, c);
        sum += x[v];
      }
      const float mean = sum / fv;
      const float gs = scale * s_g[dd][j][c];
      dref += gs * (ref - mean);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v >= nv) break;
        if (!warp::same_run(run[v], t[v])) {
          warp::flush_taps<C>(acc + (long long)v * HW * C, run[v].x0,
                              run[v].y0, run[v].acc, H, W, c, to_q);
          warp::run_restart(run[v], t[v]);
        }
        warp::run_add(run[v], t[v], gs * (x[v] - mean));
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (v >= nv) break;
    warp::flush_taps<C>(acc + (long long)v * HW * C, run[v].x0, run[v].y0,
                        run[v].acc, H, W, c, to_q);
  }
  warp::store_out(dsrc + pix * C + c, dref);
}

template <int C, int NV>
cudaError_t launch(const float* src, const float* rel, const float* lo,
                   const float* step, float* out, int V, int H, int W, int D,
                   cudaStream_t stream) {
  const warp::Plan p = warp::fwd_plan(H, W, C, D);
  warp_variance_kernel<C, NV>
      <<<dim3((unsigned)p.nx, (unsigned)p.nz), warp::kFwdThreads, 0,
         stream>>>(
          src, rel, lo, step, out, V, H, W, D, p.dc);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_views(const float* src, const float* rel, const float* lo,
                         const float* step, float* out, int V, int H, int W,
                         int D, cudaStream_t s) {
  if (V <= 4) return launch<C, 3>(src, rel, lo, step, out, V, H, W, D, s);
  if (V <= 8) return launch<C, 7>(src, rel, lo, step, out, V, H, W, D, s);
  return launch<C, 15>(src, rel, lo, step, out, V, H, W, D, s);
}

template <int C, int NV>
void launch_bwd(const float* src, const float* rel, const float* lo,
                const float* step, const float* g, float* dsrc,
                unsigned long long* acc, const warp::Quantum* q, int V,
                int H, int W, int D, cudaStream_t stream) {
  constexpr int P = warp::kBwdThreads / C;
  const long long HW = (long long)H * W;
  warp_variance_bwd_kernel<C, NV>
      <<<(unsigned)((HW + P - 1) / P), warp::kBwdThreads, 0, stream>>>(
          src, rel, lo, step, g, dsrc, acc, q, V, H, W, D);
}

template <int C>
void launch_bwd_views(const float* src, const float* rel, const float* lo,
                      const float* step, const float* g, float* dsrc,
                      unsigned long long* acc, const warp::Quantum* q, int V,
                      int H, int W, int D, cudaStream_t stream) {
  if (V <= 4)
    launch_bwd<C, 3>(src, rel, lo, step, g, dsrc, acc, q, V, H, W, D, stream);
  else if (V <= 8)
    launch_bwd<C, 7>(src, rel, lo, step, g, dsrc, acc, q, V, H, W, D, stream);
  else
    launch_bwd<C, 15>(src, rel, lo, step, g, dsrc, acc, q, V, H, W, D,
                      stream);
}

cudaError_t forward(const float* src, const float* rel, const float* lo,
                    const float* step, float* out, int V, int H, int W, int C,
                    int D, cudaStream_t s) {
  if (V < 1 || V > kMaxViews || D < 1 || (long long)H * W < 1)
    return cudaErrorInvalidValue;
  switch (C) {
    case 8: return launch_views<8>(src, rel, lo, step, out, V, H, W, D, s);
    case 16: return launch_views<16>(src, rel, lo, step, out, V, H, W, D, s);
    case 32: return launch_views<32>(src, rel, lo, step, out, V, H, W, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int warp_variance_f32(const float* src, const float* rel,
                                 const float* lo, const float* step,
                                 float* out, int V, int H, int W, int C,
                                 int D, void* stream) {
  return (int)forward(src, rel, lo, step, out, V, H, W, C, D,
                      (cudaStream_t)stream);
}

// Bytes of the scratch warp_variance_bwd_f32 takes (any contents).
extern "C" long long warp_variance_bwd_scratch_bytes(int V, int H, int W,
                                                     int C) {
  return warp::variance_bwd_scratch_bytes(V, H, W, C);
}

namespace {

int backward(const float* src, const float* rel, const float* lo,
             const float* step, const float* g, float* dsrc, void* scratch,
             int V, int H, int W, int C, int D, void* stream) {
  if (V < 1 || V > kMaxViews) return (int)cudaErrorInvalidValue;
  if (C != 8 && C != 16 && C != 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long HW = (long long)H * W;
  warp::Aux* aux = static_cast<warp::Aux*>(scratch);
  auto* acc = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + warp::kAuxBytes);
  warp::AbsMaxArgs a{{src, g, nullptr, nullptr},
                     {V * HW * C, C * D * HW, 0, 0},
                     {false, false, false, false}};
  warp::prepare_scratch(scratch,
                        warp_variance_bwd_scratch_bytes(V, H, W, C), a,
                        D * HW, V, false, s);
  switch (C) {
    case 8: launch_bwd_views<8>(src, rel, lo, step, g, dsrc, acc, aux->q,
                                V, H, W, D, s); break;
    case 16: launch_bwd_views<16>(src, rel, lo, step, g, dsrc, acc, aux->q,
                                  V, H, W, D, s); break;
    default: launch_bwd_views<32>(src, rel, lo, step, g, dsrc, acc, aux->q,
                                  V, H, W, D, s); break;
  }
  warp::finish_quanta(acc, dsrc + HW * C, (V - 1) * HW * C, C, C, aux->q,
                      s);
  return (int)cudaGetLastError();
}

}  // namespace

// K6. Every element of dsrc is written; scratch holds
// warp_variance_bwd_scratch_bytes(V, H, W, C) bytes.
extern "C" int warp_variance_bwd_f32(const float* src, const float* rel,
                                     const float* lo, const float* step,
                                     const float* g, float* dsrc,
                                     void* scratch, int V, int H, int W,
                                     int C, int D, void* stream) {
  return backward(src, rel, lo, step, g, dsrc, scratch, V, H, W, C, D,
                  stream);
}
