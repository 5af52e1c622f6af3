// Stage-1 train volume kernel (float32) and its backward, for Hopper. The
// bf16 pair (K7-bf16, K7bwd-bf16) has a source of its own,
// warp_volume_bf16.cu.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_warp_volume.py
// plane_sweep_volume_fused_train (:263; forward _warp_vol_fwd_kernel :101,
// pallas_call :340). In ONE sweep over (depth plane d, ref pixel) it
// writes the volumes the clean train pass needs at stage 1:
//   var     variance over all V views (reference included)  -> U-Net
//   vol     the render branch's volume_feature, in its layout:
//           rows [0, 3(V-1))       the V-1 warped source images,
//                                  view-major (wimg)
//           rows [3(V-1), +C)      the variance over the V-1 source
//                                  views, divided by V (the
//                                  reference's no_ref bookkeeping)
// Features and images are separate tensors sampled with the same taps.
//
// Forward design: the block skeleton of K1 (warp_fwd.cuh) with its own
// epilogue (VolumeEpi below): a group of C/4 lanes per reference pixel,
// one float4 of channels a lane, the plane loop in the block (K1's
// fwd_plan chunking), rot * [x, y, 1] once per pixel, each view projected
// by one lane and its taps passed on with __shfl_sync, view v's RGB
// sampled by the lane that projected it, and per plane the block's var,
// image and no-ref rows staged in shared memory and written as runs of
// P consecutive floats. The first port (one thread per (plane, pixel)
// holding 2C sums and projecting every view) gathered 4C-byte rows a
// thread apart (K1's old L1-wavefront fault) and swept whole source
// images once per plane. Writing vol in the render branch's layout saves
// the caller a concatenation and a stack (two copies of the volume). The
// per-channel arithmetic is the first port's operation for operation, so
// the output is the same bit for bit (tools/ab_warp_fwd.py holds builds
// to each other with torch.equal).
//
// Backward: with mean = (ref + sum_v x_v) / V and mean_nr = sum_v x_v / V,
//   dL/dx_v   = (2/V) g_var (x_v - mean) + (2/V) g_nr (x_v - mean_nr)
//   dL/dref   = (2/V) g_var (ref - mean)
//   dL/dimg_v = the image cotangent of view v,
// each applied through Warp_v^T (four bilinear taps) to dfeat and dimg;
// the reference's lands on its own pixel, dimg[0] is zero. It replaces
// the same function's backward (_warp_vol_bwd_kernel :178, pallas_call
// :406) and is built as K6 (warp_variance.cu): a group of C lanes owns
// one reference pixel and walks its planes in order, samples each source
// view once per plane (x_v kept in registers), sums the reference's
// cotangent in a register and merges each view's feature cotangent
// (every lane) and image cotangent (lanes 0-2) into runs of planes with
// one top-left tap, which it flushes as 64-bit fixed-point integer adds
// (warp_bwd.cuh): the result is the same bit for bit in every run. No
// float atomics. The features and the images get a quantum each. The
// caller passes g_img and g_nr as the two row slices of vol's cotangent.
//
// Layouts: feats / dfeat [V, h, w, C], imgs / dimg [V, h, w, 3]
// channels-last; rel [V, 16]; lo, step [h, w]; var, g_var, g_nr
// [C, D, h, w]; vol [3 (V-1) + C, D, h, w], g_img [3 (V-1), D, h, w]. The
// backward's scratch: warp_bwd.cuh's Aux, int64 feature quanta
// [V-1, h, w, C], int64 image quanta [V-1, h, w, 4] (channel 3 unused:
// one 32-byte sector a pixel).
//
// Bound: device-memory bytes forward ((2C + 3(V-1)) floats written per
// plane and pixel; the gathers hot in L1/L2); backward, as K6's, the work
// per plane and lane (projections, gathers, run bookkeeping), not its
// integer atomics (one per flushed in-image tap and channel, C + 3
// channels). A block stages the cotangents in shared memory 4 planes at a
// time (g_var, g_nr and g_img are plane-major, so a group's lanes would
// read them at stride D*h*w).
#include <cuda_runtime.h>

#include "warp_bwd.cuh"
#include "warp_common.cuh"
#include "warp_fwd.cuh"

namespace {

using warp::kMaxViews;

// Bilinear sample of the 3 channels of image base [H, W, 3] at taps t:
// taps 0..3, one fused multiply-add each, zero outside.
__device__ __forceinline__ void sample_rgb(const float* base,
                                           const warp::Taps& t, int H, int W,
                                           float* rgb) {
  rgb[0] = rgb[1] = rgb[2] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long p = warp::tap_pixel(t, k, H, W);
    if (p < 0) continue;
    const float wgt = warp::tap_weight(t, k);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = __fmaf_rn(wgt, warp::load1(base + p * 3 + c), rgb[c]);
  }
}

// K7's epilogue of the forward sweep (warp_fwd.cuh). Sum x and sum x^2
// run over the source views only (the no-ref variance's sums); the
// reference joins them for the variance. A plane stages 2C + 3(V-1)
// rows: var's C channels, then vol's rows in vol's order, the V-1 warped
// images (view v's RGB sampled by the lane that projected view v, at its
// own taps) and the C no-ref variances. The arithmetic per channel is
// the first port's (one thread per plane and pixel), operation for
// operation: views in order, x^2 summed with one fused multiply-add,
// IEEE divisions by V, the reference added last.
template <int C>
struct VolumeEpi {
  const float* imgs;
  float* var;
  float* vol;
  float fv;
  int nv, H, W;
  long long HW, plane;                     // h * w, D * h * w
  float4 ref;

  __device__ void begin(float4 r) { ref = r; }
  __device__ void start(float4& sum, float4& sq) const {
    sum = sq = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ void add(float4& sum, float4& sq, const float4& val) const {
    sum.x = __fadd_rn(sum.x, val.x);
    sum.y = __fadd_rn(sum.y, val.y);
    sum.z = __fadd_rn(sum.z, val.z);
    sum.w = __fadd_rn(sum.w, val.w);
    sq.x = __fmaf_rn(val.x, val.x, sq.x);
    sq.y = __fmaf_rn(val.y, val.y, sq.y);
    sq.z = __fmaf_rn(val.z, val.z, sq.z);
    sq.w = __fmaf_rn(val.w, val.w, sq.w);
  }
  template <int L, int S>
  __device__ void stage(float* so, int PS, int j, int q, const float4& sum,
                        const float4& sq, const warp::Taps (&mine)[S]) const {
    const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
    const float q4[4] = {sq.x, sq.y, sq.z, sq.w};
    const float r4[4] = {ref.x, ref.y, ref.z, ref.w};
    float* nr = so + (C + 3 * nv) * PS;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float m_nr = __fdiv_rn(s4[k], fv);
      nr[(4 * q + k) * PS + j] =
          __fmaf_rn(-m_nr, m_nr, __fdiv_rn(q4[k], fv));
      const float r = r4[k];
      const float m = __fdiv_rn(__fadd_rn(s4[k], r), fv);
      so[(4 * q + k) * PS + j] =
          __fmaf_rn(-m, m, __fdiv_rn(__fmaf_rn(r, r, q4[k]), fv));
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int v = s * L + q;
      if (v >= nv) break;
      float rgb[3];
      sample_rgb(imgs + (long long)(v + 1) * HW * 3, mine[s], H, W, rgb);
#pragma unroll
      for (int c = 0; c < 3; ++c) so[(C + 3 * v + c) * PS + j] = rgb[c];
    }
  }
  // var's rows, then vol's
  __device__ float* row(int r) const {
    return r < C ? var + r * plane : vol + (r - C) * plane;
  }
};

// K7's forward: the sweep with VolumeEpi; NV bounds the source views
// (V - 1), the grid is fwd_plan's (K1's), the staging buffer dynamic
// shared memory of fwd_smem_bytes.
template <int C, int NV>
__global__ void __launch_bounds__(warp::kFwdThreads)
warp_volume_kernel(const float* __restrict__ feats,
                   const float* __restrict__ imgs,
                   const float* __restrict__ rel,
                   const float* __restrict__ lo,
                   const float* __restrict__ step,
                   float* __restrict__ var, float* __restrict__ vol,
                   int V, int H, int W, int D, int DC) {
  extern __shared__ float s_out[];
  __shared__ float s_rel[kMaxViews * 16];
  const long long HW = (long long)H * W;
  VolumeEpi<C> epi{imgs, var, vol, (float)V, V - 1, H, W, HW, D * HW};
  warp::fwd_sweep<C, NV>(epi, s_rel, rel, feats, lo, step, s_out,
                         2 * C + 3 * (V - 1), V, H, W, D, DC);
}

template <int C, int NV>
int fwd_smem_bytes(int V) {
  return 2 * (2 * C + 3 * (V - 1)) * warp::FwdLanes<C, NV>::PS
      * (int)sizeof(float);
}

template <int C, int NV>
cudaError_t launch_fwd(const float* feats, const float* imgs,
                       const float* rel, const float* lo, const float* step,
                       float* var, float* vol, int V, int H, int W, int D,
                       cudaStream_t s) {
  const warp::Plan p = warp::fwd_plan(H, W, C, D);
  const int smem = fwd_smem_bytes<C, NV>(V);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_volume_kernel<C, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  warp_volume_kernel<C, NV>
      <<<dim3((unsigned)p.nx, (unsigned)p.nz), warp::kFwdThreads, smem,
         s>>>(feats, imgs, rel, lo, step, var, vol, V, H, W, D, p.dc);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_fwd_views(const float* feats, const float* imgs,
                             const float* rel, const float* lo,
                             const float* step, float* var, float* vol,
                             int V, int H, int W, int D, cudaStream_t s) {
  if (V <= 4)
    return launch_fwd<C, 3>(feats, imgs, rel, lo, step, var, vol, V, H, W,
                            D, s);
  if (V <= 8)
    return launch_fwd<C, 7>(feats, imgs, rel, lo, step, var, vol, V, H, W,
                            D, s);
  return launch_fwd<C, 15>(feats, imgs, rel, lo, step, var, vol, V, H, W, D,
                           s);
}

constexpr int kPlaneChunk = 4;     // planes of cotangents staged at once

// K7's backward: one group of C lanes per reference pixel (256 / C pixels
// a block); NV bounds the source views (V - 1) the registers hold.
template <int C, int NV>
__global__ void __launch_bounds__(warp::kBwdThreads)
warp_volume_bwd_kernel(const float* __restrict__ feats,
                       const float* __restrict__ rel,
                       const float* __restrict__ lo,
                       const float* __restrict__ step,
                       const float* __restrict__ g_var,
                       const float* __restrict__ g_nr,
                       const float* __restrict__ g_img,
                       float* __restrict__ dfeat,
                       unsigned long long* __restrict__ acc_f,
                       unsigned long long* __restrict__ acc_i,
                       const warp::Quantum* __restrict__ quantum,
                       int V, int H, int W, int D) {
  constexpr int P = warp::kBwdThreads / C;
  __shared__ float s_rel[kMaxViews * 16];
  __shared__ float s_gv[kPlaneChunk][P][C + 1];
  __shared__ float s_gn[kPlaneChunk][P][C + 1];
  __shared__ float s_gi[kPlaneChunk][P][3 * NV];
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
  const float ref = live ? warp::load1(feats + pix * C + c) : 0.f;
  const double to_qf = quantum[0].to_q, to_qi = quantum[1].to_q;
  const int nv = V - 1, ni = 3 * nv;
  const float fv = (float)V;
  const float scale = 2.f / fv;

  warp::TapRun run[NV];
  float acc_img[NV][4];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    warp::run_start(run[v]);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_img[v][k] = 0.f;
  }
  float dref = 0.f;

  for (int d0 = 0; d0 < D; d0 += kPlaneChunk) {
    __syncthreads();               // s_rel loaded; last chunk's reads done
    for (int i = threadIdx.x; i < kPlaneChunk * C * P; i += blockDim.x) {
      const int jj = i % P, cc = (i / P) % C, dd = i / (P * C);
      const long long pp = p0 + jj;
      const int d = d0 + dd;
      const bool in = pp < HW && d < D;
      const long long at = ((long long)cc * D + d) * HW + pp;
      s_gv[dd][jj][cc] = in ? warp::load1(g_var + at) : 0.f;
      s_gn[dd][jj][cc] = in ? warp::load1(g_nr + at) : 0.f;
    }
    for (int i = threadIdx.x; i < kPlaneChunk * ni * P; i += blockDim.x) {
      const int jj = i % P, ci = (i / P) % ni, dd = i / (P * ni);
      const long long pp = p0 + jj;
      const int d = d0 + dd;
      s_gi[dd][jj][ci] = pp < HW && d < D
          ? warp::load1(g_img + ((long long)ci * D + d) * HW + pp) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int dn = min(kPlaneChunk, D - d0);
    for (int dd = 0; dd < dn; ++dd) {
      const float dv = warp::plane_depth(lo_p, step_p, d0 + dd);
      warp::Taps t[NV];
      float x[NV];
      float sum = 0.f;                 // source views only
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v >= nv) break;
        const long long vo = (long long)(v + 1) * HW * C;
        t[v] = warp::project(s_rel + (v + 1) * 16, fx, fy, dv, H, W);
        x[v] = warp::sample_lane<C>(feats + vo, t[v], H, W, c);
        sum += x[v];
      }
      const float m = (sum + ref) / fv, m_nr = sum / fv;
      const float gv = scale * s_gv[dd][j][c], gn = scale * s_gn[dd][j][c];
      dref += gv * (ref - m);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v >= nv) break;
        if (!warp::same_run(run[v], t[v])) {
          warp::flush_taps<C>(acc_f + (long long)v * HW * C, run[v].x0,
                              run[v].y0, run[v].acc, H, W, c, to_qf);
          if (c < 3)
            warp::flush_taps<4>(acc_i + (long long)v * HW * 4, run[v].x0,
                                run[v].y0, acc_img[v], H, W, c, to_qi);
          warp::run_restart(run[v], t[v]);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc_img[v][k] = 0.f;
        }
        warp::run_add(run[v], t[v],
                         gv * (x[v] - m) + gn * (x[v] - m_nr));
        if (c < 3) {
          const float gi = s_gi[dd][j][3 * v + c];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc_img[v][k] = __fmaf_rn(warp::tap_weight(t[v], k), gi,
                                      acc_img[v][k]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (v >= nv) break;
    warp::flush_taps<C>(acc_f + (long long)v * HW * C, run[v].x0, run[v].y0,
                        run[v].acc, H, W, c, to_qf);
    if (c < 3)
      warp::flush_taps<4>(acc_i + (long long)v * HW * 4, run[v].x0,
                          run[v].y0, acc_img[v], H, W, c, to_qi);
  }
  warp::store_out(dfeat + pix * C + c, dref);
}

template <int C, int NV>
void launch_bwd(const float* feats, const float* rel, const float* lo,
                const float* step, const float* g_var, const float* g_nr,
                const float* g_img, float* dfeat, unsigned long long* acc_f,
                unsigned long long* acc_i, const warp::Quantum* q, int V,
                int H, int W, int D, cudaStream_t s) {
  constexpr int P = warp::kBwdThreads / C;
  const long long HW = (long long)H * W;
  warp_volume_bwd_kernel<C, NV>
      <<<(unsigned)((HW + P - 1) / P), warp::kBwdThreads, 0, s>>>(
          feats, rel, lo, step, g_var, g_nr, g_img, dfeat, acc_f, acc_i, q,
          V, H, W, D);
}

template <int C>
void launch_bwd_views(const float* feats, const float* rel, const float* lo,
                      const float* step, const float* g_var,
                      const float* g_nr, const float* g_img, float* dfeat,
                      unsigned long long* acc_f, unsigned long long* acc_i,
                      const warp::Quantum* q, int V, int H, int W, int D,
                      cudaStream_t s) {
  if (V <= 4)
    launch_bwd<C, 3>(feats, rel, lo, step, g_var, g_nr, g_img, dfeat, acc_f,
                     acc_i, q, V, H, W, D, s);
  else if (V <= 8)
    launch_bwd<C, 7>(feats, rel, lo, step, g_var, g_nr, g_img, dfeat, acc_f,
                     acc_i, q, V, H, W, D, s);
  else
    launch_bwd<C, 15>(feats, rel, lo, step, g_var, g_nr, g_img, dfeat,
                      acc_f, acc_i, q, V, H, W, D, s);
}

}  // namespace

// K7's forward: var [C, D, h, w] and vol [3 (V-1) + C, D, h, w] (the
// warped source images, view-major, then the no-ref variance).
extern "C" int warp_volume_f32(const float* feats, const float* imgs,
                               const float* rel, const float* lo,
                               const float* step, float* var, float* vol,
                               int V, int H, int W, int C, int D,
                               void* stream) {
  if (V < 2 || V > kMaxViews || D < 1 || (long long)H * W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8: return (int)launch_fwd_views<8>(feats, imgs, rel, lo, step, var,
                                            vol, V, H, W, D, s);
    case 16: return (int)launch_fwd_views<16>(feats, imgs, rel, lo, step,
                                              var, vol, V, H, W, D, s);
    case 32: return (int)launch_fwd_views<32>(feats, imgs, rel, lo, step,
                                              var, vol, V, H, W, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bytes of the scratch warp_volume_bwd_f32 takes (any contents).
extern "C" long long warp_volume_bwd_scratch_bytes(int V, int H, int W,
                                                   int C) {
  return warp::kAuxBytes + 8LL * (V - 1) * H * W * (C + 4);
}

// K7's backward. Every element of dfeat and dimg is written; scratch holds
// warp_volume_bwd_scratch_bytes(V, H, W, C) bytes.
extern "C" int warp_volume_bwd_f32(const float* feats, const float* rel,
                                   const float* lo, const float* step,
                                   const float* g_var, const float* g_nr,
                                   const float* g_img, float* dfeat,
                                   float* dimg, void* scratch, int V, int H,
                                   int W, int C, int D, void* stream) {
  if (V < 2 || V > kMaxViews) return (int)cudaErrorInvalidValue;
  if (C != 8 && C != 16 && C != 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long HW = (long long)H * W;
  warp::Aux* aux = static_cast<warp::Aux*>(scratch);
  auto* acc_f = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + warp::kAuxBytes);
  unsigned long long* acc_i = acc_f + (V - 1) * HW * C;
  const long long plane = (long long)D * HW;
  warp::AbsMaxArgs a{{feats, g_var, g_nr, g_img},
                     {V * HW * C, C * plane, C * plane, 3 * (V - 1) * plane},
                     {false, false, false, false}};
  warp::prepare_scratch(scratch, warp_volume_bwd_scratch_bytes(V, H, W, C),
                        a, plane, V, true, s);
  switch (C) {
    case 8: launch_bwd_views<8>(feats, rel, lo, step, g_var, g_nr, g_img,
                                dfeat, acc_f, acc_i, aux->q, V, H, W, D, s);
      break;
    case 16: launch_bwd_views<16>(feats, rel, lo, step, g_var, g_nr, g_img,
                                  dfeat, acc_f, acc_i, aux->q, V, H, W, D, s);
      break;
    default: launch_bwd_views<32>(feats, rel, lo, step, g_var, g_nr, g_img,
                                  dfeat, acc_f, acc_i, aux->q, V, H, W, D, s);
      break;
  }
  cudaMemsetAsync(dimg, 0, sizeof(float) * HW * 3, s);
  warp::finish_quanta(acc_f, dfeat + HW * C, (V - 1) * HW * C, C, C, aux->q,
                      s);
  warp::finish_quanta(acc_i, dimg + HW * 3, (V - 1) * HW * 3, 4, 3,
                      aux->q + 1, s);
  return (int)cudaGetLastError();
}
