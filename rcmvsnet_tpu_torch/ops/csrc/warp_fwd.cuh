// The block skeleton of the float32 forward plane sweeps: K1
// (warp_variance.cu) and K7's forward (warp_volume.cu) instantiate it, each
// with its own epilogue (what a lane accumulates per view and what a plane
// writes).
//
// Lanes. A group of L = C / 4 lanes owns one reference pixel, lane q the
// float4 of channels [4q, 4q + 4), so one gather reads a whole 4C-byte row
// of a source map (C = 32: one 128-byte line a pixel). A block of
// kFwdThreads lanes owns P = kFwdThreads / L consecutive pixels and walks
// the planes [d0, d0 + DC) of its chunk (blockIdx.y; fwd_plan), so the
// source neighbourhood it samples stays in L1/L2 from plane to plane.
//
// Per plane: lane q projects views q, q + L, ... (rot * [x, y, 1] once per
// pixel, * dv + t per plane: rot_rows, project_mine), and the group passes
// each view's taps on with __shfl_sync (taps_of_view); every lane samples
// its float4 of each view (warp::sample_quad) and hands it to the
// epilogue's add(); the epilogue's stage() puts the plane's results of
// its lane in a shared staging buffer, rows of PS floats ([row][pixel]);
// after one barrier the block writes each row as a run of P consecutive
// floats of row(r)[d, :, :]. The two staging buffers alternate between
// planes, so one barrier a plane suffices.
//
// A pixel past the image computes the last one (its lanes take part in the
// shuffles) and writes nothing. tests/test_torch_warp_lanes.py and
// tests/test_torch_warp_volume_lanes.py emulate this skeleton with each
// epilogue.
//
// Epilogue interface (a per-thread object):
//   void begin(float4 ref)                the pixel's reference channels
//   void start(float4& sum, float4& sq)   a plane's accumulators
//   void add(float4& sum, float4& sq, float4 val)   one source view
//   template <int L, int S> void stage(float* so, int PS, int j, int q,
//       float4 sum, float4 sq, const Taps (&mine)[S])
//                                         the plane into the staging rows
//   float* row(int r)                     output row r, [D, h, w]
#pragma once
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace warp {

constexpr int kFwdThreads = 256;
// A block walks all D planes when the pixel blocks alone reach
// kTargetBlocks; otherwise the planes are cut into chunks until they do
// (132 SMs on an H100; tests/test_torch_warp_lanes.py emulates the rule).
constexpr int kTargetBlocks = 8 * 132;

struct Plan {
  int P;          // pixels a block
  long long nx;   // pixel blocks
  int dc, nz;     // planes a block walks, plane chunks
};

// ch: channels a lane (K1-bf16 and K7-bf16 give a lane 8).
inline Plan fwd_plan(int H, int W, int C, int D, int ch = 4) {
  Plan p;
  p.P = kFwdThreads / (C / ch);
  p.nx = ((long long)H * W + p.P - 1) / p.P;
  const long long want = (kTargetBlocks + p.nx - 1) / p.nx;
  const int nz = (int)(want < 1 ? 1 : want > D ? D : want);
  p.dc = (D + nz - 1) / nz;
  p.nz = (D + p.dc - 1) / p.dc;
  return p;
}

// The lane geometry at C channels and up to NV source views.
template <int C, int NV>
struct FwdLanes {
  static constexpr int L = C / 4;                 // lanes per pixel
  static constexpr int P = kFwdThreads / L;       // pixels per block
  static constexpr int PS = P + 8 / L;            // staging row: banks distinct
  static constexpr int S = (NV + L - 1) / L;      // views a lane projects
};

// The projection hand-off, for groups of L lanes a pixel of which lane q
// projects the S views q, q + L, ... of the nv source views (a lane past
// the last view projects view 0's row, unused). The bf16 kernels
// (warp_variance_bf16.cu, warp_volume_bf16.cu) use it too.

// rr: rot * [x, y, 1] of the views lane q projects, once per pixel.
template <int S, int L>
__device__ __forceinline__ void rot_rows(float (&rr)[S][3],
                                         const float* s_rel, int q, int nv,
                                         float fx, float fy) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float* m = s_rel + (s * L + q < nv ? s * L + q + 1 : 0) * 16;
#pragma unroll
    for (int r = 0; r < 3; ++r) rr[s][r] = rot_row(m + 4 * r, fx, fy);
  }
}

// The taps of the views lane q projects at depth dv, from their rr.
template <int S, int L>
__device__ __forceinline__ void project_mine(Taps (&mine)[S],
                                             const float (&rr)[S][3],
                                             const float* s_rel, int q,
                                             int nv, float dv, int H,
                                             int W) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float* m = s_rel + (s * L + q < nv ? s * L + q + 1 : 0) * 16;
    mine[s] = taps_of_rows(depth_row(rr[s][0], m[3], dv),
                           depth_row(rr[s][1], m[7], dv),
                           depth_row(rr[s][2], m[11], dv), H, W);
  }
}

// View v's taps, from the lane of the group that projected them.
template <int S, int L>
__device__ __forceinline__ Taps taps_of_view(const Taps (&mine)[S], int v) {
  const Taps& o = mine[v / L];
  return Taps{__shfl_sync(0xffffffffu, o.x0, v % L, L),
              __shfl_sync(0xffffffffu, o.y0, v % L, L),
              __shfl_sync(0xffffffffu, o.wx, v % L, L),
              __shfl_sync(0xffffffffu, o.wy, v % L, L)};
}

// The sweep of one block: src [V, H, W, C] float (view 0 the reference),
// rel [V, 16] relative projections, lo / step [H, W]; s_rel holds
// kMaxViews * 16 floats of shared memory, s_out 2 * rows * PS.
template <int C, int NV, class Epi>
__device__ __forceinline__ void fwd_sweep(Epi& epi, float* s_rel,
                                          const float* __restrict__ rel,
                                          const float* __restrict__ src,
                                          const float* __restrict__ lo,
                                          const float* __restrict__ step,
                                          float* s_out, int rows, int V,
                                          int H, int W, int D, int DC) {
  using G = FwdLanes<C, NV>;
  constexpr int L = G::L, P = G::P, PS = G::PS, S = G::S;
  for (int i = threadIdx.x; i < V * 16; i += blockDim.x) s_rel[i] = rel[i];
  __syncthreads();

  const long long HW = (long long)H * W;
  const int j = threadIdx.x / L, q = threadIdx.x % L;
  const long long p0 = (long long)blockIdx.x * P;
  const long long pix = min(p0 + j, HW - 1);
  const int y = (int)(pix / W);
  const float fx = (float)(pix - (long long)y * W), fy = (float)y;
  const float lo_p = lo[pix], step_p = step[pix];
  epi.begin(load4(src + pix * C + 4 * q));
  const int nv = V - 1;

  float rr[S][3];
  rot_rows<S, L>(rr, s_rel, q, nv, fx, fy);

  const int d0 = blockIdx.y * DC, d1 = min(D, d0 + DC);
  for (int d = d0; d < d1; ++d) {
    Taps mine[S];
    project_mine<S, L>(mine, rr, s_rel, q, nv,
                       plane_depth(lo_p, step_p, d), H, W);
    float4 sum, sq;
    epi.start(sum, sq);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (v >= nv) break;                  // the same in the whole warp
      epi.add(sum, sq,
              sample_quad<C>(src + (long long)(v + 1) * HW * C,
                             taps_of_view<S, L>(mine, v), H, W, q));
    }

    float* so = s_out + ((d - d0) & 1) * rows * PS;
    epi.template stage<L, S>(so, PS, j, q, sum, sq, mine);
    __syncthreads();
    // rows runs of P consecutive floats of row(r)[d, :, :]
    for (int i = threadIdx.x; i < rows * P; i += kFwdThreads) {
      const int r = i / P, jj = i - r * P;
      if (p0 + jj < HW)
        store_out(epi.row(r) + (long long)d * HW + p0 + jj, so[r * PS + jj]);
    }
  }
}

}  // namespace warp
