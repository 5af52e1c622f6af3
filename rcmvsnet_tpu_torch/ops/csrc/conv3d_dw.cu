// Weight gradient of the cost-volume U-Net's 3x3x3 convolution (float32),
// for Hopper.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_costreg_train.py
// _conv_dw (_dw_kernel), the weight half of conv_lanes_t's custom VJP.
// For each of conv3d.cu's three modes (same tap map, same layouts):
//   dW[co, ci, k] = sum over n and output positions o of
//                   g[n, co, o] * x[n, ci, tap(o, k)]
// with tap(o, k) the input index that output o reads with tap k (stride 1,
// stride 2, or the transposed gather; -1 outside the input).
//
// Design: pass 1 gives each block one input channel (gridDim.y), CO_T
// output channels (gridDim.z) and one chunk of output positions
// (gridDim.x). Every thread walks positions of its chunk 256 apart, loads
// the 27 taps of x once and the CO_T values of g, and keeps CO_T x 27
// partial sums in registers; the block reduces them (warp shuffles, then
// across warps in shared memory, in a fixed order) and writes one partial
// per chunk. Pass 2 sums the chunks in order. No atomics: the result is
// the same from run to run.
//
// Layouts: x [N, Ci, Di, Hi, Wi]; g [N, Co, Do, Ho, Wo]; partial
// [chunks, Co, Ci, 27]; dw [Co, Ci, 27] (for mode 2 the caller transposes
// it back to the ConvTranspose3d layout [Ci, Co, 3, 3, 3]).
//
// Bound: the SMs' load and FMA throughput: each position's 27 x loads
// feed 27 x CO_T FMAs; x is read once per output-channel tile and g once
// per input channel, both from L2 after the first touch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int MODE>
__device__ __forceinline__ int tap_index(int o, int k, int in_size) {
  if (MODE == 0) {
    const int i = o + k - 1;
    return (i >= 0 && i < in_size) ? i : -1;
  } else if (MODE == 1) {
    const int i = 2 * o + k - 1;
    return (i >= 0 && i < in_size) ? i : -1;
  } else {
    const int t = o + 1 - k;
    if (t < 0 || (t & 1)) return -1;
    const int i = t >> 1;
    return i < in_size ? i : -1;
  }
}

template <int CO_T, int MODE>
__global__ void __launch_bounds__(kThreads)
conv3d_dw_partial(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ partial, int N, int Ci, int Di, int Hi,
                  int Wi, int Co, int Do, int Ho, int Wo, long long chunk) {
  const int ci = blockIdx.y;
  const int co0 = blockIdx.z * CO_T;
  const long long out_sp = (long long)Do * Ho * Wo;
  const long long in_sp = (long long)Di * Hi * Wi;
  const long long total = (long long)N * out_sp;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min(begin + chunk, total);

  float acc[CO_T][27];
#pragma unroll
  for (int j = 0; j < CO_T; ++j)
#pragma unroll
    for (int k = 0; k < 27; ++k) acc[j][k] = 0.f;

  for (long long idx = begin + threadIdx.x; idx < end; idx += kThreads) {
    const int n = (int)(idx / out_sp);
    const long long sp = idx - (long long)n * out_sp;
    const int oz = (int)(sp / ((long long)Ho * Wo));
    const long long r = sp - (long long)oz * Ho * Wo;
    const int oy = (int)(r / Wo);
    const int ox = (int)(r - (long long)oy * Wo);
    float gv[CO_T];
#pragma unroll
    for (int j = 0; j < CO_T; ++j)
      gv[j] = __ldg(g + ((long long)n * Co + co0 + j) * out_sp + sp);
    const float* xc = x + ((long long)n * Ci + ci) * in_sp;
    int iz[3], iy[3], ix[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      iz[k] = tap_index<MODE>(oz, k, Di);
      iy[k] = tap_index<MODE>(oy, k, Hi);
      ix[k] = tap_index<MODE>(ox, k, Wi);
    }
#pragma unroll
    for (int kz = 0; kz < 3; ++kz) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const bool ok = iz[kz] >= 0 && iy[ky] >= 0 && ix[kx] >= 0;
          const float v = ok ? __ldg(xc + ((long long)iz[kz] * Hi + iy[ky])
                                              * Wi + ix[kx])
                             : 0.f;
#pragma unroll
          for (int j = 0; j < CO_T; ++j)
            acc[j][kz * 9 + ky * 3 + kx] =
                fmaf(gv[j], v, acc[j][kz * 9 + ky * 3 + kx]);
        }
      }
    }
  }

  __shared__ float red[kWarps][CO_T * 27];
  const int lane = threadIdx.x & 31, warp_id = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < CO_T; ++j) {
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      float v = acc[j][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp_id][j * 27 + k] = v;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < CO_T * 27; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][e];
    const int j = e / 27, k = e - j * 27;
    partial[(((long long)blockIdx.x * Co + co0 + j) * Ci + ci) * 27 + k] = s;
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

template <int CO_T, int MODE>
cudaError_t launch(const float* x, const float* g, float* partial, float* dw,
                   int N, int Ci, int Di, int Hi, int Wi, int Co, int Do,
                   int Ho, int Wo, int chunks, cudaStream_t s) {
  const long long total = (long long)N * Do * Ho * Wo;
  const long long chunk = (total + chunks - 1) / chunks;
  dim3 grid((unsigned)chunks, (unsigned)Ci, (unsigned)(Co / CO_T));
  conv3d_dw_partial<CO_T, MODE><<<grid, kThreads, 0, s>>>(
      x, g, partial, N, Ci, Di, Hi, Wi, Co, Do, Ho, Wo, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_out = (long long)Co * Ci * 27;
  sum_chunks<<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0,
               s>>>(partial, dw, chunks, n_out);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_co(const float* x, const float* g, float* partial,
                        float* dw, int N, int Ci, int Di, int Hi, int Wi,
                        int Co, int Do, int Ho, int Wo, int chunks,
                        cudaStream_t s) {
  if (Co % 4 == 0)
    return launch<4, MODE>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do, Ho,
                           Wo, chunks, s);
  return launch<1, MODE>(x, g, partial, dw, N, Ci, Di, Hi, Wi, Co, Do, Ho,
                         Wo, chunks, s);
}

}  // namespace

// mode: 0 stride 1, 1 stride 2, 2 transposed (conv3d.cu's modes).
// partial holds chunks x Co x Ci x 27 floats of scratch.
extern "C" int conv3d_dw_f32(const float* x, const float* g, float* partial,
                             float* dw, int N, int Ci, int Di, int Hi, int Wi,
                             int Co, int Do, int Ho, int Wo, int mode,
                             int chunks, void* stream) {
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return (int)dispatch_co<0>(x, g, partial, dw, N, Ci, Di, Hi, Wi,
                                       Co, Do, Ho, Wo, chunks, s);
    case 1: return (int)dispatch_co<1>(x, g, partial, dw, N, Ci, Di, Hi, Wi,
                                       Co, Do, Ho, Wo, chunks, s);
    case 2: return (int)dispatch_co<2>(x, g, partial, dw, N, Ci, Di, Hi, Wi,
                                       Co, Do, Ho, Wo, chunks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

