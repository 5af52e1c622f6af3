// Direct 3x3x3 convolution of the cost-volume U-Net (float32), for Hopper.
//
// Replaces the TPU kernels rcmvsnet_tpu/ops/pallas_costreg.py conv_lanes
// (_conv_lanes_kernel, _conv_lanes_k9_kernel, composed by costreg_lanes)
// AND rcmvsnet_tpu/ops/pallas_resample.py subsample_lanes / stuff_lanes
// (_sub_kernel, _stuff_kernel): those copies exist only because the TPU
// U-Net keeps a lane layout. Here they fold into the addressing:
//   mode 0  stride 1, padding 1:   in = out + k - 1
//   mode 1  stride 2, padding 1:   in = 2*out + k - 1
//           (= subsample_lanes o conv_lanes(z_stride=2): the stride-2
//            outputs are computed directly, nothing is computed twice)
//   mode 2  transposed, k3 s2 p1 output_padding 1, as an output-stationary
//           gather over the un-stuffed input: tap k reaches output o from
//           input (o + 1 - k) / 2 when that is a whole index in range
//           (= conv_lanes o stuff_lanes, without the zero-stuffed copy).
// Epilogue: + bias (the eval BatchNorm is folded into weight and bias by
// the caller), optional ReLU, optional skip add AFTER the ReLU (the
// decoder's conv_k + deconv(x)), as in costreg_lanes.
//
// Layouts: x [N, Ci, Di, Hi, Wi]; w [Co, Ci, 27] (for mode 2 the caller
// hands the ConvTranspose3d weight [Ci, Co, 3, 3, 3] transposed to
// [Co, Ci, 27]); bias [Co]; skip and out [N, Co, Do, Ho, Wo].
//
// Bound: load/FMA issue on the SMs at these small channel counts (Ci, Co
// in 1..64): each thread owns one output voxel and CO_T output channels;
// every input value it loads feeds CO_T fused multiply-adds with weights
// broadcast from shared memory. Weights are staged through shared memory
// in chunks of CI_CHUNK input channels (conv5/conv6 hold up to 64x64x27
// floats, ~442 KB, more than a block may have), with CO_T channels per
// block along gridDim.y. Neighbouring threads are neighbouring x, so the
// input loads of a warp are coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kCiChunk = 8;
constexpr int kThreads = 128;

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
conv3d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias,
              const float* __restrict__ skip, float* __restrict__ out,
              int N, int Ci, int Di, int Hi, int Wi,
              int Co, int Do, int Ho, int Wo, int relu) {
  __shared__ float s_w[kCiChunk * 27 * CO_T];
  const int co0 = blockIdx.y * CO_T;
  const long long out_sp = (long long)Do * Ho * Wo;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = idx < (long long)N * out_sp;

  int n = 0, oz = 0, oy = 0, ox = 0;
  if (active) {
    n = (int)(idx / out_sp);
    long long r = idx - (long long)n * out_sp;
    oz = (int)(r / ((long long)Ho * Wo));
    r -= (long long)oz * Ho * Wo;
    oy = (int)(r / Wo);
    ox = (int)(r - (long long)oy * Wo);
  }
  int iz[3], iy[3], ix[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    iz[k] = tap_index<MODE>(oz, k, Di);
    iy[k] = tap_index<MODE>(oy, k, Hi);
    ix[k] = tap_index<MODE>(ox, k, Wi);
  }

  float acc[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) acc[j] = 0.f;

  const long long in_sp = (long long)Di * Hi * Wi;
  for (int ci0 = 0; ci0 < Ci; ci0 += kCiChunk) {
    const int nci = min(kCiChunk, Ci - ci0);
    __syncthreads();
    for (int i = threadIdx.x; i < nci * 27 * CO_T; i += blockDim.x) {
      const int j = i % CO_T;
      const int k = (i / CO_T) % 27;
      const int c = i / (CO_T * 27);
      s_w[i] = w[((long long)(co0 + j) * Ci + ci0 + c) * 27 + k];
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < nci; ++c) {
      const float* xc = x + ((long long)n * Ci + ci0 + c) * in_sp;
#pragma unroll
      for (int kz = 0; kz < 3; ++kz) {
        if (iz[kz] < 0) continue;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          if (iy[ky] < 0) continue;
          const float* row = xc + ((long long)iz[kz] * Hi + iy[ky]) * Wi;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            if (ix[kx] < 0) continue;
            const float v = __ldg(row + ix[kx]);
            const float* wk = s_w + (c * 27 + kz * 9 + ky * 3 + kx) * CO_T;
#pragma unroll
            for (int j = 0; j < CO_T; ++j) acc[j] = fmaf(v, wk[j], acc[j]);
          }
        }
      }
    }
  }
  if (!active) return;

  const long long o_sp = ((long long)oz * Ho + oy) * Wo + ox;
#pragma unroll
  for (int j = 0; j < CO_T; ++j) {
    const long long o = ((long long)n * Co + co0 + j) * out_sp + o_sp;
    float r = acc[j] + bias[co0 + j];
    if (relu) r = fmaxf(r, 0.f);
    if (skip != nullptr) r += skip[o];
    out[o] = r;
  }
}

template <int CO_T, int MODE>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   const float* skip, float* out, int N, int Ci, int Di,
                   int Hi, int Wi, int Co, int Do, int Ho, int Wo, int relu,
                   cudaStream_t stream) {
  const long long n = (long long)N * Do * Ho * Wo;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), Co / CO_T);
  conv3d_kernel<CO_T, MODE><<<grid, kThreads, 0, stream>>>(
      x, w, bias, skip, out, N, Ci, Di, Hi, Wi, Co, Do, Ho, Wo, relu);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_co(const float* x, const float* w, const float* bias,
                        const float* skip, float* out, int N, int Ci, int Di,
                        int Hi, int Wi, int Co, int Do, int Ho, int Wo,
                        int relu, cudaStream_t s) {
  if (Co % 16 == 0)
    return launch<16, MODE>(x, w, bias, skip, out, N, Ci, Di, Hi, Wi, Co,
                            Do, Ho, Wo, relu, s);
  if (Co % 8 == 0)
    return launch<8, MODE>(x, w, bias, skip, out, N, Ci, Di, Hi, Wi, Co, Do,
                           Ho, Wo, relu, s);
  return launch<1, MODE>(x, w, bias, skip, out, N, Ci, Di, Hi, Wi, Co, Do,
                         Ho, Wo, relu, s);
}

}  // namespace

// mode: 0 stride 1, 1 stride 2, 2 transposed (see above). skip may be null.
extern "C" int conv3d_f32(const float* x, const float* w, const float* bias,
                          const float* skip, float* out, int N, int Ci,
                          int Di, int Hi, int Wi, int Co, int Do, int Ho,
                          int Wo, int mode, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return (int)dispatch_co<0>(x, w, bias, skip, out, N, Ci, Di, Hi,
                                       Wi, Co, Do, Ho, Wo, relu, s);
    case 1: return (int)dispatch_co<1>(x, w, bias, skip, out, N, Ci, Di, Hi,
                                       Wi, Co, Do, Ho, Wo, relu, s);
    case 2: return (int)dispatch_co<2>(x, w, bias, skip, out, N, Ci, Di, Hi,
                                       Wi, Co, Do, Ho, Wo, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
