// Direct 2D convolution of the FeatureNet FPN (float32), for Hopper.
//
// Replaces the TPU kernel rcmvsnet_tpu/ops/pallas_conv2d.py conv2d_cm
// (_band_kernel), as nn/featurenet_fast.featurenet_packed chains it, and
// also runs what that chain left to XLA: the 1x1 FPN heads (matmul_cm) and
// the nearest x2 upsample-add (upsample2_cm).
//
// out[n, co, y, x] = epilogue(sum_{ci, ky, kx} w[co, ci, ky, kx] *
//                    in[n, ci, y*s + ky - p, x*s + kx - p])   (zero padding)
// epilogue: r = acc * scale[co] + shift[co]  (folded eval BatchNorm; scale
//           may be null for 1, shift null for 0, which makes shift a bias)
//           r = max(r, 0) if relu
//           r += up[n, co, y / 2, x / 2] if up is given: the FPN's
//           intra = nearest_x2(intra) + inner(conv) in one pass.
// k in {1, 3, 5}, stride in {1, 2}; N = views are batched in one launch.
//
// Layouts: NCHW everywhere; w [Co, Ci, K, K].
//
// Bound: load/FMA issue at 3..32 channels. One thread per output pixel and
// CO_T output channels; the CO_T x Ci x K x K weight tile sits in shared
// memory (at most 32 x 32 x 25 floats in this network) and is read as a
// broadcast; neighbouring threads are neighbouring x, so input loads of a
// warp are coalesced (stride 1) or two-strided (stride 2).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int K, int CO_T>
__global__ void __launch_bounds__(kThreads)
conv2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ scale,
              const float* __restrict__ shift,
              const float* __restrict__ up, float* __restrict__ out,
              int N, int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
              int stride, int pad, int relu) {
  extern __shared__ float s_w[];  // [Ci][K*K][CO_T]
  const int co0 = blockIdx.y * CO_T;
  for (int i = threadIdx.x; i < Ci * K * K * CO_T; i += blockDim.x) {
    const int j = i % CO_T;
    const int k = (i / CO_T) % (K * K);
    const int c = i / (CO_T * K * K);
    s_w[i] = w[((long long)(co0 + j) * Ci + c) * K * K + k];
  }
  __syncthreads();

  const long long out_sp = (long long)Ho * Wo;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)N * out_sp) return;
  const int n = (int)(idx / out_sp);
  const long long r = idx - (long long)n * out_sp;
  const int oy = (int)(r / Wo);
  const int ox = (int)(r - (long long)oy * Wo);
  const int y0 = oy * stride - pad, x0 = ox * stride - pad;

  float acc[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) acc[j] = 0.f;

  const long long in_sp = (long long)Hi * Wi;
  for (int c = 0; c < Ci; ++c) {
    const float* xc = x + ((long long)n * Ci + c) * in_sp;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const int yi = y0 + ky;
      if (yi < 0 || yi >= Hi) continue;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const int xi = x0 + kx;
        if (xi < 0 || xi >= Wi) continue;
        const float v = __ldg(xc + (long long)yi * Wi + xi);
        const float* wk = s_w + (c * K * K + ky * K + kx) * CO_T;
#pragma unroll
        for (int j = 0; j < CO_T; ++j) acc[j] = fmaf(v, wk[j], acc[j]);
      }
    }
  }

  const int Hu = Ho / 2, Wu = Wo / 2;
#pragma unroll
  for (int j = 0; j < CO_T; ++j) {
    const int co = co0 + j;
    float res = acc[j];
    if (scale != nullptr) res *= scale[co];
    if (shift != nullptr) res += shift[co];
    if (relu) res = fmaxf(res, 0.f);
    if (up != nullptr)
      res += up[(((long long)n * Co + co) * Hu + oy / 2) * Wu + ox / 2];
    out[((long long)n * Co + co) * out_sp + r] = res;
  }
}

template <int K, int CO_T>
cudaError_t launch(const float* x, const float* w, const float* scale,
                   const float* shift, const float* up, float* out, int N,
                   int Ci, int Hi, int Wi, int Co, int Ho, int Wo, int stride,
                   int pad, int relu, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Ci * K * K * CO_T;
  cudaError_t e = cudaFuncSetAttribute(
      conv2d_kernel<K, CO_T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long n = (long long)N * Ho * Wo;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), Co / CO_T);
  conv2d_kernel<K, CO_T><<<grid, kThreads, smem, stream>>>(
      x, w, scale, shift, up, out, N, Ci, Hi, Wi, Co, Ho, Wo, stride, pad,
      relu);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch_co(const float* x, const float* w, const float* scale,
                        const float* shift, const float* up, float* out,
                        int N, int Ci, int Hi, int Wi, int Co, int Ho, int Wo,
                        int stride, int pad, int relu, cudaStream_t s) {
  if (Co % 16 == 0)
    return launch<K, 16>(x, w, scale, shift, up, out, N, Ci, Hi, Wi, Co, Ho,
                         Wo, stride, pad, relu, s);
  if (Co % 8 == 0)
    return launch<K, 8>(x, w, scale, shift, up, out, N, Ci, Hi, Wi, Co, Ho,
                        Wo, stride, pad, relu, s);
  return launch<K, 1>(x, w, scale, shift, up, out, N, Ci, Hi, Wi, Co, Ho, Wo,
                      stride, pad, relu, s);
}

}  // namespace

// scale, shift and up may be null (see the epilogue above).
extern "C" int conv2d_f32(const float* x, const float* w, const float* scale,
                          const float* shift, const float* up, float* out,
                          int N, int Ci, int Hi, int Wi, int Co, int Ho,
                          int Wo, int K, int stride, int pad, int relu,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return (int)dispatch_co<1>(x, w, scale, shift, up, out, N, Ci, Hi,
                                       Wi, Co, Ho, Wo, stride, pad, relu, s);
    case 3: return (int)dispatch_co<3>(x, w, scale, shift, up, out, N, Ci, Hi,
                                       Wi, Co, Ho, Wo, stride, pad, relu, s);
    case 5: return (int)dispatch_co<5>(x, w, scale, shift, up, out, N, Ci, Hi,
                                       Wi, Co, Ho, Wo, stride, pad, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
