// The deterministic backward scatter of the plane-sweep warps, shared by
// K6 (warp_variance.cu, the backward of K1) and K7's backward
// (warp_volume.cu).
//
// A backward applies Warp_v^T: every (plane d, reference pixel) sample of
// source view v adds weight_k * cot into the four taps it read. Many
// samples reach one source texel, from threads that run in no fixed
// order, so a float sum there would round differently from run to run.
// Here the sum is exact instead:
//
//   * One group of C lanes owns one reference pixel (lane c = channel c)
//     and walks its planes d = 0..D-1 in order, the counterpart of the TPU
//     kernels' sequential plane grid. Per source view it keeps a run: the
//     top-left tap (x0, y0) of the current plane and four float sums. While
//     the next plane's top-left tap is the same, its weighted cotangent is
//     added into the run in registers; when the tap changes, and after the
//     last plane, the run is flushed.
//   * A flush turns each in-image tap's float sum into an integer number of
//     quanta, llrint(sum * 2^-e) (one rounding), and adds it with a 64-bit
//     integer atomicAdd into a scratch [V-1, H, W, NC]. The group's C lanes
//     add C consecutive 8-byte words: one coalesced 64-256 B request per
//     tap. Integer addition is associative and the flush boundaries depend
//     only on the data, so the total is the same in every run.
//   * from_quanta writes float(total) * 2^e.
//
// The quantum 2^e. One sample adds to a given texel at most once, with a
// weight <= 1, so |total| <= D*H*W*M, where M bounds one sample's
// cotangent: K6 (2/V) max|g| * 2 max|src| (a bilinear sample is a convex
// combination with zeros padding, so |x_v - mean| <= 2 max|src|); K7's
// features (2/V)(max|g_var| + max|g_nr|) * 2 max|feats|; K7's images
// max|g_img|. e is the least integer with D*H*W*M <= 2^62 * 2^e, so no sum
// can leave int64, and it is chosen on the device (absmax_kernel,
// choose_quantum), with no host sync. Error: at most half a quantum per
// flush that reaches a texel, and 2^e < 2 D*H*W*M 2^-62 -- with n flushes
// on a texel, n * D*H*W*M * 2^-62, ~1e-11 of M at the train shapes.
// M == 0 gives zeros; a non-finite maximum gives NaN outputs and no adds.
//
// bf16 (the bf16 train path: K6-bf16 and K7bwd-bf16, designs of their
// own on this scatter, warp_bf16.cuh, on bf16 features, images and
// cotangents). They follow the JAX kernels at compute dtype bf16
// (pallas_warp_train.py:180-182,202-206,251-253, 272-275;
// pallas_warp_volume.py:229-237): x_v is the bf16 forward's sample (bf16
// x weights), the cotangent of a sample e = (2/V) g (x_v - mean) stays
// float32, and tap k receives bf16(e * wy_k) * bf16(wx_k), a product
// exact in float32 (warpb::run_add), as the TPU kernel rounds each
// y-weighted cotangent row and its x hat weights to bf16 before the
// transposed matmul. The reference view's cotangent is summed in float32;
// every output is rounded to bf16 once (from_quanta, store_out). The
// maxima read bf16 inputs too (AbsMaxArgs half). The quantum's bound
// holds with 2x to spare: a rounded contribution exceeds its float32
// value by at most 2^-8 of it.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "warp_common.cuh"

namespace warp {

constexpr int kBwdThreads = 256;    // a block: 256 / C reference pixels

// Scale factors of one quantum 2^e: to_q = 2^-e, from_q = 2^e.
struct Quantum {
  double to_q, from_q;
};

// Device-side head of the scratch: the maxima (float bits; for
// non-negative floats the unsigned order is the float order, with NaN
// above inf) and the quanta [features, images].
struct Aux {
  unsigned maxbits[4];
  Quantum q[2];
};
constexpr long long kAuxBytes = 64;
static_assert(sizeof(Aux) <= kAuxBytes, "Aux outgrew its slot");

// Bytes of the scratch of a variance backward (K6 and K6-bf16): Aux, then
// the int64 fixed-point sums [V-1, H, W, C].
inline long long variance_bwd_scratch_bytes(int V, int H, int W, int C) {
  return kAuxBytes + 8LL * (V - 1) * H * W * C;
}

// Channel c of the bilinear sample of map base [H, W, C]: the taps and
// weights of sample_channels, fused multiply-adds in the same order, so
// the backward's x_v equals the forward's bit for bit.
template <int C>
__device__ __forceinline__ float sample_lane(const float* base,
                                             const Taps& t, int H, int W,
                                             int c) {
  float val = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long p = tap_pixel(t, k, H, W);
    if (p < 0) continue;
    val = __fmaf_rn(tap_weight(t, k), load1(base + p * C + c), val);
  }
  return val;
}

// One source view's run of consecutive planes that share a top-left tap.
struct TapRun {
  int x0, y0;
  float acc[4];
};

// A run that covers no tap: its first plane always starts a new one.
__device__ __forceinline__ void run_start(TapRun& r) {
  r.x0 = r.y0 = -(1 << 30);
#pragma unroll
  for (int k = 0; k < 4; ++k) r.acc[k] = 0.f;
}

// Add acc[k], in quanta, into lane c of dst [H, W, NC] at the run's taps
// inside the image.
template <int NC>
__device__ __forceinline__ void flush_taps(unsigned long long* dst,
                                           int x0, int y0, const float* acc,
                                           int H, int W, int c,
                                           double to_q) {
  if (!(to_q > 0.0)) return;          // all-zero or non-finite inputs
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    const long long q = llrint((double)acc[k] * to_q);
    atomicAdd(dst + ((long long)yi * W + xi) * NC + c,
              (unsigned long long)q);
  }
}

// Whether the plane with taps t continues run r (same top-left tap).
__device__ __forceinline__ bool same_run(const TapRun& r, const Taps& t) {
  return r.x0 == t.x0 && r.y0 == t.y0;
}

// Move run r to taps t after its flush: the sums restart at zero.
__device__ __forceinline__ void run_restart(TapRun& r, const Taps& t) {
  r.x0 = t.x0;
  r.y0 = t.y0;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.acc[k] = 0.f;
}

__device__ __forceinline__ void run_add(TapRun& r, const Taps& t,
                                        float cot) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r.acc[k] = __fmaf_rn(tap_weight(t, k), cot, r.acc[k]);
}

struct AbsMaxArgs {
  const void* p[4];     // nullptr: slot unused
  long long n[4];
  bool half[4];         // bf16 elements (else float)
};

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// maxbits[i] = bits of max |p[i]| (maxbits zeroed by the caller); integer
// atomicMax, one per warp and tensor.
__global__ void __launch_bounds__(256) absmax_kernel(AbsMaxArgs a,
                                                     unsigned* maxbits) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  for (int i = 0; i < 4; ++i) {
    if (a.p[i] == nullptr) continue;
    const long long n = a.n[i];
    unsigned m = 0;
    if (a.half[i]) {
      // |bf16| as float bits: the magnitude bits moved up 16
      const unsigned short* h = static_cast<const unsigned short*>(a.p[i]);
      for (long long j = tid; j < n; j += nth)
        m = max(m, (unsigned)(__ldg(h + j) & 0x7fffu) << 16);
    } else {
      const float* p = static_cast<const float*>(a.p[i]);
      const long long n4 =
          reinterpret_cast<uintptr_t>(p) % 16 == 0 ? n / 4 : 0;
      const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll 4
      for (long long j = tid; j < n4; j += nth) {
        const float4 q = __ldg(p4 + j);
        m = max(m, max(max(abs_bits(q.x), abs_bits(q.y)),
                       max(abs_bits(q.z), abs_bits(q.w))));
      }
      for (long long j = 4 * n4 + tid; j < n; j += nth)
        m = max(m, abs_bits(__ldg(p + j)));
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(maxbits + i, m);
  }
}

// The quantum for sums bounded by `bound`: 2^e with bound <= 2^62 * 2^e.
__device__ __forceinline__ Quantum quantum_for(double bound) {
  if (!(bound <= 1.7976931348623157e308))      // inf or NaN
    return Quantum{0.0, __longlong_as_double(0x7ff8000000000000LL)};
  if (bound == 0.0) return Quantum{0.0, 0.0};
  int k;
  frexp(bound, &k);                            // bound < 2^k
  return Quantum{ldexp(1.0, 62 - k), ldexp(1.0, k - 62)};
}

// aux->q[0] for the features: samples * (2/V) * (max[1] + max[2]) * 2 *
// max[0] (max[2] is 0 for K6); aux->q[1] for K7's images: samples * max[3].
__global__ void choose_quantum(Aux* aux, double samples, int V,
                               bool images) {
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = __uint_as_float(aux->maxbits[i]);
  aux->q[0] = quantum_for(samples * (2.0 / V) *
                          ((double)m[1] + (double)m[2]) * 2.0 * (double)m[0]);
  aux->q[1] = images ? quantum_for(samples * (double)m[3])
                     : Quantum{0.0, 0.0};
}

// out[i] = float(acc[.] * 2^e) over n outputs of nc_out channels from
// nc_in-channel quanta (nc_in >= nc_out: padded channels are skipped);
// a bf16 out rounds that float once more, as JAX casts its float32 sum.
template <class TO>
__global__ void __launch_bounds__(256)
from_quanta(const long long* __restrict__ acc, TO* __restrict__ out,
            long long n, int nc_in, int nc_out, const Quantum* q) {
  const double s = q->from_q;
  const long long nth = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += nth) {
    const long long a = nc_in == nc_out ? i
                                        : (i / nc_out) * nc_in + i % nc_out;
    store_out(out + i, (float)((double)acc[a] * s));
  }
}

inline unsigned grid_for(long long n, int threads, unsigned cap) {
  const long long b = (n + threads - 1) / threads;
  return (unsigned)(b < (long long)cap ? (b < 1 ? 1 : b) : cap);
}

// Zero the scratch, reduce the maxima and choose the quanta, on `stream`.
inline void prepare_scratch(void* scratch, long long bytes,
                            const AbsMaxArgs& a, long long samples, int V,
                            bool images, cudaStream_t stream) {
  Aux* aux = static_cast<Aux*>(scratch);
  cudaMemsetAsync(scratch, 0, bytes, stream);
  long long n = 0;
  for (int i = 0; i < 4; ++i) n = a.n[i] > n ? a.n[i] : n;
  absmax_kernel<<<grid_for(n / 4, 256, 132 * 8), 256, 0, stream>>>(
      a, aux->maxbits);
  choose_quantum<<<1, 1, 0, stream>>>(aux, (double)samples, V, images);
}

// Write float(total) * 2^e of n outputs (none when n == 0).
template <class TO>
inline void finish_quanta(const void* acc, TO* out, long long n,
                          int nc_in, int nc_out, const Quantum* q,
                          cudaStream_t stream) {
  if (n <= 0) return;
  from_quanta<TO><<<grid_for(n, 256, 132 * 16), 256, 0, stream>>>(
      static_cast<const long long*>(acc), out, n, nc_in, nc_out, q);
}

}  // namespace warp
