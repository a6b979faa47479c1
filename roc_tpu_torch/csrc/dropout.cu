// Inverted dropout with the JAX package's masks, for Hopper (sm_90a).
//
// out[i] = keep(i) ? x[i] / (1 - rate) : 0, keep(i) = u(i) < 1 - rate, where u(i) is the
// uniform float jax.random.bernoulli draws for element i (row-major index) from the key
// (k0, k1): threefry-2x32, 20 rounds, over the counter (i >> 32, i & 0xffffffff), the two
// output words xor'ed, the top 23 bits as the mantissa of a float in [1, 2), minus 1
// (roc_tpu/ops/dropout.py:21, jax_threefry_partitionable).  So a run on the card draws
// roc_tpu's masks, and its curves are roc_tpu's (docs/GOLDEN.md) up to float reassociation.
// The plain twin is roc_tpu_torch/ops/prng.py + ops/kernels/dropout.py:dropout_plain.
//
// The backward is the same launch on the cotangent: d out / d x is keep(i) / (1 - rate), and
// keep is recomputed from the key, so nothing is saved between the passes.  The division is
// IEEE (__fdiv_rn), as XLA's and torch's; 0 / d = +0 where a cotangent is dropped, as
// torch.where(keep, g, 0) / d gives.
//
// Bound.  Reading x and writing out once, 8 bytes an element (0.33 ms for the 140 M elements
// of Reddit's 602 features at 3.35 TB/s); the threefry rounds are ~90 integer operations an
// element (20 rounds of add, funnel-shift and xor, 5 key injections), the operations that
// bind at that size.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// jax's threefry2x32 on one counter pair; returns the xor of its two output words (the 32 bits
// jax.random.bits gives an element).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define ROC_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;
#define ROC_ROUNDS_A ROC_ROUND(13) ROC_ROUND(15) ROC_ROUND(26) ROC_ROUND(6)
#define ROC_ROUNDS_B ROC_ROUND(17) ROC_ROUND(29) ROC_ROUND(16) ROC_ROUND(24)
  x0 += k0;
  x1 += k1;
  ROC_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  ROC_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  ROC_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  ROC_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  ROC_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
#undef ROC_ROUNDS_B
#undef ROC_ROUNDS_A
#undef ROC_ROUND
  return x0 ^ x1;
}

__global__ void __launch_bounds__(kThreads)
dropout_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n, uint32_t k0,
               uint32_t k1, float p, float d) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint32_t bits = threefry_bits(k0, k1, static_cast<uint32_t>(i >> 32),
                                        static_cast<uint32_t>(i));
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    out[i] = u < p ? __fdiv_rn(x[i], d) : 0.0f;
  }
}

}  // namespace

// out [n] = dropout of x [n] (both contiguous fp32) with key (k0, k1), keep probability p and
// divisor d (both float32(1 - rate)).
extern "C" int roc_dropout(const void* x, void* out, long long n, unsigned k0, unsigned k1,
                           float p, float d, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * 16;
  const dim3 grid(static_cast<unsigned>(blocks < cap ? blocks : cap));
  dropout_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, k0, k1, p, d);
  return static_cast<int>(cudaGetLastError());
}
