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
// bf16 (roc_dropout_bf16).  roc_tpu's x / (1.0 - rate) on a bf16 x takes the Python float as
// a weak type, so the divisor is bf16(1 - rate); the quotient is formed in fp32 and rounded
// once to bf16: out = bf16_rn(f32(x) / f32(bf16(1 - rate))), +0 where dropped.  The keep test
// stays u < float32(1 - rate), so the masks are the fp32 kernel's bit for bit.  The caller
// passes the two constants: p = float32(1 - rate) and d = float32(bf16(1 - rate)).
//
// Bound.  Reading x and writing out once, 8 bytes an element in fp32 and 4 in bf16 (0.33 and
// 0.17 ms for the 140 M elements of Reddit's 602 features at 3.35 TB/s).  The threefry's 20
// funnel-shift rotates and 21 xors an element have no pipe but the INT32 one, 64 lanes an SM
// (0.34 ms at that size); its adds can go to the FMA pipe.  That binds in both dtypes.

#include <cuda_bf16.h>
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

// The bytes a thread loads and stores an iteration: one 16-byte pack, 4 fp32 or 8 bf16 elements.
// Its elements' counters (i >> 32, i & 0xffffffff) share the high word, since a pack starts at a
// multiple of its width and so never crosses 2^32: the threefry's first key injection into it is
// made once a pack, and the address arithmetic and loop control once for 4 or 8 elements.
constexpr int kPackBytes = 16;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float& o, float v) { o = v; }
__device__ __forceinline__ void put(__nv_bfloat16& o, float v) { o = __float2bfloat16_rn(v); }

// Element (hi, lo) of the row-major order: v / d where kept, else +0.
__device__ __forceinline__ float drop(float v, uint32_t k0, uint32_t k1, uint32_t hi, uint32_t lo,
                                      float p, float d) {
  const uint32_t bits = threefry_bits(k0, k1, hi, lo);
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return u < p ? __fdiv_rn(v, d) : 0.0f;
}

// T = float or __nv_bfloat16: the element is read as fp32, divided in fp32 and rounded once to
// T on the store (exact for float).  x and out are 16-byte aligned (the launcher checks); the
// n % N elements past the last pack are taken one a thread by the grid's first threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, uint32_t k0,
               uint32_t k1, float p, float d) {
  constexpr int N = kPackBytes / static_cast<int>(sizeof(T));
  using P = Pack<T, N>;
  const int64_t packs = n / N;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t q = t; q < packs; q += stride) {
    const int64_t i0 = q * N;
    const uint32_t hi = static_cast<uint32_t>(i0 >> 32), lo = static_cast<uint32_t>(i0);
    const P in = reinterpret_cast<const P*>(x)[q];
    P o;
#pragma unroll
    for (int j = 0; j < N; ++j) put(o.v[j], drop(to_f32(in.v[j]), k0, k1, hi, lo + j, p, d));
    reinterpret_cast<P*>(out)[q] = o;
  }
  const int64_t i = packs * N + t;
  if (i < n)
    put(out[i], drop(to_f32(x[i]), k0, k1, static_cast<uint32_t>(i >> 32),
                     static_cast<uint32_t>(i), p, d));
}

template <typename T>
int launch(const void* x, void* out, long long n, unsigned k0, unsigned k1, float p, float d,
           void* stream) {
  if (n < 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % kPackBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long packs = n / (kPackBytes / static_cast<long long>(sizeof(T)));
  const long long blocks = packs > 0 ? (packs + kThreads - 1) / kThreads : 1;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * 16;
  const dim3 grid(static_cast<unsigned>(blocks < cap ? blocks : cap));
  dropout_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, k0, k1, p, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [n] = dropout of x [n] (both contiguous fp32, 16-byte aligned) with key (k0, k1), keep probability p and
// divisor d (both float32(1 - rate)).
extern "C" int roc_dropout(const void* x, void* out, long long n, unsigned k0, unsigned k1,
                           float p, float d, void* stream) {
  return launch<float>(x, out, n, k0, k1, p, d, stream);
}

// The same on contiguous, 16-byte aligned bf16 x and out: p = float32(1 - rate), d = float32(bf16(1 - rate)).
extern "C" int roc_dropout_bf16(const void* x, void* out, long long n, unsigned k0,
                                unsigned k1, float p, float d, void* stream) {
  return launch<__nv_bfloat16>(x, out, n, k0, k1, p, d, stream);
}
