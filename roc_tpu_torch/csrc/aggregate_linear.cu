// Whole-layer megakernel for Hopper (sm_90a): aggregate -> linear (-> relu) and its backward.
//
// Forward, roc_aggregate_linear:   out = act((A x) W)
//   x [T, H_in] fp32, W [H_in, H_out] fp32, A the in-edge CSR over N destination rows
//   (col_idx[row_ptr[v] : row_ptr[v + 1]] are v's sources), act in {none, relu}.
//   Replaces the Pallas TPU kernel binned.py:2300 _mega_kernel (pallas_call at :2437,
//   reached by run_binned_linear at :2492).
// Backward, roc_aggregate_linear_bwd:   u = A^T (g * [y > 0]),  dx = u W^T
//   g, y [N, H_out] (the output cotangent and the saved forward output; the mask is
//   skipped without relu), W^T [H_out, H_in], walked over the TRANSPOSED CSR (T rows).
//   Writes u [T, H_out] (for dW = x^T u, a GEMM outside the kernel) and dx [T, H_in].
//   Replaces binned.py:2599 _mega_bwd_kernel (pallas_call at :2762, reached by
//   run_binned_linear_bwd at :2771).
//
// The function is copied, not the TPU schedule: bins, staging, one-hot MXU scatters,
// 128-lane padding and VMEM gates are not carried over.
//
// Design.  A block of 256 threads owns RB <= 16 consecutive rows of the CSR it walks.
//   1. Gather.  Each warp takes rows r = warp, warp + 8, ...; it walks the row's edges in
//      CSR order and loads the source row with VEC-element vector loads (VEC in {4, 2, 1},
//      the widest that divides the width), kPacks packs per lane per pass over the edges,
//      accumulating in fp32 registers.  The row's sum goes to a shared-memory tile
//      [RB, H] (row stride rounded up to 4 floats) and never to global memory in the
//      forward.  The backward also writes it once to u.
//   2. GEMM.  After __syncthreads, thread t owns output column j = t mod CT of a pass over
//      the output columns (CT = the power of two >= the output width, 32..256) and rows
//      t / CT + i * (256 / CT); it reads the tile through shared-memory broadcasts (float4
//      along k) and the weight [K, N] row-major through L2 (coalesced along j), and sums
//      k in order in fp32 FMA registers.  No tensor cores: the contract is fp32 at
//      Precision.HIGHEST (binned.py:2391-2394), which TF32 and bf16 would break.
//   Each output row is written exactly once: no atomics, and the result is the same bits
//   on every run.
//
// Precision (binned.py:2304-2317, :2599-2615): ROUND = true is "fast", one bf16 rounding
// (round to nearest even) of each gathered element (x forward; the masked g backward)
// before its fp32 add; ROUND = false is "exact", fp32 throughout.  The relu mask is
// y > 0 (the TPU kernel's tie rule), not the 0.5 g of maximum's VJP at a tie.
//
// Bound.  Forward at Reddit shape (N = T = 232,965, E = 23.5 M, 602 -> 256): the
// compulsory bytes are x, out, W and the CSR once, about 0.9 GB (0.27 ms at 3.35 TB/s);
// the operations are E * H_in adds and 2 N H_in H_out FMA operations, 86 GFLOP (1.28 ms at
// 67 TFLOP/s fp32): operations bind.  What the kernel really moves is one source row per
// edge (E * H_in * 4 B = 57 GB, much of it from L2), as the standalone aggregation does,
// plus the weight once per block through L2 (616 KB x 14,561 blocks = 9 GB); the gather
// dominates.  Splitting hub rows, prefetching the next edge's row and a tensor-core
// GEMM under a 3xTF32 split are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;              // RB: destination rows per block, at most
constexpr int kPacks = 2;                 // column packs per lane per pass over the edges
// Four resident blocks per SM (64 registers a thread, a few spilled): the gather is
// latency-bound and needs the warps; at the compiler's own choice (up to 152 registers)
// one block ran per SM and the GEMM phase did not overlap another block's gather.
constexpr int kMinBlocks = 4;
constexpr int kStaticSmem = 48 * 1024;    // above this a launch must opt in

template <int VEC>
struct alignas(4 * VEC) Pack {
  float v[VEC];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// tile[r, :] = sum over the edges of CSR row row0 + r of src[u, :] (each element zeroed
// where mask[u, :] <= 0 when MASKED, then rounded once to bf16 when ROUND), for r < rb and
// rows below num_rows.  When gout is given the row also goes to gout[row0 + r, :].
template <int VEC, bool ROUND, bool MASKED>
__device__ __forceinline__ void gather_rows(const int64_t* __restrict__ row_ptr,
                                            const int32_t* __restrict__ col_idx,
                                            const float* __restrict__ src,
                                            const float* __restrict__ mask, int64_t row0, int rb,
                                            int64_t num_rows, int64_t H, float* tile, int stride,
                                            float* __restrict__ gout) {
  const int lane = threadIdx.x & 31;
  constexpr int kSpan = 32 * VEC * kPacks;
  for (int r = threadIdx.x >> 5; r < rb; r += kWarps) {
    const int64_t row = row0 + r;
    if (row >= num_rows) break;
    const int64_t beg = row_ptr[row];
    const int64_t end = row_ptr[row + 1];
    for (int64_t c0 = 0; c0 < H; c0 += kSpan) {
      float acc[kPacks][VEC];
#pragma unroll
      for (int p = 0; p < kPacks; ++p)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[p][j] = 0.f;
#pragma unroll 2
      for (int64_t e = beg; e < end; ++e) {
        const int64_t u = col_idx[e];
        const float* srow = src + u * H;
#pragma unroll
        for (int p = 0; p < kPacks; ++p) {
          const int64_t c = c0 + static_cast<int64_t>(p * 32 + lane) * VEC;
          if (c < H) {  // H % VEC == 0: a pack is wholly inside or outside
            const Pack<VEC> s = *reinterpret_cast<const Pack<VEC>*>(srow + c);
            Pack<VEC> m;
            if (MASKED) m = *reinterpret_cast<const Pack<VEC>*>(mask + u * H + c);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              float v = s.v[j];
              if (MASKED) v = m.v[j] > 0.f ? v : 0.f;
              if (ROUND) v = round_bf16(v);
              acc[p][j] += v;
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kPacks; ++p) {
        const int64_t c = c0 + static_cast<int64_t>(p * 32 + lane) * VEC;
        if (c < H) {
          Pack<VEC> o;
#pragma unroll
          for (int j = 0; j < VEC; ++j) o.v[j] = acc[p][j];
          // stride % 4 == 0 and c % VEC == 0: the pack is aligned in the tile too
          *reinterpret_cast<Pack<VEC>*>(tile + r * stride + c) = o;
          if (gout != nullptr) *reinterpret_cast<Pack<VEC>*>(gout + row * H + c) = o;
        }
      }
    }
  }
}

// out[row0 + r, j] = act(sum_k tile[r, k] * B[k, j]) for r < rb, rows below num_rows and
// j < N; B is [K, N] row-major.  RPT = 16 / (256 / CT) rows per thread.
template <int RPT>
__device__ __forceinline__ void tile_gemm_rows(const float* tile, int stride, int rb, int64_t row0,
                                               int64_t num_rows, const float* __restrict__ B,
                                               int64_t K, int64_t N, float* __restrict__ out,
                                               bool relu, int ct) {
  const int rg = kThreads / ct;
  const int tc = threadIdx.x % ct;
  const int tr = threadIdx.x / ct;
  for (int64_t j0 = 0; j0 < N; j0 += ct) {
    const int64_t j = j0 + tc;
    if (j >= N) continue;
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    int64_t k = 0;
    for (; k + 4 <= K; k += 4) {
      const float b0 = __ldg(B + (k + 0) * N + j);
      const float b1 = __ldg(B + (k + 1) * N + j);
      const float b2 = __ldg(B + (k + 2) * N + j);
      const float b3 = __ldg(B + (k + 3) * N + j);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tr + i * rg;
        if (r < rb) {
          const float4 a = *reinterpret_cast<const float4*>(tile + r * stride + k);
          acc[i] = fmaf(a.x, b0, acc[i]);
          acc[i] = fmaf(a.y, b1, acc[i]);
          acc[i] = fmaf(a.z, b2, acc[i]);
          acc[i] = fmaf(a.w, b3, acc[i]);
        }
      }
    }
    for (; k < K; ++k) {
      const float b = __ldg(B + k * N + j);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tr + i * rg;
        if (r < rb) acc[i] = fmaf(tile[r * stride + k], b, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tr + i * rg;
      if (r < rb && row0 + r < num_rows) {
        float v = acc[i];
        if (relu && v < 0.f) v = 0.f;  // NaN passes, as maximum(v, 0) lets it
        out[(row0 + r) * N + j] = v;
      }
    }
  }
}

__device__ __forceinline__ int column_threads(int64_t N) {
  int ct = 32;
  while (ct < kThreads && ct < N) ct *= 2;
  return ct;
}

__device__ __forceinline__ void tile_gemm(const float* tile, int stride, int rb, int64_t row0,
                                          int64_t num_rows, const float* B, int64_t K, int64_t N,
                                          float* out, bool relu) {
  const int ct = column_threads(N);
  switch (kThreads / ct) {
    case 1:
      tile_gemm_rows<kMaxRows>(tile, stride, rb, row0, num_rows, B, K, N, out, relu, ct);
      break;
    case 2:
      tile_gemm_rows<kMaxRows / 2>(tile, stride, rb, row0, num_rows, B, K, N, out, relu, ct);
      break;
    case 4:
      tile_gemm_rows<kMaxRows / 4>(tile, stride, rb, row0, num_rows, B, K, N, out, relu, ct);
      break;
    default:
      tile_gemm_rows<kMaxRows / 8>(tile, stride, rb, row0, num_rows, B, K, N, out, relu, ct);
      break;
  }
}

template <int VEC, bool ROUND>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mega_fwd(const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
         const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
         int64_t num_rows, int64_t h_in, int64_t h_out, int rb, int stride, bool relu) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rb;
  gather_rows<VEC, ROUND, false>(row_ptr, col_idx, x, nullptr, row0, rb, num_rows, h_in, tile,
                                 stride, nullptr);
  __syncthreads();
  tile_gemm(tile, stride, rb, row0, num_rows, w, h_in, h_out, out, relu);
}

template <int VEC, bool ROUND, bool RELU>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mega_bwd(const int64_t* __restrict__ t_row_ptr, const int32_t* __restrict__ t_col_idx,
         const float* __restrict__ g, const float* __restrict__ y, const float* __restrict__ wt,
         float* __restrict__ u, float* __restrict__ dx, int64_t num_rows, int64_t h_out,
         int64_t h_in, int rb, int stride) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rb;
  gather_rows<VEC, ROUND, RELU>(t_row_ptr, t_col_idx, g, y, row0, rb, num_rows, h_out, tile,
                                stride, u);
  if (dx == nullptr) return;  // the caller needs only u (the layer input takes no gradient)
  __syncthreads();
  tile_gemm(tile, stride, rb, row0, num_rows, wt, h_out, h_in, dx, false);
}

// Rows per block and the tile's row stride for a gather width H: 16 rows while the tile
// fits the 48 KB a launch gets without opting in, fewer (down to 1) for wide rows.
void tile_shape(int64_t H, int* rb, int* stride) {
  const int64_t s = (H + 3) / 4 * 4;
  int64_t r = kStaticSmem / (s * 4);
  if (r > kMaxRows) r = kMaxRows;
  if (r < 1) r = 1;
  *rb = static_cast<int>(r);
  *stride = static_cast<int>(s);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem <= kStaticSmem) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)));
}

template <int VEC, bool ROUND>
int launch_fwd(const int64_t* rp, const int32_t* ci, const float* x, const float* w, float* out,
               int64_t n, int64_t h_in, int64_t h_out, bool relu, cudaStream_t s) {
  int rb, stride;
  tile_shape(h_in, &rb, &stride);
  const size_t smem = static_cast<size_t>(rb) * stride * sizeof(float);
  const int err = prepare(mega_fwd<VEC, ROUND>, smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((n + rb - 1) / rb));
  mega_fwd<VEC, ROUND><<<grid, kThreads, smem, s>>>(rp, ci, x, w, out, n, h_in, h_out, rb, stride,
                                                     relu);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, bool ROUND, bool RELU>
int launch_bwd(const int64_t* rp, const int32_t* ci, const float* g, const float* y,
               const float* wt, float* u, float* dx, int64_t t, int64_t h_out, int64_t h_in,
               cudaStream_t s) {
  int rb, stride;
  tile_shape(h_out, &rb, &stride);
  const size_t smem = static_cast<size_t>(rb) * stride * sizeof(float);
  const int err = prepare(mega_bwd<VEC, ROUND, RELU>, smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((t + rb - 1) / rb));
  mega_bwd<VEC, ROUND, RELU><<<grid, kThreads, smem, s>>>(rp, ci, g, y, wt, u, dx, t, h_out, h_in,
                                                           rb, stride);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROUND>
int fwd_vec(int vec, const int64_t* rp, const int32_t* ci, const float* x, const float* w,
            float* out, int64_t n, int64_t h_in, int64_t h_out, bool relu, cudaStream_t s) {
  switch (vec) {
    case 4: return launch_fwd<4, ROUND>(rp, ci, x, w, out, n, h_in, h_out, relu, s);
    case 2: return launch_fwd<2, ROUND>(rp, ci, x, w, out, n, h_in, h_out, relu, s);
    case 1: return launch_fwd<1, ROUND>(rp, ci, x, w, out, n, h_in, h_out, relu, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool ROUND, bool RELU>
int bwd_vec(int vec, const int64_t* rp, const int32_t* ci, const float* g, const float* y,
            const float* wt, float* u, float* dx, int64_t t, int64_t h_out, int64_t h_in,
            cudaStream_t s) {
  switch (vec) {
    case 4: return launch_bwd<4, ROUND, RELU>(rp, ci, g, y, wt, u, dx, t, h_out, h_in, s);
    case 2: return launch_bwd<2, ROUND, RELU>(rp, ci, g, y, wt, u, dx, t, h_out, h_in, s);
    case 1: return launch_bwd<1, ROUND, RELU>(rp, ci, g, y, wt, u, dx, t, h_out, h_in, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, bound with ctypes by roc_tpu_torch/ops/kernels/aggregate_linear.py.  All
// tensors are contiguous fp32 on the device; row_ptr is int64, col_idx int32; vec is the
// gathered width's vector load (it divides that width and the row starts stay aligned).
// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int roc_aggregate_linear(const void* row_ptr, const void* col_idx, const void* x,
                                    const void* w, void* out, long long num_rows, long long h_in,
                                    long long h_out, int round_bf16, int relu, int vec,
                                    void* stream) {
  if (num_rows <= 0 || h_in <= 0 || h_out <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* rp = static_cast<const int64_t*>(row_ptr);
  const int32_t* ci = static_cast<const int32_t*>(col_idx);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_bf16 ? fwd_vec<true>(vec, rp, ci, xp, wp, op, num_rows, h_in, h_out, relu != 0, s)
                    : fwd_vec<false>(vec, rp, ci, xp, wp, op, num_rows, h_in, h_out, relu != 0, s);
}

// dx may be null: then only u is computed and written.
extern "C" int roc_aggregate_linear_bwd(const void* t_row_ptr, const void* t_col_idx,
                                        const void* g, const void* y, const void* wt, void* u,
                                        void* dx, long long num_rows, long long h_out,
                                        long long h_in, int round_bf16, int relu, int vec,
                                        void* stream) {
  if (num_rows <= 0 || h_out <= 0 || h_in <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* rp = static_cast<const int64_t*>(t_row_ptr);
  const int32_t* ci = static_cast<const int32_t*>(t_col_idx);
  const float* gp = static_cast<const float*>(g);
  const float* yp = static_cast<const float*>(y);
  const float* wp = static_cast<const float*>(wt);
  float* up = static_cast<float*>(u);
  float* dp = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (round_bf16) {
    return relu ? bwd_vec<true, true>(vec, rp, ci, gp, yp, wp, up, dp, num_rows, h_out, h_in, s)
                : bwd_vec<true, false>(vec, rp, ci, gp, yp, wp, up, dp, num_rows, h_out, h_in, s);
  }
  return relu ? bwd_vec<false, true>(vec, rp, ci, gp, yp, wp, up, dp, num_rows, h_out, h_in, s)
              : bwd_vec<false, false>(vec, rp, ci, gp, yp, wp, up, dp, num_rows, h_out, h_in, s);
}
