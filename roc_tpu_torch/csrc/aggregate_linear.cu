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
// Design: the row-tile gather and GEMM of row_tile.cuh (16 destination rows gathered into an
//   fp32 shared-memory tile, then an fp32 FMA GEMM of the tile with the weight), one tile per
//   block.  The backward also writes the gathered rows once to u.
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

#include "row_tile.cuh"

namespace {

using roc::kThreads;
using roc::SourceRows;

// Four resident blocks per SM (64 registers a thread, a few spilled): the gather is
// latency-bound and needs the warps; at the compiler's own choice (up to 152 registers)
// one block ran per SM and the GEMM phase did not overlap another block's gather.
constexpr int kMinBlocks = 4;

template <int VEC, bool ROUND>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mega_fwd(const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
         const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
         int64_t num_rows, int64_t h_in, int64_t h_out, int rb, int stride, bool relu) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rb;
  roc::gather_rows<VEC, ROUND>(row_ptr, col_idx, SourceRows<false>{x, nullptr}, row0, rb,
                               num_rows, h_in, tile, stride, nullptr);
  __syncthreads();
  roc::tile_gemm(tile, stride, rb, row0, num_rows, w, h_in, h_out, out, relu, nullptr);
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
  roc::gather_rows<VEC, ROUND>(t_row_ptr, t_col_idx, SourceRows<RELU>{g, y}, row0, rb, num_rows,
                               h_out, tile, stride, u);
  if (dx == nullptr) return;  // the caller needs only u (the layer input takes no gradient)
  __syncthreads();
  roc::tile_gemm(tile, stride, rb, row0, num_rows, wt, h_out, h_in, dx, false, nullptr);
}

template <int VEC, bool ROUND>
int launch_fwd(const int64_t* rp, const int32_t* ci, const float* x, const float* w, float* out,
               int64_t n, int64_t h_in, int64_t h_out, bool relu, cudaStream_t s) {
  int rb, stride;
  roc::tile_shape(h_in, &rb, &stride);
  const size_t smem = static_cast<size_t>(rb) * stride * sizeof(float);
  const int err = roc::prepare(mega_fwd<VEC, ROUND>, smem);
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
  roc::tile_shape(h_out, &rb, &stride);
  const size_t smem = static_cast<size_t>(rb) * stride * sizeof(float);
  const int err = roc::prepare(mega_bwd<VEC, ROUND, RELU>, smem);
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
