// Whole-layer megakernel for Hopper (sm_90a): aggregate -> linear (-> relu) and its backward.
//
// Forward, roc_aggregate_linear:   out = act((A x) W)
//   x [T, H_in] fp32, W [H_in, H_out] fp32, A the in-edge CSR over N destination rows
//   (col_idx[row_ptr[v] : row_ptr[v + 1]] are v's sources), act in {none, relu}.
//   Replaces the Pallas TPU kernel binned.py:2300 _mega_kernel (pallas_call at :2437,
//   reached by run_binned_linear at :2492).
// Backward, roc_stage_cotangent then roc_aggregate_linear_bwd:   u = A^T (g * [y > 0]),
//   dx = u W^T.  g, y [N, H_out] (the output cotangent and the saved forward output; the
//   mask is skipped without relu), W^T [H_out, H_in], walked over the TRANSPOSED CSR (T rows).
//   Writes u [T, H_out] (for dW = x^T u, a GEMM outside the kernel) and, when asked, dx
//   [T, H_in].  Replaces binned.py:2599 _mega_bwd_kernel (pallas_call at :2762, reached by
//   run_binned_linear_bwd at :2771).
//
// The function is copied, not the TPU schedule: bins, staging, one-hot MXU scatters,
// 128-lane padding and VMEM gates are not carried over.
//
// Forward design: the row-tile gather and GEMM of row_tile.cuh (16 destination rows gathered
//   into an fp32 shared-memory tile, then an fp32 FMA GEMM of the tile with the weight), one
//   tile per block.
//
// Backward design.  (a) The masked, rounded cotangent s = round(g * [y > 0]) is staged once
//   per source row by stage_cotangent into a plane [N, ld] (ld = H_out rounded up to 16
//   bytes): bf16 in "fast" (the rounding is the store), fp32 in exact with relu; exact
//   without relu gathers g itself.  Each edge then loads one 16-byte-packed row of s (512 B
//   at H_out = 256 in fast) instead of a row of g and a row of y (2 KB), and rounds nothing.
//   (b) u only: mega_bwd_u, lane groups of 8-32 lanes per row, no shared memory.  (c) With
//   dx: mega_bwd_dx gathers 16 rows into a shared tile (and u), then runs its own GEMM:
//   W^T in cp.async double-buffered k-slices through shared memory, a 4 x 4 register tile
//   per thread.  Every u element is the sum over its edges in CSR order in fp32 from 0 of
//   the staged values (bf16 -> fp32 is exact, so masking and rounding once per source row
//   equals doing it per edge), and every dx element one fmaf per k in ascending k from 0, as
//   row_tile.cuh's tile_gemm computes it in xlayer.cu's regions: a region and the chain of
//   per-layer kernels must give the same bits.
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
// dominates.  The backward's u at 602 <- 256 needs E * 256 adds (6 GFLOP, 0.09 ms) and
// moves g, y, u and the CSR once (0.8 GB, 0.24 ms): bytes bind, and the gather of one bf16
// row per edge (12 GB, mostly from L2) is what it really moves.  With dx the GEMM adds
// 72 GFLOP (1.07 ms at 67 TFLOP/s).  Splitting hub rows, prefetching the next edge's row and
// a tensor-core hand-off GEMM under a 3xTF32 split (with xlayer.cu's, so the region chain
// keeps its bits) are later work.

#include "cp_async.cuh"
#include "row_tile.cuh"

namespace {

using roc::kThreads;
using roc::kWarps;
using roc::SourceRows;
using roc::cp_async16;
using roc::cp_async_commit;
using roc::cp_async_wait;

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
  roc::gather_rows<VEC, ROUND>(row_ptr, col_idx, SourceRows{x}, row0, rb,
                               num_rows, h_in, tile, stride, nullptr);
  __syncthreads();
  roc::tile_gemm(tile, stride, rb, row0, num_rows, w, h_in, h_out, out, relu, nullptr);
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


// ---------------------------------------------------------------------------
// Backward.

constexpr int kKSlice = 8;     // W^T rows per cp.async stage of the dx GEMM
constexpr int kPassCols = 256; // dx columns per GEMM pass: 64 column groups of 4

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) PackT {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Staging: s[n, c] = g[n, c] * [y[n, c] > 0] (g itself without relu) for c < H, stored as T
// (bf16: round to nearest even, the "fast" rounding; fp32: as is), and 0 for H <= c < ld.
// One warp per row, VEC columns a lane (VEC divides H and keeps g's and y's rows aligned).
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
stage_cotangent(const float* __restrict__ g, const float* __restrict__ y, T* __restrict__ s,
                int64_t rows, int64_t H, int64_t ld) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  for (int64_t c = static_cast<int64_t>(lane) * VEC; c < ld; c += 32 * VEC) {
    PackT<T, VEC> o;
    if (c < H) {  // H % VEC == 0: a pack is wholly inside or outside
      const PackT<float, VEC> gv = *reinterpret_cast<const PackT<float, VEC>*>(g + row * H + c);
      PackT<float, VEC> yv;
      if (RELU) yv = *reinterpret_cast<const PackT<float, VEC>*>(y + row * H + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_f32<T>(RELU ? (yv.v[j] > 0.f ? gv.v[j] : 0.f) : gv.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(0.f);
    }
    *reinterpret_cast<PackT<T, VEC>*>(s + row * ld + c) = o;
  }
}

// u[row, :] = sum over the transposed CSR row's edges, in CSR order, of s[u, :] in fp32 from 0.
// A group of lpr lanes (8, 16 or 32) owns the row; lane sl of it loads the VEC-element pack
// at column c = c0 + sl * VEC of each edge's source row (16 bytes when VEC * sizeof(T) = 16),
// and a row wider than lpr * VEC columns is covered in passes, re-walking its edges.  The
// pack may run past H into the row's padding (ld >= the packs' end); columns >= H are not
// emitted.  emit(c, acc) gets each pass's sums.
template <typename T, int VEC, class Emit>
__device__ __forceinline__ void gather_row(const int64_t* __restrict__ rp,
                                           const int32_t* __restrict__ ci,
                                           const T* __restrict__ s, int64_t ld, int64_t row,
                                           int64_t H, int lpr, int sl, Emit emit) {
  const int64_t beg = rp[row], end = rp[row + 1];
  for (int64_t c0 = 0; c0 < H; c0 += static_cast<int64_t>(lpr) * VEC) {
    const int64_t c = c0 + static_cast<int64_t>(sl) * VEC;
    if (c >= H) continue;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    const T* base = s + c;
#pragma unroll 4
    for (int64_t e = beg; e < end; ++e) {
      const int64_t src = ci[e];
      const PackT<T, VEC> p = *reinterpret_cast<const PackT<T, VEC>*>(base + src * ld);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += to_f32(p.v[j]);
    }
    emit(c, acc);
  }
}

// out[c .. c + VEC) of one fp32 row of width H, the columns below H only.
template <int VEC>
__device__ __forceinline__ void store_row(float* __restrict__ out, int64_t c, int64_t H,
                                          const float (&acc)[VEC]) {
  if (c + VEC <= H && H % VEC == 0) {  // the pack is aligned in the row and the row start too
    PackT<float, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = acc[j];
    *reinterpret_cast<PackT<float, VEC>*>(out + c) = o;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (c + j < H) out[c + j] = acc[j];
  }
}

// u only (the layer's input takes no gradient): a latency-bound gather, so no shared memory,
// no register cap beyond the block's, and 32 / lpr rows per warp.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
mega_bwd_u(const int64_t* __restrict__ rp, const int32_t* __restrict__ ci,
           const T* __restrict__ s, int64_t ld, float* __restrict__ u, int64_t rows, int64_t H,
           int lpr) {
  const int lane = threadIdx.x & 31;
  const int rpw = 32 / lpr;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * rpw +
                      lane / lpr;
  if (row >= rows) return;
  float* out = u + row * H;
  gather_row<T, VEC>(rp, ci, s, ld, row, H, lpr, lane % lpr,
                     [&](int64_t c, const float (&acc)[VEC]) { store_row<VEC>(out, c, H, acc); });
}

// With dx: the block's rb <= 16 rows are gathered as above into an fp32 shared tile [rb, ts]
// (and written to u), then dx[rows, :] = tile W^T with W^T [K, ldw] row-major (ldw % 4 == 0,
// 16-byte aligned rows; columns N .. ldw are padding).  The GEMM walks the output in passes of
// 256 columns.  Thread (warp w, lane l) owns the 4 columns j0 + (8 w + l % 8) * 4 and the rows
// l / 8 + 4 i, i < 4: a 4 x 4 register tile.  W^T comes through shared memory in slices of 8
// rows of the pass's columns, cp.async double-buffered; the tile is read as float4 along k
// (ts / 4 odd, so the four rows a warp reads at once sit in distinct banks) and each W^T row as
// one float4 per thread (a warp reads 128 contiguous bytes, broadcast to its 4 row groups).
// Each output element is one fmaf per k in ascending k from 0: the bits of tile_gemm's dx.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
mega_bwd_dx(const int64_t* __restrict__ rp, const int32_t* __restrict__ ci,
            const T* __restrict__ s, int64_t ld, const float* __restrict__ wt, int64_t ldw,
            float* __restrict__ u, float* __restrict__ dx, int64_t rows, int64_t K, int64_t N,
            int lpr, int rb, int ts) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  float* wbuf = tile + static_cast<int64_t>(rb) * ts;  // [2][kKSlice][kPassCols]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rb;
  const int rpw = 32 / lpr;
  for (int r = warp * rpw + lane / lpr; r < rb; r += kWarps * rpw) {
    const int64_t row = row0 + r;
    if (row >= rows) break;
    float* trow = tile + static_cast<int64_t>(r) * ts;
    float* urow = u + row * K;
    gather_row<T, VEC>(rp, ci, s, ld, row, K, lpr, lane % lpr,
                       [&](int64_t c, const float (&acc)[VEC]) {
                         store_row<VEC>(urow, c, K, acc);
#pragma unroll
                         for (int j = 0; j < VEC; ++j)
                           if (c + j < K) trow[c + j] = acc[j];
                       });
  }

  const int cg = warp * 8 + (lane & 7);  // column group: 4 columns
  const int rg = lane >> 3;              // rows rg + 4 i
  const int nsl = static_cast<int>((K + kKSlice - 1) / kKSlice);
  const float* arow[4];  // a row past rb reads row rb - 1: its sums are never stored
#pragma unroll
  for (int i = 0; i < 4; ++i) arow[i] = tile + (rg + 4 * i < rb ? rg + 4 * i : rb - 1) * ts;
  for (int64_t j0 = 0; j0 < N; j0 += kPassCols) {
    const int64_t chunks = (ldw - j0) / 4 < kPassCols / 4 ? (ldw - j0) / 4 : kPassCols / 4;
    auto load_slice = [&](int sl, int buf) {
      float* dst = wbuf + buf * (kKSlice * kPassCols);
      for (int q = tid; q < kKSlice * kPassCols / 4; q += kThreads) {
        const int kk = q / (kPassCols / 4), c4 = q % (kPassCols / 4);
        const int64_t k = static_cast<int64_t>(sl) * kKSlice + kk;
        if (k < K && c4 < chunks)
          cp_async16(dst + kk * kPassCols + c4 * 4, wt + k * ldw + j0 + c4 * 4);
      }
      cp_async_commit();
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    load_slice(0, 0);
    for (int sl = 0; sl < nsl; ++sl) {
      if (sl + 1 < nsl) {
        load_slice(sl + 1, (sl + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // the slice (and, at sl = 0, the gathered tile) is visible to all
      const float* b = wbuf + (sl & 1) * (kKSlice * kPassCols) + cg * 4;
      const int64_t k0 = static_cast<int64_t>(sl) * kKSlice;
      const int kn = K - k0 < kKSlice ? static_cast<int>(K - k0) : kKSlice;
      int kk = 0;
      for (; kk + 4 <= kn; kk += 4) {
        float4 a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(arow[i] + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bv[q] = *reinterpret_cast<const float4*>(b + (kk + q) * kPassCols);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[i][0] = fmaf(av[q], bv[q].x, acc[i][0]);
            acc[i][1] = fmaf(av[q], bv[q].y, acc[i][1]);
            acc[i][2] = fmaf(av[q], bv[q].z, acc[i][2]);
            acc[i][3] = fmaf(av[q], bv[q].w, acc[i][3]);
          }
        }
      }
      for (; kk < kn; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(b + kk * kPassCols);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = arow[i][k0 + kk];
          acc[i][0] = fmaf(av, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av, bv.w, acc[i][3]);
        }
      }
      __syncthreads();  // the buffer is free for the slice after next
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 4 * i;
      const int64_t row = row0 + r;
      if (r >= rb || row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = j0 + cg * 4 + j;
        if (col < N) dx[row * N + col] = acc[i][j];
      }
    }
  }
}

// Lanes per row: the fewest of 8, 16, 32 that cover a row's packs in one pass.
int lanes_per_row(int64_t H, int vec) {
  const int64_t packs = (H + vec - 1) / vec;
  return packs <= 8 ? 8 : packs <= 16 ? 16 : 32;
}

// The dx tile's row stride: K rounded up to 4 floats with an odd count of 16-byte chunks.
int tile_stride(int64_t K) { return static_cast<int>(((K + 3) / 4 | 1) * 4); }

template <typename T, int VEC>
int launch_bwd(const int64_t* rp, const int32_t* ci, const T* s, int64_t ld, const float* wt,
               int64_t ldw, float* u, float* dx, int64_t t, int64_t K, int64_t N,
               cudaStream_t stream) {
  const int lpr = lanes_per_row(K, VEC);
  if (dx == nullptr) {
    const int64_t rows_per_block = static_cast<int64_t>(kWarps) * (32 / lpr);
    const dim3 grid(static_cast<unsigned>((t + rows_per_block - 1) / rows_per_block));
    mega_bwd_u<T, VEC><<<grid, kThreads, 0, stream>>>(rp, ci, s, ld, u, t, K, lpr);
    return static_cast<int>(cudaGetLastError());
  }
  const int ts = tile_stride(K);
  const size_t wbytes = static_cast<size_t>(2) * kKSlice * kPassCols * sizeof(float);
  constexpr size_t kMaxSmem = 227 * 1024;
  int rb = roc::kMaxRows;
  while (rb > 1 && wbytes + static_cast<size_t>(rb) * ts * sizeof(float) > kMaxSmem) --rb;
  const size_t smem = wbytes + static_cast<size_t>(rb) * ts * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int err = roc::prepare(mega_bwd_dx<T, VEC>, smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((t + rb - 1) / rb));
  mega_bwd_dx<T, VEC><<<grid, kThreads, smem, stream>>>(rp, ci, s, ld, wt, ldw, u, dx, t, K, N, lpr,
                                                         rb, ts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RELU>
int launch_stage(const float* g, const float* y, T* s, int64_t rows, int64_t H, int64_t ld,
                 int vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  switch (vec) {
    case 4: stage_cotangent<T, 4, RELU><<<grid, kThreads, 0, stream>>>(g, y, s, rows, H, ld); break;
    case 1: stage_cotangent<T, 1, RELU><<<grid, kThreads, 0, stream>>>(g, y, s, rows, H, ld); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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


// s (the staged cotangent plane [rows, ld]) from g and, with relu, y (both [rows, H] fp32):
// dtype 1 = bf16 ("fast"), 0 = fp32 (exact, relu only).  vec is 4 or 1 (4 divides H and g's
// and y's rows are 16-byte aligned); ld >= H is a multiple of 8 (bf16) or 4 (fp32).
extern "C" int roc_stage_cotangent(const void* g, const void* y, void* s, long long rows,
                                   long long H, long long ld, int dtype, int relu, int vec,
                                   void* stream) {
  if (rows <= 0 || H <= 0 || ld < H || (relu && y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* gp = static_cast<const float*>(g);
  const float* yp = static_cast<const float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    __nv_bfloat16* sp = static_cast<__nv_bfloat16*>(s);
    return relu ? launch_stage<__nv_bfloat16, true>(gp, yp, sp, rows, H, ld, vec, st)
                : launch_stage<__nv_bfloat16, false>(gp, yp, sp, rows, H, ld, vec, st);
  }
  if (dtype == 0 && relu)
    return launch_stage<float, true>(gp, yp, static_cast<float*>(s), rows, H, ld, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// u = A^T s over the transposed CSR (t rows) from the gathered plane s [*, ld] (dtype 1 =
// bf16, the staged plane of "fast"; 0 = fp32, the staged plane of exact relu or g itself),
// and, unless dx is null, dx = u W^T with wt = W^T [h_out, ldw] (ldw % 4 == 0, columns from
// h_in on are padding).  vec: 8 for bf16; 4, 2 or 1 for fp32 (it divides ld and keeps the
// rows aligned).  u is [t, h_out], dx [t, h_in], both fp32.
extern "C" int roc_aggregate_linear_bwd(const void* t_row_ptr, const void* t_col_idx,
                                        const void* s, long long ld, int dtype, int vec,
                                        const void* wt, long long ldw, void* u, void* dx,
                                        long long num_rows, long long h_out, long long h_in,
                                        void* stream) {
  if (num_rows <= 0 || h_out <= 0 || h_in <= 0 || ld < h_out || ld % vec != 0 ||
      (dx != nullptr && (ldw < h_in || ldw % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* rp = static_cast<const int64_t*>(t_row_ptr);
  const int32_t* ci = static_cast<const int32_t*>(t_col_idx);
  const float* wp = static_cast<const float*>(wt);
  float* up = static_cast<float*>(u);
  float* dp = static_cast<float*>(dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (vec != 8) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bwd<__nv_bfloat16, 8>(rp, ci, static_cast<const __nv_bfloat16*>(s), ld, wp, ldw,
                                        up, dp, num_rows, h_out, h_in, st);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* sp = static_cast<const float*>(s);
  switch (vec) {
    case 4: return launch_bwd<float, 4>(rp, ci, sp, ld, wp, ldw, up, dp, num_rows, h_out, h_in, st);
    case 2: return launch_bwd<float, 2>(rp, ci, sp, ld, wp, ldw, up, dp, num_rows, h_out, h_in, st);
    case 1: return launch_bwd<float, 1>(rp, ci, sp, ld, wp, ldw, up, dp, num_rows, h_out, h_in, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
