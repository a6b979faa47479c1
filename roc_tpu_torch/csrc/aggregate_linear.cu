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
// The function is copied, not the TPU schedule: bins, one-hot MXU scatters, 128-lane padding
// and VMEM gates are not carried over.  The bf16 staging of "fast" is kept: it is the TPU
// kernels' own (binned.py:37-39), one rounding per gathered element.
//
// Forward design (the region kernel's layer, xlayer.cu, as an ordinary launch).  In
//   "fast" x is first staged once (aggregate_sum.cu's roc_stage_plane, its own launch) into a
//   padded bf16 plane [T, ld8(H_in)]: 1,216 B a row at 602, read once per edge in one pass of
//   16-byte packs (three a lane; an fp32 row of 602 is aligned to 8 bytes only).  In
//   exact x is gathered in place, fp32, up to four packs a lane a pass (three passes of
//   2-float packs at 602).  One block per tile of 16 destination rows; each
//   tile is gathered into shared memory (gather_tile, its loads unconditional)
//   and multiplied by W (gather_tile.cuh's tile_gemm: W through shared memory in cp.async
//   double-buffered slices, a 4 x 4 register tile a thread, or 1 x 4 in 64-column passes when
//   H_out <= 64, so the 41-wide logits layer does not run a 256-column pass for 41 columns),
//   then the relu epilogue.  W comes padded to [H_in, ld4(H_out)].
//
// Backward design.  (a) The masked, rounded cotangent s = round(g * [y > 0]) is staged once
//   per source row by stage_cotangent (gather_tile.cuh's staging with y as the mask) into a
//   plane [N, ld] (ld = H_out rounded up to 16 bytes): bf16 in "fast" (the rounding is the
//   store), fp32 in exact with relu; exact without relu gathers g itself.  Each edge then
//   loads one 16-byte-packed row of s (512 B at H_out = 256 in fast) instead of a row of g
//   and a row of y (2 KB), and rounds nothing.  (b) u only: mega_bwd_u, lane groups of 8-32
//   lanes a row (gather_tile.cuh's gather_row), no shared memory.  (c) With dx: mega_bwd_dx
//   gathers 16 rows into a shared tile (and u), then runs the shared tile GEMM with W^T.
//
// Bits.  Every sum (the forward's tile, u) is the sum over its edges in CSR order in fp32 from
// 0 of the staged values (bf16 -> fp32 is exact, so rounding, and masking, once per source row
// equals doing it per edge), and every GEMM element one fmaf per k in ascending k from 0, as
// the region kernels compute them: a region and the chain of per-layer kernels give the same
// bits (chip_smoke.py checks both, forward and dx).
//
// Precision (binned.py:2304-2317, :2599-2615): "fast" is one bf16 rounding (round to nearest
// even) of each gathered element (x forward; the masked g backward) before its fp32 add;
// "exact" is fp32 throughout.  The relu mask is y > 0 (the TPU kernel's tie rule), not the
// 0.5 g of maximum's VJP at a tie.
//
// Bound.  Forward at Reddit shape (N = T = 232,965, E = 23.5 M, 602 -> 256): the compulsory
// bytes are x, out, W and the CSR once, about 0.9 GB (0.27 ms at 3.35 TB/s); the operations
// are E * H_in adds and 2 N H_in H_out FMA operations, 86 GFLOP (1.28 ms at 67 TFLOP/s fp32):
// operations bind.  What the kernel really moves is one staged row per edge (E * 1,216 B =
// 28.6 GB, much of it from L2) plus W once per tile through L2 (616 KB x 14,561 tiles = 9 GB,
// as 16-byte cp.async copies into shared memory); the gather dominates.  The backward's u at 602 <- 256 needs E * 256 adds (6 GFLOP,
// 0.09 ms) and moves g, y, u and the CSR once (0.8 GB, 0.24 ms): bytes bind, and the gather
// of one bf16 row per edge (12 GB, mostly from L2) is what it really moves.  With dx the GEMM
// adds 72 GFLOP (1.07 ms at 67 TFLOP/s).  Measured (chip_smoke.py, fast, Reddit): the forward
// 9.58 ms at 602 -> 256 relu, the staging's 0.28 included (torch.sparse.mm then matmul:
// 21.19), 3.21 at 256 -> 41 and 3.90 at 256 -> 256 relu; in
// exact 19.99 at 602 -> 256; the backward's u at 602 <- 256 1.98 (chip_variants.py), with dx
// 6.28 (PERF.md §6).
// Splitting hub rows, prefetching the next edge's row and a tensor-core GEMM under a 3xTF32
// split (with xlayer.cu's, so the region chain keeps its bits) are later work.

#include "gather_tile.cuh"

namespace {

using namespace roc;

// Forward: three resident blocks per SM (at most 80 registers a thread): four (64 registers)
// spill and read 10.39 against 9.54 ms at 602 -> 256 in fast, 22.23 against 19.81 in exact
// (chip_variants.py's linear_four_blocks, NVIDIA H100 80GB HBM3, 700 W, as every time quoted
// in this file).
constexpr int kMinBlocks = 3;

struct Fwd {
  const int64_t* row_ptr;
  const int32_t* col_idx;
  const void* src;    // fast: the staged bf16 plane [T, ld]; exact: x [T, *] fp32 (row stride ld)
  int64_t ld;
  int vec;            // exact: the fp32 vector width x is read with
  int64_t n;          // destination rows
  int64_t k;          // H_in
  const float* w;     // [H_in, ldw], ldw % 4 == 0, 16-byte aligned rows
  int64_t ldw;
  int64_t m;          // H_out
  float* out;         // [n, H_out]
  bool relu;
};

// out = act((A x) W): the block's tile of 16 destination rows is gathered into shared memory
// in one pass of packed rows (gather_tile), then multiplied by W through shared memory
// (tile_gemm, CG column groups a pass) with the relu epilogue.  One block per tile, the
// hardware handing tiles to SMs as they free up: tiles claimed from an atomic counter by a
// grid of resident blocks, as the region kernels do, read 10.68 against 9.54 ms at 602 -> 256
// (chip_variants.py's linear_tile_counter).
template <typename T, int CG>
__global__ void __launch_bounds__(kThreads, kMinBlocks) mega_fwd(const Fwd p) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int ts = tile_stride(p.k);
  float* wbuf = tile + kRows * ts;
  const Epilogue<float> epi{p.relu, nullptr, nullptr, 0, p.out, p.m, nullptr, 0, p.m};
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rb = p.n - row0 < kRows ? static_cast<int>(p.n - row0) : kRows;
  gather_tile<T>(p.row_ptr, p.col_idx, static_cast<const T*>(p.src), p.ld, p.vec, row0, rb,
                 p.k, tile, ts, nullptr, 0, nullptr);
  tile_gemm<CG>(tile, ts, rb, row0, p.w, p.ldw, p.k, p.m, wbuf, epi);
}

template <typename T, int CG>
int launch_fwd_cg(const Fwd& p, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(kRows) * tile_stride(p.k) + kWbufFloats) * sizeof(float);
  const int err = prepare(mega_fwd<T, CG>, smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((p.n + kRows - 1) / kRows));
  mega_fwd<T, CG><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Outputs at most 64 wide (the 41-wide logits layer) take 64-column GEMM passes.
template <typename T>
int launch_fwd(const Fwd& p, cudaStream_t s) {
  return p.m <= 64 ? launch_fwd_cg<T, 16>(p, s) : launch_fwd_cg<T, 64>(p, s);
}

// ---------------------------------------------------------------------------
// Backward.

// u only (the layer's input takes no gradient): a latency-bound gather, so no shared memory,
// no register cap beyond the block's, and a lane group of LPR lanes a row, 32 / LPR rows a
// warp, one pack a lane per pass over the row's edges, its load guarded, as the sum's at one
// pack: unconditional (clamped) loads read 2.23 against 1.98 / 1.95 ms at 602 <- 256
// (chip_variants.py's linear_u_clamped_loads).
template <typename T, int VEC, int LPR>
__global__ void __launch_bounds__(kThreads)
mega_bwd_u(const int64_t* __restrict__ rp, const int32_t* __restrict__ ci,
           const T* __restrict__ s, int64_t ld, float* __restrict__ u, int64_t rows, int64_t H) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
                          (32 / LPR) + lane / LPR;
  if (row >= rows) return;
  float* out = u + row * H;
  gather_row<T, VEC, 1, LPR, false, kRowEdges>(
      rp, ci, s, ld, row, H, lane % LPR,
      [&](int64_t c, const float (&acc)[VEC]) { store_row<VEC>(out, c, H, acc); });
}

// With dx: the block's rb <= 16 rows are gathered as above into an fp32 shared tile [rb, ts]
// (and written to u), then dx[rows, :] = tile W^T (gather_tile.cuh's tile_gemm, 256-column
// passes) with W^T [K, ldw] row-major (ldw % 4 == 0, 16-byte aligned rows; columns N .. ldw
// are padding).  Each output element is one fmaf per k in ascending k from 0: the bits of the
// region's hand-off GEMM.
template <typename T, int VEC, int LPR>
__global__ void __launch_bounds__(kThreads, 3)
mega_bwd_dx(const int64_t* __restrict__ rp, const int32_t* __restrict__ ci,
            const T* __restrict__ s, int64_t ld, const float* __restrict__ wt, int64_t ldw,
            float* __restrict__ u, float* __restrict__ dx, int64_t rows, int64_t K, int64_t N,
            int rb, int ts) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  float* wbuf = tile + static_cast<int64_t>(rb) * ts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rb;
  const int rows_here = rows - row0 < rb ? static_cast<int>(rows - row0) : rb;
  constexpr int kRpw = 32 / LPR;
  for (int r = warp * kRpw + lane / LPR; r < rows_here; r += kWarps * kRpw) {
    const int64_t row = row0 + r;
    float* trow = tile + static_cast<int64_t>(r) * ts;
    float* urow = u + row * K;
    gather_row<T, VEC, 1, LPR>(rp, ci, s, ld, row, K, lane % LPR,
                                     [&](int64_t c, const float (&acc)[VEC]) {
                                       store_row<VEC>(urow, c, K, acc);
                                       store_pack<VEC>(trow, c, K, acc);
                                     });
  }
  const Epilogue<float> epi{false, nullptr, nullptr, 0, dx, N, nullptr, 0, N};
  tile_gemm(tile, ts, rows_here, row0, wt, ldw, K, N, wbuf, epi);
}

template <typename T, int VEC, int LPR>
int launch_bwd_lpr(const int64_t* rp, const int32_t* ci, const T* s, int64_t ld, const float* wt,
                   int64_t ldw, float* u, float* dx, int64_t t, int64_t K, int64_t N,
                   cudaStream_t stream) {
  if (dx == nullptr) {
    const int64_t rows_per_block = static_cast<int64_t>(kWarps) * (32 / LPR);
    const dim3 grid(static_cast<unsigned>((t + rows_per_block - 1) / rows_per_block));
    mega_bwd_u<T, VEC, LPR><<<grid, kThreads, 0, stream>>>(rp, ci, s, ld, u, t, K);
    return static_cast<int>(cudaGetLastError());
  }
  const int ts = tile_stride(K);
  const size_t wbytes = static_cast<size_t>(kWbufFloats) * sizeof(float);
  constexpr size_t kMaxSmem = 227 * 1024;
  int rb = kRows;
  while (rb > 1 && wbytes + static_cast<size_t>(rb) * ts * sizeof(float) > kMaxSmem) --rb;
  const size_t smem = wbytes + static_cast<size_t>(rb) * ts * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare(mega_bwd_dx<T, VEC, LPR>, smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((t + rb - 1) / rb));
  mega_bwd_dx<T, VEC, LPR><<<grid, kThreads, smem, stream>>>(rp, ci, s, ld, wt, ldw, u, dx, t, K,
                                                              N, rb, ts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd(const int64_t* rp, const int32_t* ci, const T* s, int64_t ld, const float* wt,
               int64_t ldw, float* u, float* dx, int64_t t, int64_t K, int64_t N,
               cudaStream_t stream) {
  switch (lanes_per_row((K + VEC - 1) / VEC)) {
    case 8: return launch_bwd_lpr<T, VEC, 8>(rp, ci, s, ld, wt, ldw, u, dx, t, K, N, stream);
    case 16: return launch_bwd_lpr<T, VEC, 16>(rp, ci, s, ld, wt, ldw, u, dx, t, K, N, stream);
    default: return launch_bwd_lpr<T, VEC, 32>(rp, ci, s, ld, wt, ldw, u, dx, t, K, N, stream);
  }
}

// The staged cotangent: gather_tile.cuh's staging with y as the mask (g itself without relu).
template <typename T>
__global__ void __launch_bounds__(kThreads)
stage_cotangent(const float* __restrict__ g, const float* __restrict__ y, int vec, int64_t H,
                T* __restrict__ s, int64_t ld, int64_t rows) {
  stage_plane<T>(g, y, vec, H, s, ld, rows);
}

template <typename T>
int launch_stage(const float* g, const float* y, T* s, int64_t rows, int64_t H, int64_t ld,
                 int vec, cudaStream_t stream) {
  if (vec != 4 && vec != 2 && vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  stage_cotangent<T><<<grid, kThreads, 0, stream>>>(g, y, vec, H, s, ld, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by roc_tpu_torch/ops/kernels/aggregate_linear.py.  All
// tensors are on the device; row_ptr is int64, col_idx int32.  Each returns
// cudaGetLastError() after the launch (0 on success).

// out [n, h_out] = act((A x) W).  src: with round_bf16 ("fast") the staged bf16 plane of x
// [T, ld] (ld = ld8(h_in), aggregate_sum.cu's roc_stage_plane); otherwise x itself, fp32 with
// rows ld floats apart, read with vec-float loads (vec divides h_in and ld and src is aligned
// to it).  w is [h_in, ldw] fp32 (ldw % 4 == 0, 16-byte aligned; columns from h_out on are
// padding).
extern "C" int roc_aggregate_linear(const void* row_ptr, const void* col_idx, const void* src,
                                    long long ld, int vec, const void* w, long long ldw,
                                    void* out, long long num_rows, long long h_in,
                                    long long h_out, int round_bf16, int relu, void* stream) {
  if (num_rows <= 0 || h_in <= 0 || h_out <= 0 || ld < h_in || ldw < h_out || ldw % 4 != 0 ||
      (round_bf16 && ld % 8 != 0) || (!round_bf16 && vec != 4 && vec != 2 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Fwd p{static_cast<const int64_t*>(row_ptr), static_cast<const int32_t*>(col_idx), src, ld,
        vec, num_rows, h_in, static_cast<const float*>(w), ldw, h_out,
        static_cast<float*>(out), relu != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_bf16 ? launch_fwd<bf16>(p, s) : launch_fwd<float>(p, s);
}

// s (the staged cotangent plane [rows, ld]) from g and, with relu, y (both [rows, H] fp32):
// dtype 1 = bf16 ("fast"), 0 = fp32 (exact, relu only).  vec is 4, 2 or 1 (it divides H and
// g's and y's rows are aligned to it); ld >= H is a multiple of 8 (bf16) or 4 (fp32).
extern "C" int roc_stage_cotangent(const void* g, const void* y, void* s, long long rows,
                                   long long H, long long ld, int dtype, int relu, int vec,
                                   void* stream) {
  if (rows <= 0 || H <= 0 || ld < H || (relu && y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* gp = static_cast<const float*>(g);
  const float* yp = static_cast<const float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!relu) yp = nullptr;
  if (dtype == 1) return launch_stage<bf16>(gp, yp, static_cast<bf16*>(s), rows, H, ld, vec, st);
  if (dtype == 0 && relu)
    return launch_stage<float>(gp, yp, static_cast<float*>(s), rows, H, ld, vec, st);
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
    return launch_bwd<bf16, 8>(rp, ci, static_cast<const bf16*>(s), ld, wp, ldw, up, dp,
                               num_rows, h_out, h_in, st);
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
