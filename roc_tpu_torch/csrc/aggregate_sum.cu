// CSR sum aggregation for Hopper (sm_90a): out[v] = sum over in-edges (u -> v) of x[u].
//
// Replaces the four Pallas TPU kernels that compute this one function through
// roc_tpu/ops/pallas/binned.py:run_binned:
//   _p1_kernel (binned.py:1885, and its _p1_kernel_simple variant at :1848),
//   _p1_flat_kernel (binned.py:1991), _p2_kernel (binned.py:2107) and
//   _fused_kernel (binned.py:2153).
// The TPU schedule (128-lane padding, slots, bins and the one-hot MXU scatters) exists only
// because the TPU has no cache in front of HBM and tiles in (8, 128).  None of it is carried
// over: on Hopper the gather rides L2, so the kernel is a deterministic CSR SpMM over the
// destination-sorted in-edge lists.  What is kept is the TPU kernels' staging of x as bf16 in
// "fast" (binned.py:37-39, staging_dtype :406): it is the function, one rounding per element.
//
// Design.  Two launches in "fast" on an fp32 x, one otherwise:
//   roc_stage_plane writes x once as a bf16 plane [T, ld8(H)] (columns from H on zero), the
//   rounding done once per source row instead of once per edge; the whole plane is read
//   E times by the gather, so halving its rows (512 B at H = 256) halves what every edge
//   moves.
//   roc_aggregate_sum is gather_tile.cuh's one-pass packed gather, one destination row per lane
//   group: lanes own 16-byte packs (8 bf16, or in exact up to 4 fp32 read from x in place),
//   a group of 8, 16 or 32 lanes a row, as many packs a lane as the row needs (3 at 602 bf16,
//   one pass; up to 4 fp32, one pass at 256), so a narrow row (H = 41: 6 packs, 8 lanes) does
//   not leave most of a warp idle: a warp then sums 4 rows.  Each output row is written once,
//   by the one group that summed it: no atomics, the same bits on every run.  Lanes a row and
//   edges in flight are launch arguments (launch_sum): 0 takes the rule above, and the
//   autotuner (roc_tpu_torch/tune/) picks others per graph, direction and width; no choice
//   changes a bit.
// A bf16 x is already rounded and is gathered directly (sum_rows_bf16), the output in bf16.
//
// Precision (the contract of binned.py:37-46): "fast" on fp32 input sums, in fp32 from 0 in
// CSR order, each element of x rounded once to bf16 (round to nearest even); bf16 -> fp32 is
// exact, so the staged plane gives the bits of the per-edge rounding.  "exact" is fp32 end to
// end.  The output is in the input dtype.
//
// Bound.  The compulsory traffic is reading x once, row_ptr and col_idx once, and writing
// out once: (T * H + N * H) * sizeof(T) + 8 (N + 1) + 4 E bytes (0.17 ms at Reddit, H = 256,
// 3.35 TB/s); E * H adds are 6 GFLOP (0.09 ms at 67 TFLOP/s fp32): bytes bind.  What the
// kernel really moves is one plane row per edge: E * 512 B = 12.0 GB at H = 256 in fast (an
// fp32 row would be 24.1 GB), most of it from the 50 MB L2.  Measured (chip_variants.py's
// checkout build, Reddit, NVIDIA H100 80GB HBM3, 700 W): fast at H = 256 3.28 ms over the CSR,
// the staging's 0.12 included (torch.sparse.mm: 6.73 in chip_smoke.py), 1.83 over the
// transposed CSR, 0.49 and 0.47 at H = 41, 9.96 at 602; exact 6.99 at 256 (PERF.md §6).
// Splitting hub rows and prefetching the next edge's row are later work.

#include "gather_tile.cuh"

namespace {

using namespace roc;

// One row per lane group of LPR lanes, 32 / LPR rows a warp; src is [*, ld] (a bf16 plane,
// or fp32 x in place with ld its row stride); EDGES edges in flight (gather_row's UNROLL).  A
// lane that owns one pack a pass guards its load; with more it clamps its surplus packs
// (gather_row's CLAMP): clamped at one pack too, the transposed sum at H = 256 read 2.15
// against 1.83 / 1.82 ms (chip_variants.py's sum_clamped_loads), guarded at three, the
// 602-wide sum 11.41 against 9.96 / 9.94 (sum_guarded_loads; NVIDIA H100 80GB HBM3, 700 W).
template <typename T, int VEC, int PACKS, int LPR, int EDGES>
__global__ void __launch_bounds__(kThreads)
sum_rows(const int64_t* __restrict__ rp, const int32_t* __restrict__ ci, const T* __restrict__ src,
         int64_t ld, float* __restrict__ out, int64_t n, int64_t H) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
                          (32 / LPR) + lane / LPR;
  if (row >= n) return;
  float* orow = out + row * H;
  gather_row<T, VEC, PACKS, LPR, (PACKS > 1), EDGES>(
      rp, ci, src, ld, row, H, lane % LPR,
      [&](int64_t c, const float (&a)[VEC]) { store_row<VEC>(orow, c, H, a); });
}

struct SumArgs {
  const int64_t* rp;
  const int32_t* ci;
  const void* src;
  int64_t ld;
  float* out;
  int64_t n, H;
  cudaStream_t s;
};

template <typename T, int VEC, int PACKS, int LPR, int EDGES>
int launch_rows(const SumArgs& a) {
  const int64_t rows_per_block = static_cast<int64_t>(kWarps) * (32 / LPR);
  const dim3 grid(static_cast<unsigned>((a.n + rows_per_block - 1) / rows_per_block));
  sum_rows<T, VEC, PACKS, LPR, EDGES><<<grid, kThreads, 0, a.s>>>(
      a.rp, a.ci, static_cast<const T*>(a.src), a.ld, a.out, a.n, a.H);
  return static_cast<int>(cudaGetLastError());
}

// The launch configurations built.  Where a bf16 plane ("fast") or 4-float packs ("exact" on
// an aligned x) are gathered, every LPR of 8, 16, 32 with every packs-a-lane count
// packs_per_lane gives it, at 1, 2 or 4 edges in flight: the autotuner's lattice
// (roc_tpu_torch/tune/lattice.py, which mirrors this rule).  At 2- and 1-float packs only
// the default rule is built (LPR 8 and 16 with one pack a lane, 32 with any, kRowEdges in flight).
// nvcc time grows with each instantiation (PERF.md §6 has the build's seconds).
template <typename T, int VEC>
constexpr bool kTunable = sizeof(T) == 2 || VEC == 4;

template <typename T, int VEC, int LPR, int EDGES>
int launch_packs(int ppl, const SumArgs& a) {
  if (ppl == 1) return launch_rows<T, VEC, 1, LPR, EDGES>(a);
  if constexpr (kTunable<T, VEC> || LPR == 32) {
    if (ppl == 2) return launch_rows<T, VEC, 2, LPR, EDGES>(a);
    if (ppl == 3) return launch_rows<T, VEC, 3, LPR, EDGES>(a);
    if constexpr (sizeof(T) == 4)
      if (ppl == 4) return launch_rows<T, VEC, 4, LPR, EDGES>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int VEC, int EDGES>
int launch_lanes(int lpr, int ppl, const SumArgs& a) {
  switch (lpr) {
    case 8: return launch_packs<T, VEC, 8, EDGES>(ppl, a);
    case 16: return launch_packs<T, VEC, 16, EDGES>(ppl, a);
    case 32: return launch_packs<T, VEC, 32, EDGES>(ppl, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// lpr lanes a row (0: lanes_per_row, the fewest that cover the row in one pass), the packs a
// lane as packs_per_lane gives them for lpr, edges in flight (0: kRowEdges).  A combination
// that is not built returns cudaErrorInvalidValue.  No choice reassociates a sum: each lane
// adds its packs over the row's edges in CSR order from 0 (gather_row).
template <typename T, int VEC>
int launch_sum(const SumArgs& a, int lpr, int edges) {
  const int64_t packs = (a.H + VEC - 1) / VEC;
  if (lpr == 0) lpr = lanes_per_row(packs);
  if (edges == 0) edges = kRowEdges;
  if (lpr != 8 && lpr != 16 && lpr != 32) return static_cast<int>(cudaErrorInvalidValue);
  const int ppl = packs_per_lane<T>(packs, lpr);
  if (edges == kRowEdges) return launch_lanes<T, VEC, kRowEdges>(lpr, ppl, a);
  if constexpr (kTunable<T, VEC>) {
    if (edges == 1) return launch_lanes<T, VEC, 1>(lpr, ppl, a);
    if (edges == 4) return launch_lanes<T, VEC, 4>(lpr, ppl, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_f32(const SumArgs& a, int vec, int lpr, int edges) {
  switch (vec) {
    case 4: return launch_sum<float, 4>(a, lpr, edges);
    case 2: return launch_sum<float, 2>(a, lpr, edges);
    case 1: return launch_sum<float, 1>(a, lpr, edges);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A bf16 x, gathered directly (already rounded): a warp per row, VEC bf16 elements a lane
// (VEC divides H and keeps the rows aligned), column tiles of 32 VEC, the sums rounded once
// to bf16 on the store.
template <int VEC>
struct alignas(2 * VEC) Bf16Pack {
  bf16 v[VEC];
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
sum_rows_bf16(const int64_t* __restrict__ rp, const int32_t* __restrict__ ci,
              const bf16* __restrict__ x, bf16* __restrict__ out, int64_t n, int64_t H) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const int64_t beg = rp[row], end = rp[row + 1];
  for (int64_t c = static_cast<int64_t>(lane) * VEC; c < H; c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int64_t e = beg; e < end; ++e) {
      const Bf16Pack<VEC> p =
          *reinterpret_cast<const Bf16Pack<VEC>*>(x + static_cast<int64_t>(ci[e]) * H + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += __bfloat162float(p.v[j]);
    }
    Bf16Pack<VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = to_bf16(acc[j]);
    *reinterpret_cast<Bf16Pack<VEC>*>(out + row * H + c) = o;
  }
}

template <int VEC>
int launch_bf16(const int64_t* rp, const int32_t* ci, const bf16* x, bf16* out, int64_t n,
                int64_t H, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + kWarps - 1) / kWarps));
  sum_rows_bf16<VEC><<<grid, kThreads, 0, s>>>(rp, ci, x, out, n, H);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads)
stage_kernel(const float* __restrict__ x, int64_t ldx, int vec, int64_t H, bf16* __restrict__ dst,
             int64_t ld, int64_t n) {
  stage_plane<bf16>(x, nullptr, vec, H, dst, ld, n, ldx);
}

// The same plane in fp32 (no rounding): the GAT forward's 16-byte rows of a narrow x.
__global__ void __launch_bounds__(kThreads)
stage_kernel_f32(const float* __restrict__ x, int64_t ldx, int vec, int64_t H,
                 float* __restrict__ dst, int64_t ld, int64_t n) {
  stage_plane<float>(x, nullptr, vec, H, dst, ld, n, ldx);
}

}  // namespace

// C interface, bound with ctypes by roc_tpu_torch/ops/kernels/aggregate_sum.py.  row_ptr is
// int64 [n + 1], col_idx int32; every tensor is on the device.  Each returns cudaGetLastError()
// after the launch (0 on success).

// dst [n, ld] = x [n, H] (rows ldx floats apart), columns from H on 0: bf16 rounded to nearest
// even (ld = ld8(H)), or with fp32 = 1 fp32 as it is (ld = ld4(H)).  vec (4, 2 or 1) divides H
// and ldx and x is aligned to it.
extern "C" int roc_stage_plane(const void* x, long long ldx, long long n, long long H, int vec,
                               void* dst, long long ld, int fp32, void* stream) {
  if (n <= 0 || H <= 0 || ldx < H || ld < H || ld % (fp32 ? 4 : 8) != 0 || ldx % vec != 0 ||
      H % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kWarps - 1) / kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  if (fp32)
    stage_kernel_f32<<<grid, kThreads, 0, s>>>(xf, ldx, vec, H, static_cast<float*>(dst), ld, n);
  else
    stage_kernel<<<grid, kThreads, 0, s>>>(xf, ldx, vec, H, static_cast<bf16*>(dst), ld, n);
  return static_cast<int>(cudaGetLastError());
}

// out [n, H] = the sum over each CSR row's edges of src's rows.
//   kind 0: src is fp32 [*, ld] (x in place), summed as is ("exact");
//   kind 1: src is a staged bf16 plane [*, ld] (ld = ld8(H)), out fp32 ("fast" on fp32 x);
//   kind 2: src is bf16 [*, H] (a bf16 x), out bf16.
// vec: the fp32 vector width (kind 0: divides H and ld, src aligned to it) or the bf16 one
// (kind 2: 4, 2 or 1, dividing H); ignored for kind 1.  lpr (8, 16, 32) and edges (1, 2, 4) are
// kinds 0 and 1's launch configuration (launch_sum), 0 each for the default rule; kind 2 takes
// 0 and 0 only.
extern "C" int roc_aggregate_sum(const void* row_ptr, const void* col_idx, const void* src,
                                 long long ld, int kind, int vec, void* out, long long n,
                                 long long H, int lpr, int edges, void* stream) {
  if (n <= 0 || H <= 0 || ld < H) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* rp = static_cast<const int64_t*>(row_ptr);
  const int32_t* ci = static_cast<const int32_t*>(col_idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SumArgs a{rp, ci, src, ld, static_cast<float*>(out), n, H, s};
  switch (kind) {
    case 0:
      return launch_f32(a, vec, lpr, edges);
    case 1:
      if (ld % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return launch_sum<bf16, 8>(a, lpr, edges);
    case 2: {
      const bf16* x = static_cast<const bf16*>(src);
      bf16* o = static_cast<bf16*>(out);
      if (ld != H || lpr != 0 || edges != 0) return static_cast<int>(cudaErrorInvalidValue);
      switch (vec) {
        case 4: return launch_bf16<4>(rp, ci, x, o, n, H, s);
        case 2: return launch_bf16<2>(rp, ci, x, o, n, H, s);
        case 1: return launch_bf16<1>(rp, ci, x, o, n, H, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
