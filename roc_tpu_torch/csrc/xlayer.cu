// Cross-layer region kernels for Hopper (sm_90a): a whole fusion region
// aggregate -> linear (-> relu) -> aggregate -> linear ... in one launch forward and one
// launch backward.  Layers are numbered l = 0 .. D-1 here (2 <= D <= kMaxDepth); layer l maps
// width H_l to H_{l+1} with W_l [H_l, H_{l+1}].
//
// Forward, roc_xlayer_fwd:   out = act_{D-1}(A ... act_0(A x W_0) ... W_{D-1})
//   x [N, H_0] fp32, A the in-edge CSR over the same N rows (a region is square: its planes
//   are both the table and the destination rows).  On an interior layer the epilogue is
//   act_l, then (v * s) * s with s the per-row scale when one is given (GCN's norm pair
//   between two layers, s = rsqrt(in_degree) computed by the caller); on the last layer it
//   is act_{D-1} alone.  Replaces the Pallas TPU kernel binned.py:2949 _xlayer_kernel
//   (pallas_call at :3164, reached by run_binned_region at :3173).
// Backward, roc_xlayer_bwd:   (dx, dW_0 .. dW_{D-1}) of the forward, given the output
//   cotangent g, the saved output y, the input x and the weights.  Replaces
//   binned.py:3226 _xlayer_bwd_kernel (pallas_call at :3581, run_binned_region_bwd :3591).
//   1. Replay: D-1 forward sweeps over the CSR refill the interior planes P_0 .. P_{D-2}
//      in their scaled form (nothing of the forward was saved but x and y).
//   2. D sweeps over the TRANSPOSED CSR, layer l = D-1 down to 0.  The staged cotangent is
//      g * [y > 0] at the last layer (the mask only with its relu), and at an interior layer
//      the handed-off cotangent c, times s twice when scaled, masked by P_l > 0 when the
//      layer has a relu.  Its sum over the transpose is u_l (written to a workspace plane);
//      the hand-off u_l W_l^T goes to the cotangent ping-pong, or to dx at l = 0 (skipped
//      when dx is not asked for).
//   3. dW_l = z_l^T u_l, z_l = P_{l-1} (x at l = 0), after each sweep: a split-K GEMM in the
//      kernel.  Rows are cut into fixed chunks of kDwSplitRows; each (chunk, 64 x 64 output
//      tile) item is one block's FMA loop over its rows in order, written to a partials
//      workspace; after a grid sync each dW element sums its chunks' partials in chunk
//      order.  No floating-point atomics: two calls give the same bits.  Workspace:
//      ceil(N / 4096) * ceil(H_l / 64) * ceil(H_{l+1} / 64) * 64 * 64 floats, the largest l
//      (37 MB at Reddit's 602 -> 256 layer).
//
// The function is copied, not the TPU schedule: bins, one-hot MXU scatters, 128-lane
// padding, VMEM admission gates and the weight stack padded to one width are not carried
// over; each layer uses its own widths.
//
// Design.  One persistent cooperative launch per pass, as the Pallas grid is one grid: the
// grid is the occupancy limit times the SM count, and cooperative_groups' grid sync
// separates the sweeps.  A launch that cannot be cooperative fails; nothing falls back to
// per-layer launches.  Each sweep runs the row-tile gather and GEMM of row_tile.cuh, the
// megakernel's own code, so a region layer gives the per-layer megakernel's bits.  Tiles of
// 16 rows are claimed from a per-sweep atomic counter, so a block that drew hub rows takes
// fewer tiles; each row is still summed by one warp in CSR order, whichever block takes it.
// The interior planes ([N, H] fp32, 238.6 MB at N = 232,965, H = 256) cannot stay on chip
// and live in device workspaces the wrapper allocates per call: 1 plane at depth 2 and a
// ping-pong of 2 beyond in the forward; D-1 replay planes, a cotangent ping-pong, u and the
// dW partials in the backward.  Planes written earlier in the same launch are read through
// L2 (ld.global.cg), never through the non-coherent read-only path.
//
// Precision: ROUND = true is "fast", one bf16 rounding of each gathered element (x or a
// plane forward, the staged cotangent backward), fp32 sums; ROUND = false is "exact".  The
// GEMMs are fp32 FMA (no TF32).  The scale is multiplied, never recomputed here: rsqrtf is
// not correctly rounded and would break parity with the per-layer chain.
//
// Bound.  Depth-3 forward at Reddit's 602 -> 256 -> 256 -> 256: GEMMs 2 N (602 * 256 + 2 *
// 256 * 256) = 132.9 GFLOP plus E (602 + 256 + 256) = 26.2 G adds, 2.4 ms at 67 TFLOP/s
// fp32; x, out, the CSR three times and the weights are about 0.9 GB, 0.27 ms at 3.35 TB/s:
// operations bind.  As in the megakernel, what the kernel really moves is one source row
// per edge and layer, mostly from L2; the gathers dominate.

#include <cooperative_groups.h>

#include <initializer_list>

#include "row_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using roc::kThreads;
using roc::Pack;

constexpr int kMaxDepth = 8;
// Four resident blocks per SM, as the megakernel (64 registers a thread): the gathers are
// latency-bound and need the warps.
constexpr int kMinBlocks = 4;
constexpr int kDwTile = 64;                 // dW output tile, k by j
constexpr int kDwRows = 16;                 // rows per shared-memory stage of the dW GEMM
constexpr int64_t kDwSplitRows = 4096;      // rows per split-K chunk of the dW GEMM

struct Region {
  int depth;
  int64_t n;                                // rows of every plane and of both CSRs
  int64_t width[kMaxDepth + 1];
  int relu[kMaxDepth];
  int vec_fwd[kMaxDepth];                   // vector load of layer l's forward gather
  int vec_bwd[kMaxDepth];                   // of layer l's transposed gather
  const int64_t* row_ptr;
  const int32_t* col_idx;
  const int64_t* t_row_ptr;                 // backward only
  const int32_t* t_col_idx;
  const float* x;
  const float* w[kMaxDepth];
  const float* wt[kMaxDepth];               // W_l^T [H_{l+1}, H_l], backward only
  const float* scale;                       // [N], or null: no norm pair between layers
  float* out;                               // forward: [N, H_D]
  float* plane[kMaxDepth];                  // forward: ping-pong; backward: P_0 .. P_{D-2}
  const float* g;                           // backward: [N, H_D]
  const float* y;                           // backward: [N, H_D], read with the last relu
  float* cot[2];                            // backward: the cotangent ping-pong
  float* u;                                 // backward: [N, H_{l+1}] of the current sweep
  float* partial;                           // backward: the dW partials
  float* dw[kMaxDepth];                     // backward: [H_l, H_{l+1}]
  float* dx;                                // backward: [N, H_0], or null
  int* counter;                             // one tile counter per sweep, zeroed
};

template <int VEC>
__device__ __forceinline__ Pack<VEC> load_cg(const float* p);

template <>
__device__ __forceinline__ Pack<4> load_cg<4>(const float* p) {
  const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
  Pack<4> o;
  o.v[0] = t.x;
  o.v[1] = t.y;
  o.v[2] = t.z;
  o.v[3] = t.w;
  return o;
}

template <>
__device__ __forceinline__ Pack<2> load_cg<2>(const float* p) {
  const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
  Pack<2> o;
  o.v[0] = t.x;
  o.v[1] = t.y;
  return o;
}

template <>
__device__ __forceinline__ Pack<1> load_cg<1>(const float* p) {
  Pack<1> o;
  o.v[0] = __ldcg(p);
  return o;
}

// A region's staged source rows: src[u, c .. c + VEC), times scale[u] twice when scale is
// given, zeroed where mask[u, :] <= 0 when mask is given.
struct PlaneRows {
  const float* src;
  const float* mask;
  const float* scale;

  template <int VEC>
  __device__ __forceinline__ Pack<VEC> load(int64_t u, int64_t c, int64_t H) const {
    Pack<VEC> s = load_cg<VEC>(src + u * H + c);
    if (scale != nullptr) {
      const float sc = __ldg(scale + u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s.v[j] = (s.v[j] * sc) * sc;
    }
    if (mask != nullptr) {
      const Pack<VEC> m = load_cg<VEC>(mask + u * H + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s.v[j] = m.v[j] > 0.f ? s.v[j] : 0.f;
    }
    return s;
  }
};

template <bool ROUND>
__device__ __forceinline__ void gather_any(int vec, const int64_t* rp, const int32_t* ci,
                                           const PlaneRows& rows, int64_t row0, int rb, int64_t n,
                                           int64_t H, float* tile, int stride, float* gout) {
  switch (vec) {
    case 4: roc::gather_rows<4, ROUND>(rp, ci, rows, row0, rb, n, H, tile, stride, gout); break;
    case 2: roc::gather_rows<2, ROUND>(rp, ci, rows, row0, rb, n, H, tile, stride, gout); break;
    default: roc::gather_rows<1, ROUND>(rp, ci, rows, row0, rb, n, H, tile, stride, gout); break;
  }
}

// One sweep over a CSR: for every row v, t = the sum over v's edges of rows.load(u, :) at
// width h_gather (written to gout[v, :] when gout is given); then, when dst is given,
// dst[v, :] = epilogue(t W) with W [h_gather, h_out].  Tiles are claimed from *counter.
template <bool ROUND>
__device__ void sweep(const int64_t* rp, const int32_t* ci, const PlaneRows& rows, int vec,
                      int64_t n, int64_t h_gather, const float* w, int64_t h_out, float* dst,
                      bool relu, const float* scale, float* gout, int* counter, float* tile,
                      int* claim) {
  int rb, stride;
  roc::tile_shape(h_gather, &rb, &stride);
  const int64_t tiles = (n + rb - 1) / rb;
  for (;;) {
    if (threadIdx.x == 0) *claim = atomicAdd(counter, 1);
    __syncthreads();
    const int64_t t = *claim;
    if (t >= tiles) break;  // every thread read the same claim: the block leaves together
    const int64_t row0 = t * rb;
    gather_any<ROUND>(vec, rp, ci, rows, row0, rb, n, h_gather, tile, stride, gout);
    if (dst != nullptr) {
      __syncthreads();
      roc::tile_gemm(tile, stride, rb, row0, n, w, h_gather, h_out, dst, relu, scale);
    }
    __syncthreads();  // the tile and the claim are free again
  }
}

struct DwShape {
  int64_t k, j, kt, jt, splits;
};

__host__ __device__ inline DwShape dw_shape(int64_t n, int64_t k, int64_t j) {
  return {k, j, (k + kDwTile - 1) / kDwTile, (j + kDwTile - 1) / kDwTile,
          (n + kDwSplitRows - 1) / kDwSplitRows};
}

// partial[item] = z[rows of the item's chunk, the item's k tile]^T u[same rows, its j tile],
// each item summed by one block over its rows in order.  Thread t owns the 4 x 4 outputs at
// k = 4 (t / 16) .., j = 4 (t % 16) ...
__device__ void dw_partials(const Region& p, int l, const float* z, float* smem) {
  const DwShape s = dw_shape(p.n, p.width[l], p.width[l + 1]);
  const int64_t items = s.splits * s.kt * s.jt;
  float* zs = smem;                         // [kDwRows][kDwTile]
  float* us = smem + kDwRows * kDwTile;     // [kDwRows][kDwTile]
  const int tk = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t sp = item / (s.kt * s.jt);
    const int64_t rem = item % (s.kt * s.jt);
    const int64_t k0 = (rem / s.jt) * kDwTile;
    const int64_t j0 = (rem % s.jt) * kDwTile;
    const int64_t r_beg = sp * kDwSplitRows;
    const int64_t r_end = r_beg + kDwSplitRows < p.n ? r_beg + kDwSplitRows : p.n;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int64_t r0 = r_beg; r0 < r_end; r0 += kDwRows) {
      for (int e = threadIdx.x; e < kDwRows * kDwTile; e += kThreads) {
        const int64_t r = r0 + e / kDwTile;
        const int64_t c = e % kDwTile;
        zs[e] = (r < r_end && k0 + c < s.k) ? __ldcg(z + r * s.k + k0 + c) : 0.f;
        us[e] = (r < r_end && j0 + c < s.j) ? __ldcg(p.u + r * s.j + j0 + c) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kDwRows; ++i) {
        const float4 za = *reinterpret_cast<const float4*>(zs + i * kDwTile + tk * 4);
        const float4 ub = *reinterpret_cast<const float4*>(us + i * kDwTile + tj * 4);
        const float zv[4] = {za.x, za.y, za.z, za.w};
        const float uv[4] = {ub.x, ub.y, ub.z, ub.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(zv[a], uv[b], acc[a][b]);
      }
      __syncthreads();
    }
    float* dst = p.partial + item * (kDwTile * kDwTile);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dst[(tk * 4 + a) * kDwTile + tj * 4 + b] = acc[a][b];
  }
}

// dW_l[k, j] = the sum of its partials in chunk order.
__device__ void dw_reduce(const Region& p, int l) {
  const DwShape s = dw_shape(p.n, p.width[l], p.width[l + 1]);
  const int64_t total = s.k * s.j;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += step) {
    const int64_t k = e / s.j;
    const int64_t j = e % s.j;
    const int64_t tile = (k / kDwTile) * s.jt + j / kDwTile;
    const int64_t off = (k % kDwTile) * kDwTile + j % kDwTile;
    float v = 0.f;
    for (int64_t sp = 0; sp < s.splits; ++sp)
      v += __ldcg(p.partial + (sp * s.kt * s.jt + tile) * (kDwTile * kDwTile) + off);
    p.dw[l][e] = v;
  }
}

template <bool ROUND>
__global__ void __launch_bounds__(kThreads, kMinBlocks) xlayer_fwd(const Region p) {
  extern __shared__ float4 smem[];
  __shared__ int claim;
  float* tile = reinterpret_cast<float*>(smem);
  cg::grid_group grid = cg::this_grid();
  for (int l = 0; l < p.depth; ++l) {
    const bool last = l == p.depth - 1;
    const float* src = l == 0 ? p.x : p.plane[(l - 1) % 2];
    sweep<ROUND>(p.row_ptr, p.col_idx, PlaneRows{src, nullptr, nullptr}, p.vec_fwd[l], p.n,
                 p.width[l], p.w[l], p.width[l + 1], last ? p.out : p.plane[l % 2],
                 p.relu[l] != 0, last ? nullptr : p.scale, nullptr, p.counter + l, tile, &claim);
    if (!last) grid.sync();
  }
}

template <bool ROUND>
__global__ void __launch_bounds__(kThreads, kMinBlocks) xlayer_bwd(const Region p) {
  extern __shared__ float4 smem[];
  __shared__ int claim;
  float* tile = reinterpret_cast<float*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int D = p.depth;
  int* counter = p.counter;
  // 1. replay the interior planes, scaled as the forward left them
  for (int l = 0; l + 1 < D; ++l) {
    sweep<ROUND>(p.row_ptr, p.col_idx, PlaneRows{l == 0 ? p.x : p.plane[l - 1], nullptr, nullptr},
                 p.vec_fwd[l], p.n, p.width[l], p.w[l], p.width[l + 1], p.plane[l],
                 p.relu[l] != 0, p.scale, nullptr, counter++, tile, &claim);
    grid.sync();
  }
  // 2-3. the transposed sweeps, last layer first, each followed by its dW
  for (int s = 0; s < D; ++s) {
    const int l = D - 1 - s;
    const PlaneRows rows =
        s == 0 ? PlaneRows{p.g, p.relu[l] ? p.y : nullptr, nullptr}
               : PlaneRows{p.cot[(s - 1) % 2], p.relu[l] ? p.plane[l] : nullptr, p.scale};
    sweep<ROUND>(p.t_row_ptr, p.t_col_idx, rows, p.vec_bwd[l], p.n, p.width[l + 1], p.wt[l],
                 p.width[l], l > 0 ? p.cot[s % 2] : p.dx, false, nullptr, p.u, counter++, tile,
                 &claim);
    grid.sync();
    dw_partials(p, l, l == 0 ? p.x : p.plane[l - 1], tile);
    grid.sync();
    // the next sweep writes u and the other cotangent plane, never the partials, which the
    // next dw_partials rewrites only after another grid sync
    dw_reduce(p, l);
  }
}

size_t tile_bytes(int64_t H) {
  int rb, stride;
  roc::tile_shape(H, &rb, &stride);
  return static_cast<size_t>(rb) * stride * sizeof(float);
}

int vec_for(int64_t H, const void* a, const void* b = nullptr, const void* c = nullptr,
            const void* d = nullptr) {
  for (int v = 4; v > 1; v /= 2) {
    if (H % v != 0) continue;
    const uintptr_t align = static_cast<uintptr_t>(4 * v);
    bool ok = true;
    for (const void* q : {a, b, c, d})
      if (q != nullptr && reinterpret_cast<uintptr_t>(q) % align != 0) ok = false;
    if (ok) return v;
  }
  return 1;
}

// The cooperative launch: the grid is every block that can be resident at once.
template <typename Kernel>
int launch_coop(Kernel kernel, Region& p, size_t smem, cudaStream_t stream, int* grid_out) {
  int err = roc::prepare(kernel, smem);
  if (err != 0) return err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = static_cast<int>(cudaGetDevice(&dev))) != 0) return err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem));
  if (err != 0) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const dim3 grid(static_cast<unsigned>(per_sm * sms));
  void* args[] = {&p};
  err = static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                                     dim3(kThreads), args, smem, stream));
  if (err != 0) return err;
  if (grid_out != nullptr) *grid_out = static_cast<int>(grid.x);
  return static_cast<int>(cudaGetLastError());
}

int fill_common(Region& p, const void* row_ptr, const void* col_idx, const void* x,
                const void* const* w, const void* scale, const int* relu,
                const long long* width, int depth, long long n) {
  if (depth < 2 || depth > kMaxDepth || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  p.depth = depth;
  p.n = n;
  for (int l = 0; l <= depth; ++l) {
    if (width[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    p.width[l] = width[l];
  }
  for (int l = 0; l < depth; ++l) {
    p.relu[l] = relu[l] != 0;
    p.w[l] = static_cast<const float*>(w[l]);
  }
  p.row_ptr = static_cast<const int64_t*>(row_ptr);
  p.col_idx = static_cast<const int32_t*>(col_idx);
  p.x = static_cast<const float*>(x);
  p.scale = static_cast<const float*>(scale);
  return 0;
}

}  // namespace

// C interface, bound with ctypes by roc_tpu_torch/ops/kernels/xlayer.py.  Every tensor is
// contiguous on the device: fp32 data, int64 row pointers, int32 column indices; w, wt, dw,
// plane, relu and width are host arrays of depth (width: depth + 1) entries.  counter
// points to zeroed ints: depth of them forward, 2 depth - 1 backward.  Each returns the
// CUDA error of the launch (0 on success) and writes the grid size to *grid.

// plane: 2 planes of n * max(H_1 .. H_{D-1}) floats (the same one twice at depth 2).
extern "C" int roc_xlayer_fwd(const void* row_ptr, const void* col_idx, const void* x,
                              const void* const* w, const void* scale, const int* relu,
                              const long long* width, int depth, long long n, void* out,
                              void* const* plane, void* counter, int round_bf16, void* stream,
                              int* grid) {
  Region p = {};
  int err = fill_common(p, row_ptr, col_idx, x, w, scale, relu, width, depth, n);
  if (err != 0) return err;
  p.out = static_cast<float*>(out);
  p.plane[0] = static_cast<float*>(plane[0]);
  p.plane[1] = static_cast<float*>(plane[1]);
  p.counter = static_cast<int*>(counter);
  size_t smem = 0;
  for (int l = 0; l < depth; ++l) {
    const void* src = l == 0 ? x : plane[(l - 1) % 2];
    p.vec_fwd[l] = vec_for(p.width[l], src);
    const size_t b = tile_bytes(p.width[l]);
    if (b > smem) smem = b;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_bf16 ? launch_coop(xlayer_fwd<true>, p, smem, s, grid)
                    : launch_coop(xlayer_fwd<false>, p, smem, s, grid);
}

// Floats of the dW partials workspace roc_xlayer_bwd needs.
extern "C" long long roc_xlayer_partial_floats(long long n, const long long* width, int depth) {
  long long most = 0;
  for (int l = 0; l < depth; ++l) {
    const DwShape s = dw_shape(n, width[l], width[l + 1]);
    const long long f = s.splits * s.kt * s.jt * kDwTile * kDwTile;
    if (f > most) most = f;
  }
  return most;
}

// plane: the D-1 replay planes, n * H_{l+1} floats each; cot: 2 planes of
// n * max(H_1 .. H_{D-1}) floats (the same one twice at depth 2); u: n * max(H_1 .. H_D)
// floats; partial: roc_xlayer_partial_floats floats; y may be null without a last relu and
// dx null when dx is not asked for.
extern "C" int roc_xlayer_bwd(const void* row_ptr, const void* col_idx, const void* t_row_ptr,
                              const void* t_col_idx, const void* x, const void* const* w,
                              const void* const* wt, const void* scale, const int* relu,
                              const long long* width, int depth, long long n, const void* g,
                              const void* y, void* const* plane, void* const* cot, void* u,
                              void* partial, void* const* dw, void* dx, void* counter,
                              int round_bf16, void* stream, int* grid) {
  Region p = {};
  int err = fill_common(p, row_ptr, col_idx, x, w, scale, relu, width, depth, n);
  if (err != 0) return err;
  if (p.relu[depth - 1] && y == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.t_row_ptr = static_cast<const int64_t*>(t_row_ptr);
  p.t_col_idx = static_cast<const int32_t*>(t_col_idx);
  p.g = static_cast<const float*>(g);
  p.y = static_cast<const float*>(y);
  p.cot[0] = static_cast<float*>(cot[0]);
  p.cot[1] = static_cast<float*>(cot[1]);
  p.u = static_cast<float*>(u);
  p.partial = static_cast<float*>(partial);
  p.dx = static_cast<float*>(dx);
  p.counter = static_cast<int*>(counter);
  size_t smem = 2 * kDwRows * kDwTile * sizeof(float);
  for (int l = 0; l < depth; ++l) {
    p.wt[l] = static_cast<const float*>(wt[l]);
    p.dw[l] = static_cast<float*>(dw[l]);
    if (l + 1 < depth) {
      p.plane[l] = static_cast<float*>(plane[l]);
      p.vec_fwd[l] = vec_for(p.width[l], l == 0 ? x : plane[l - 1]);
      const size_t b = tile_bytes(p.width[l]);
      if (b > smem) smem = b;
    }
    p.vec_bwd[l] = l == depth - 1
                       ? vec_for(p.width[l + 1], g, p.relu[l] ? y : nullptr, u)
                       : vec_for(p.width[l + 1], cot[0], cot[1], p.relu[l] ? plane[l] : nullptr, u);
    const size_t b = tile_bytes(p.width[l + 1]);
    if (b > smem) smem = b;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_bf16 ? launch_coop(xlayer_bwd<true>, p, smem, s, grid)
                    : launch_coop(xlayer_bwd<false>, p, smem, s, grid);
}
