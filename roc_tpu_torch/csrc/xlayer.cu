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
//   0. Staging: the last layer's staged cotangent S_{D-1} = g * [y > 0] (g without its relu).
//   1. Replay: D-1 forward sweeps over the CSR refill the interior planes P_0 .. P_{D-2} in
//      their scaled form (nothing of the forward was saved but x and y).
//   2. D sweeps over the TRANSPOSED CSR, layer l = D-1 down to 0: u_l = A^T S_l (written to a
//      workspace plane), then the hand-off v = u_l W_l^T, whose epilogue forms the next
//      layer's staged cotangent S_{l-1} = ((v * s) * s) * [P_{l-1} > 0] (the scale when
//      given, the mask with layer l-1's relu), or writes dx at l = 0 (skipped when dx is not
//      asked for).
//   3. dW_l = z_l^T u_l, z_l = P_{l-1} (x at l = 0), after each sweep: a split-K GEMM in the
//      kernel (see dw_partials), reduced in chunk order: no floating-point atomics, so two
//      calls give the same bits.
//
// The function is copied, not the TPU schedule: bins, one-hot MXU scatters, 128-lane
// padding, VMEM admission gates and the weight stack padded to one width are not carried
// over; each layer uses its own widths.
//
// Precision: the template type T is the type of every plane a sweep gathers.  T = bf16 is
// "fast": each gathered element is rounded once to bf16 (round to nearest even), and the
// rounding is done where the element is formed, once per source row, not once per edge:
// x is staged into a bf16 plane (phase 0), the forward's interior planes are stored as
// bf16, the replay writes a bf16 shadow of each plane the next replay layer gathers, and
// the staged cotangents are bf16.  bf16 -> fp32 is exact, so every sum sees the values the
// per-edge rounding formed, in the same CSR order from 0: the bits of the chain of per-layer
// megakernels (aggregate_linear.cu), which chip_smoke.py checks.  T = float is "exact":
// fp32 throughout, x gathered in place.  Sums are fp32 from 0 in CSR order.  The GEMMs are
// fp32 FMA (no TF32): each output element one fmaf per k in ascending k from 0, the bits of
// the per-layer megakernel's forward (the same tile_gemm) and of mega_bwd_dx.  The scale is
// multiplied, never recomputed here: rsqrtf is not correctly rounded and would break parity
// with the per-layer chain.
//
// Design.  One persistent cooperative launch per pass, as the Pallas grid is one grid: the
// grid is the occupancy limit times the SM count, and cooperative_groups' grid sync
// separates the phases.  A launch that cannot be cooperative fails; nothing falls back to
// per-layer launches.  A sweep claims tiles of 16 destination rows from a per-sweep atomic
// counter (a block that drew hub rows takes fewer tiles).  Each warp sums its rows of the
// tile: lane i owns the 16-byte packs i, i + 32, ... of the row (8 bf16 or 4 fp32 values),
// so one pass over the row's edges covers up to 32 * kMaxPacks packs (768 bf16 columns: the
// 602-wide layer in one pass, where 16-byte fp32 loads of 128-column spans took five; in
// exact, x read in place at 602 in three passes of 2-float packs).
// The staging, the gather (with guarded loads) and the tile GEMM are gather_tile.cuh's,
// shared with the per-layer kernels.  The tile [16, H] goes to shared memory (and, over the
// transpose, to u), then the tile's GEMM: the weight comes through shared memory in cp.async
// double-buffered slices of 8 rows by 256 columns, each thread owns a 4 x 4 register tile
// (mega_bwd_dx's scheme), and the tile rows have an odd count of 16-byte chunks, so the
// float4 reads along k are free of bank conflicts.  Interior planes cannot stay on chip
// ([N, 256] fp32 is 238.6 MB at Reddit) and live in device workspaces the wrapper allocates
// per call.  Planes written earlier in the same launch are read through L2 (ld.global.cg,
// cp.async.cg), never through the non-coherent read-only path.
//
// dW is the one GEMM whose bits no chain check pins (it is held per element against the
// plain version).  Rows are cut into fixed chunks of kDwSplitRows; each (chunk, 64 x 128
// output tile) item is one block's FMA loop over its rows in order, 32 rows a stage brought
// in by cp.async, double-buffered, and a 4 x 8 register tile a thread; its partial goes to
// a workspace, and after a grid sync each dW element sums its chunks' partials in chunk
// order.  FMA, not a 3xTF32 tensor-core split: chip_smoke.py's phase split of the previous
// design put dW at 7.0 of 93.5 ms, already ~19 TFLOP/s, and the split is exact on the
// integer fixtures only while one operand of each product fits 11 significant bits and the
// other 22, which nothing bounds there; a faster FMA loop keeps the contract and the
// fixture exact (6.1 ms; 64-column tiles read 8.1, 16-row stages 6.8).
//
// Bound.  Depth-3 forward at Reddit's 602 -> 256 -> 256 -> 256: GEMMs 2 N (602 * 256 + 2 *
// 256 * 256) = 132.9 GFLOP plus E (602 + 256 + 256) = 26.2 G adds, 2.4 ms at 67 TFLOP/s
// fp32; x, out, the CSR three times and the weights are about 0.9 GB, 0.27 ms at 3.35 TB/s:
// operations bind.  What the kernel really moves is one source row per edge and layer
// (1,216 B at 608 bf16, 512 B at 256), mostly from L2; the gathers dominate.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "gather_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace roc;  // staging, the packed gather, the tile GEMM and their constants

constexpr int kMaxDepth = 8;
// Three resident blocks per SM (80 registers a thread, some spilled): the gathers are
// latency-bound and need the warps, and 3 x 55 KB of shared memory fit the SM.  Two blocks
// (128 registers, almost no spills) read slower: 25.63 / 46.92 ms against 23.14 / 41.06
// (fast forward / backward at Reddit's depth-3 region; chip_variants.py, NVIDIA H100 80GB
// HBM3, 700 W, as every time quoted in this file).
constexpr int kMinBlocks = 3;
constexpr int kDwK = 64;                    // dW output tile: k (rows of dW) by
constexpr int kDwJ = 128;                   // j (columns)
constexpr int kDwJT = kDwJ / 16;            // j columns a thread owns, in float4s 64 apart
constexpr int kDwStage = 32;                // rows per cp.async stage of the dW GEMM
constexpr int64_t kDwSplitRows = 3072;      // rows per split-K chunk of the dW GEMM

struct Region {
  int depth;
  int64_t n;                                // rows of every plane and of both CSRs
  int64_t width[kMaxDepth + 1];
  int relu[kMaxDepth];
  int vec_x;                                // the fp32 vector width x is read with
  int vec_g;                                // backward: the vector width g and y are read with
  const int64_t* row_ptr;
  const int32_t* col_idx;
  const int64_t* t_row_ptr;                 // backward only
  const int32_t* t_col_idx;
  const float* x;                           // [N, H_0] fp32
  void* xs;                                 // fast: staged x, bf16 [N, ld(H_0)]; exact: null
  const float* w[kMaxDepth];                // W_l [H_l, ld4(H_{l+1})]
  const float* wt[kMaxDepth];               // W_l^T [H_{l+1}, ld4(H_l)], backward only
  const float* scale;                       // [N], or null: no norm pair between layers
  float* out;                               // forward: [N, H_D]
  void* plane[2];                           // T [N, ld(H)]: the forward's ping-pong, the
                                            // backward's replay shadow (fast only)
  float* rplane[kMaxDepth];                 // backward: P_0 .. P_{D-2}, fp32 [N, ld4(H_{l+1})]
  const float* g;                           // backward: [N, H_D]
  const float* y;                           // backward: [N, H_D], read with the last relu
  void* stg[2];                             // backward: staged cotangent ping-pong, T [N, ld(H)]
  float* u;                                 // backward: [N, ld4(H_{l+1})] of the current sweep
  float* partial;                           // backward: the dW partials
  float* dw[kMaxDepth];                     // backward: [H_l, H_{l+1}]
  float* dx;                                // backward: [N, H_0], or null
  int* counter;                             // one tile counter per sweep, zeroed
  unsigned long long* stamps;               // phase split: %globaltimer stamps, or null
};

// The phase split: with p.stamps set, block 0 thread 0 writes %globaltimer (ns) at the
// kernel's start and after every grid sync, so stamp i + 1 - stamp i is phase i.  The
// training and serving paths pass null and pay one untaken branch per phase.
__device__ __forceinline__ void stamp(const Region& p, int* k) {
  if (p.stamps == nullptr) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[*k] = t;
  }
  ++*k;
}

// One sweep over a CSR: for every tile of 16 rows, the sums over each row's edges of the T
// plane src [*, ld] at width H, to u [*, ldu] when u is given; then, when B is given, the
// tile's GEMM with B [H, N] and its epilogue.  Tiles are claimed from *counter; without B
// (u alone) warps claim single rows instead.
template <typename T, class Epi>
__device__ __forceinline__ void sweep(const int64_t* rp, const int32_t* ci, const T* src,
                                      int64_t ld, int vec, int64_t n, int64_t H, float* u,
                                      int64_t ldu, const float* B, int64_t ldb, int64_t N,
                                      const Epi& epi, int* counter, float* smem) {
  if (B == nullptr) {
    gather_tile<T, false>(rp, ci, src, ld, vec, 0, static_cast<int>(n), H, nullptr, 0, u, ldu,
                          counter);
    return;
  }
  const int ts = tile_stride(H);
  int* claim = reinterpret_cast<int*>(smem);
  float* tile = smem + 4;
  float* wbuf = tile + kRows * ts;
  const int64_t tiles = (n + kRows - 1) / kRows;
  for (;;) {
    if (threadIdx.x == 0) *claim = atomicAdd(counter, 1);
    __syncthreads();
    const int64_t t = *claim;
    if (t >= tiles) break;  // every thread read the same claim: the block leaves together
    const int64_t row0 = t * kRows;
    const int rb = n - row0 < kRows ? static_cast<int>(n - row0) : kRows;
    gather_tile<T, false>(rp, ci, src, ld, vec, row0, rb, H, tile, ts, u, ldu, nullptr);
    tile_gemm(tile, ts, rb, row0, B, ldb, H, N, wbuf, epi);
    __syncthreads();  // the tile and the claim are free again
  }
}

// The backward's sweeps, out of line: they then get their own register allocation rather
// than sharing the backward body's with dw_partials (a transposed 256-wide sweep read 5.96
// against 6.78 ms inlined; the forward, which has no dW, keeps its sweeps inlined).
template <typename T, class Epi>
__device__ __noinline__ void sweep_outlined(const int64_t* rp, const int32_t* ci, const T* src,
                                            int64_t ld, int vec, int64_t n, int64_t H, float* u,
                                            int64_t ldu, const float* B, int64_t ldb, int64_t N,
                                            const Epi& epi, int* counter, float* smem) {
  sweep<T>(rp, ci, src, ld, vec, n, H, u, ldu, B, ldb, N, epi, counter, smem);
}

// Shared memory a sweep of gather width H needs, in bytes.
size_t sweep_smem(int64_t H) {
  return (4 + static_cast<size_t>(kRows) * tile_stride(H) + kWbufFloats) * sizeof(float);
}

// ---------------------------------------------------------------------------
// dW.

struct DwShape {
  int64_t k, j, kt, jt, splits;
};

__host__ __device__ inline DwShape dw_shape(int64_t n, int64_t k, int64_t j) {
  return {k, j, (k + kDwK - 1) / kDwK, (j + kDwJ - 1) / kDwJ,
          (n + kDwSplitRows - 1) / kDwSplitRows};
}

// A stage of the dW GEMM: rows r0 .. r0 + 32 of z's k columns k0 .. k0 + 64 and of u's j
// columns j0 .. j0 + 128 into zs [32][64] and us [32][128].  z is read with zvec-float
// cp.async copies (z's rows are aligned to them), u with 16-byte ones; rows at or past r_end
// and columns past a row's stride are zero.
__device__ __forceinline__ void dw_stage(const float* z, int64_t ldz, int zvec, const float* u,
                                         int64_t ldu, int64_t r0, int64_t r_end, int64_t k0,
                                         int64_t j0, float* zs, float* us) {
  const int tid = threadIdx.x;
  const int zper = kDwK / zvec;  // copies per z row
  for (int q = tid; q < kDwStage * zper; q += kThreads) {
    const int i = q / zper, c = (q % zper) * zvec;
    const int64_t r = r0 + i, k = k0 + c;
    float* dst = zs + i * kDwK + c;
    if (r < r_end && k + zvec <= ldz) {
      const float* s = z + r * ldz + k;
      if (zvec == 4) cp_async16(dst, s);  // through L2: P_{l-1} was written in this launch
      else if (zvec == 2) roc::cp_async_ca<8>(dst, s);  // x, an input of the launch
      else roc::cp_async_ca<4>(dst, s);
    } else {
      for (int j = 0; j < zvec; ++j) dst[j] = 0.f;
    }
  }
  for (int q = tid; q < kDwStage * (kDwJ / 4); q += kThreads) {
    const int i = q / (kDwJ / 4), c = (q % (kDwJ / 4)) * 4;
    const int64_t r = r0 + i, j = j0 + c;
    float* dst = us + i * kDwJ + c;
    if (r < r_end && j + 4 <= ldu) cp_async16(dst, u + r * ldu + j);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
}

// partial[item] = z[rows of the item's chunk, its k tile]^T u[same rows, its j tile], each
// item summed by one block over its rows in order.  Thread t owns the 4 x 8 outputs at
// k = 4 (t / 16) .., j = 4 (t % 16) .. and 64 + 4 (t % 16) .. (two float4 reads a row, each
// a quarter-warp's 128 contiguous bytes).  z: x [N, H_0] (ldz = H_0, zvec its vector width)
// or P_{l-1} (ld4, zvec 4).
__device__ __noinline__ void dw_partials(const Region& p, int l, const float* z, int64_t ldz,
                                         int zvec, float* smem) {
  const DwShape s = dw_shape(p.n, p.width[l], p.width[l + 1]);
  const int64_t ldu = ld4(p.width[l + 1]);
  const int64_t items = s.splits * s.kt * s.jt;
  float* zs[2] = {smem, smem + kDwStage * kDwK};
  float* us[2] = {smem + 2 * kDwStage * kDwK, smem + 2 * kDwStage * kDwK + kDwStage * kDwJ};
  const int tk = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t sp = item / (s.kt * s.jt);
    const int64_t rem = item % (s.kt * s.jt);
    const int64_t k0 = (rem / s.jt) * kDwK;
    const int64_t j0 = (rem % s.jt) * kDwJ;
    const int64_t r_beg = sp * kDwSplitRows;
    const int64_t r_end = r_beg + kDwSplitRows < p.n ? r_beg + kDwSplitRows : p.n;
    const int nst = static_cast<int>((r_end - r_beg + kDwStage - 1) / kDwStage);
    float acc[4][kDwJT];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < kDwJT; ++b) acc[a][b] = 0.f;
    dw_stage(z, ldz, zvec, p.u, ldu, r_beg, r_end, k0, j0, zs[0], us[0]);
    for (int st = 0; st < nst; ++st) {
      if (st + 1 < nst) {
        dw_stage(z, ldz, zvec, p.u, ldu, r_beg + (st + 1) * kDwStage, r_end, k0, j0,
                 zs[(st + 1) & 1], us[(st + 1) & 1]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* zb = zs[st & 1] + tk * 4;
      const float* ub = us[st & 1] + tj * 4;
#pragma unroll 2
      for (int i = 0; i < kDwStage; ++i) {
        const float4 za = *reinterpret_cast<const float4*>(zb + i * kDwK);
        const float zv[4] = {za.x, za.y, za.z, za.w};
        float uv[kDwJT];
#pragma unroll
        for (int q = 0; q < kDwJT / 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(ub + i * kDwJ + 64 * q);
          uv[4 * q] = t.x; uv[4 * q + 1] = t.y; uv[4 * q + 2] = t.z; uv[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < kDwJT; ++b) acc[a][b] = fmaf(zv[a], uv[b], acc[a][b]);
      }
      __syncthreads();  // the buffer is free for the stage after next
    }
    float* dst = p.partial + item * (kDwK * kDwJ);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < kDwJT / 4; ++q)
        *reinterpret_cast<float4*>(dst + (tk * 4 + a) * kDwJ + 64 * q + tj * 4) = make_float4(
            acc[a][4 * q], acc[a][4 * q + 1], acc[a][4 * q + 2], acc[a][4 * q + 3]);
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
    const int64_t tile = (k / kDwK) * s.jt + j / kDwJ;
    const int64_t off = (k % kDwK) * kDwJ + j % kDwJ;
    float v = 0.f;
    for (int64_t sp = 0; sp < s.splits; ++sp)
      v += __ldcg(p.partial + (sp * s.kt * s.jt + tile) * (kDwK * kDwJ) + off);
    p.dw[l][e] = v;
  }
}

size_t dw_smem() { return 2 * kDwStage * (kDwK + kDwJ) * sizeof(float); }

// ---------------------------------------------------------------------------
// The kernels.

// The plane layer l gathers in the forward and in the replay: x (staged in fast), or the
// previous layer's plane (the forward's ping-pong, the replay's shadow in fast or P_{l-1}
// in exact).
template <typename T>
__device__ __forceinline__ const T* layer_src(const Region& p, int l, bool replay, int64_t* ld,
                                              int* vec) {
  *vec = 4;
  if (l == 0) {
    if constexpr (sizeof(T) == 2) {
      *ld = ld8(p.width[0]);
      return static_cast<const T*>(p.xs);
    } else {
      *ld = p.width[0];
      *vec = p.vec_x;
      return reinterpret_cast<const T*>(p.x);
    }
  }
  *ld = ld_of<T>(p.width[l]);
  if (replay && sizeof(T) == 4) return reinterpret_cast<const T*>(p.rplane[l - 1]);
  return static_cast<const T*>(p.plane[(l - 1) % 2]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) xlayer_fwd(const Region p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  int k = 0;
  stamp(p, &k);
  if constexpr (sizeof(T) == 2) {
    stage_plane<T>(p.x, nullptr, p.vec_x, p.width[0], static_cast<T*>(p.xs), ld8(p.width[0]),
                   p.n);
    grid.sync();
    stamp(p, &k);
  }
  for (int l = 0; l < p.depth; ++l) {
    const bool last = l == p.depth - 1;
    int64_t ld;
    int vec;
    const T* src = layer_src<T>(p, l, false, &ld, &vec);
    const int64_t N = p.width[l + 1];
    Epilogue<T> epi{p.relu[l] != 0, last ? nullptr : p.scale, nullptr, 0,
                    last ? p.out : nullptr, N,
                    last ? nullptr : static_cast<T*>(p.plane[l % 2]), ld_of<T>(N), N};
    sweep<T>(p.row_ptr, p.col_idx, src, ld, vec, p.n, p.width[l], nullptr, 0, p.w[l], ld4(N), N,
             epi, p.counter + l, smem);
    if (!last || p.stamps != nullptr) grid.sync();
    stamp(p, &k);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) xlayer_bwd(const Region p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int D = p.depth;
  int* counter = p.counter;
  int k = 0;
  stamp(p, &k);
  // 0. stage x (fast) and the last layer's cotangent
  if constexpr (sizeof(T) == 2)
    stage_plane<T>(p.x, nullptr, p.vec_x, p.width[0], static_cast<T*>(p.xs), ld8(p.width[0]),
                   p.n);
  stage_plane<T>(p.g, p.relu[D - 1] ? p.y : nullptr, p.vec_g, p.width[D],
                 static_cast<T*>(p.stg[0]), ld_of<T>(p.width[D]), p.n);
  grid.sync();
  stamp(p, &k);
  // 1. replay the interior planes, scaled as the forward left them (fp32, with a bf16
  // shadow for the next replay layer's gather in fast)
  for (int l = 0; l + 1 < D; ++l) {
    int64_t ld;
    int vec;
    const T* src = layer_src<T>(p, l, true, &ld, &vec);
    const int64_t N = p.width[l + 1];
    const bool shadow = sizeof(T) == 2 && l + 2 < D;
    Epilogue<T> epi{p.relu[l] != 0, p.scale, nullptr, 0, p.rplane[l], ld4(N),
                    shadow ? static_cast<T*>(p.plane[l % 2]) : nullptr, ld_of<T>(N), N};
    sweep_outlined<T>(p.row_ptr, p.col_idx, src, ld, vec, p.n, p.width[l], nullptr, 0, p.w[l],
                      ld4(N), N, epi, counter++, smem);
    grid.sync();
    stamp(p, &k);
  }
  // 2-3. the transposed sweeps, last layer first, each followed by its dW
  for (int s = 0; s < D; ++s) {
    const int l = D - 1 - s;
    const int64_t K = p.width[l + 1], N = p.width[l];
    const bool gemm = l > 0 || p.dx != nullptr;
    Epilogue<T> epi{false, l > 0 ? p.scale : nullptr,
                    l > 0 && p.relu[l - 1] ? p.rplane[l - 1] : nullptr, ld4(N),
                    l > 0 ? nullptr : p.dx, N,
                    l > 0 ? static_cast<T*>(p.stg[(s + 1) % 2]) : nullptr, ld_of<T>(N), N};
    sweep_outlined<T>(p.t_row_ptr, p.t_col_idx, static_cast<const T*>(p.stg[s % 2]),
                      ld_of<T>(K), 4, p.n, K, p.u, ld4(K), gemm ? p.wt[l] : nullptr, ld4(N), N,
                      epi, counter++, smem);
    grid.sync();
    stamp(p, &k);
    if (l == 0) dw_partials(p, l, p.x, p.width[0], p.vec_x, smem);
    else dw_partials(p, l, p.rplane[l - 1], ld4(p.width[l]), 4, smem);
    grid.sync();
    stamp(p, &k);
    // the next sweep writes u and the other staged plane, never the partials, which the
    // next dw_partials rewrites only after another grid sync
    dw_reduce(p, l);
    if (p.stamps != nullptr) {
      grid.sync();
      stamp(p, &k);
    }
  }
}

int vec_for(int64_t H, const void* a, const void* b = nullptr) {
  for (int v = 4; v > 1; v /= 2)
    if (H % v == 0 && reinterpret_cast<uintptr_t>(a) % (4 * v) == 0 &&
        reinterpret_cast<uintptr_t>(b) % (4 * v) == 0)
      return v;
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

// Bytes of dynamic shared memory a kernel asks for, for the launch's gathered widths.
size_t region_smem(const long long* width, int depth, bool backward) {
  size_t most = backward ? dw_smem() : 0;
  for (int l = 0; l < depth; ++l) {
    const size_t a = sweep_smem(width[l]);
    const size_t b = backward ? sweep_smem(width[l + 1]) : 0;
    most = a > most ? a : most;
    most = b > most ? b : most;
  }
  return most;
}

int fill_common(Region& p, const void* row_ptr, const void* col_idx, const void* x, void* xs,
                const void* const* w, const void* scale, const int* relu,
                const long long* width, int depth, long long n, int round_bf16) {
  if (depth < 2 || depth > kMaxDepth || n <= 0 || n > INT32_MAX || (round_bf16 && xs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.xs = xs;
  p.vec_x = vec_for(width[0], x);
  p.scale = static_cast<const float*>(scale);
  return 0;
}

}  // namespace

// C interface, bound with ctypes by roc_tpu_torch/ops/kernels/xlayer.py.  Every tensor is
// contiguous on the device: fp32 data, int64 row pointers, int32 column indices; w, wt, dw,
// plane, relu and width are host arrays of depth (width: depth + 1) entries.  Weights come
// padded: W_l as [H_l, ld4(H_{l+1})], W_l^T as [H_{l+1}, ld4(H_l)] (ld4: rounded up to 4
// columns).  "T planes" are bf16 with round_bf16 ("fast") and fp32 otherwise, with rows of
// ld8(H) (bf16) or ld4(H) (fp32) elements.  xs is the staged x, a bf16 [n, ld8(H_0)]
// workspace, with round_bf16 (null otherwise).  counter points to zeroed ints: depth of them
// forward, 2 depth - 1 backward.  stamps is null or takes the phase split (xlayer.py's
// phases()).  Each returns the CUDA error of the launch (0 on success) and writes the grid
// size to *grid.

// plane: 2 T planes of n * ld(max(H_1 .. H_{D-1})) elements (the same one twice at depth 2).
extern "C" int roc_xlayer_fwd(const void* row_ptr, const void* col_idx, const void* x, void* xs,
                              const void* const* w, const void* scale, const int* relu,
                              const long long* width, int depth, long long n, void* out,
                              void* const* plane, void* counter, void* stamps, int round_bf16,
                              void* stream, int* grid) {
  Region p = {};
  int err = fill_common(p, row_ptr, col_idx, x, xs, w, scale, relu, width, depth, n, round_bf16);
  if (err != 0) return err;
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.out = static_cast<float*>(out);
  p.plane[0] = plane[0];
  p.plane[1] = plane[1];
  p.counter = static_cast<int*>(counter);
  const size_t smem = region_smem(width, depth, false);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_bf16 ? launch_coop(xlayer_fwd<bf16>, p, smem, s, grid)
                    : launch_coop(xlayer_fwd<float>, p, smem, s, grid);
}

// Floats of the dW partials workspace roc_xlayer_bwd needs.
extern "C" long long roc_xlayer_partial_floats(long long n, const long long* width, int depth) {
  long long most = 0;
  for (int l = 0; l < depth; ++l) {
    const DwShape s = dw_shape(n, width[l], width[l + 1]);
    const long long f = s.splits * s.kt * s.jt * kDwK * kDwJ;
    if (f > most) most = f;
  }
  return most;
}

// rplane: the D-1 replay planes, fp32 n * ld4(H_{l+1}) each; plane: with round_bf16, the
// replay's bf16 shadow ping-pong, 2 planes of n * ld8(max(H_1 .. H_{D-2})) (unused at depth
// 2), else null; stg: 2 T planes of n * ld(max(H_1 .. H_D)) (the staged cotangents); u:
// n * ld4(max(H_1 .. H_D)) floats; partial: roc_xlayer_partial_floats floats; y may be null
// without a last relu and dx null when dx is not asked for.
extern "C" int roc_xlayer_bwd(const void* row_ptr, const void* col_idx, const void* t_row_ptr,
                              const void* t_col_idx, const void* x, void* xs,
                              const void* const* w, const void* const* wt, const void* scale,
                              const int* relu, const long long* width, int depth, long long n,
                              const void* g, const void* y, void* const* rplane,
                              void* const* plane, void* const* stg, void* u, void* partial,
                              void* const* dw, void* dx, void* counter, void* stamps,
                              int round_bf16, void* stream, int* grid) {
  Region p = {};
  int err = fill_common(p, row_ptr, col_idx, x, xs, w, scale, relu, width, depth, n, round_bf16);
  if (err != 0) return err;
  if (p.relu[depth - 1] && y == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.t_row_ptr = static_cast<const int64_t*>(t_row_ptr);
  p.t_col_idx = static_cast<const int32_t*>(t_col_idx);
  p.g = static_cast<const float*>(g);
  p.y = static_cast<const float*>(y);
  p.vec_g = vec_for(width[depth], g, y);
  if (plane != nullptr) {
    p.plane[0] = plane[0];
    p.plane[1] = plane[1];
  }
  p.stg[0] = stg[0];
  p.stg[1] = stg[1];
  p.u = static_cast<float*>(u);
  p.partial = static_cast<float*>(partial);
  p.dx = static_cast<float*>(dx);
  p.counter = static_cast<int*>(counter);
  for (int l = 0; l < depth; ++l) {
    p.wt[l] = static_cast<const float*>(wt[l]);
    p.dw[l] = static_cast<float*>(dw[l]);
    if (l + 1 < depth) p.rplane[l] = static_cast<float*>(rplane[l]);
  }
  const size_t smem = region_smem(width, depth, true);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_bf16 ? launch_coop(xlayer_bwd<bf16>, p, smem, s, grid)
                    : launch_coop(xlayer_bwd<float>, p, smem, s, grid);
}
