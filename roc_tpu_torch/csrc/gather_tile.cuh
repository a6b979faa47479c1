// The device layer that the sum aggregation (aggregate_sum.cu), the whole-layer megakernel
// (aggregate_linear.cu) and the cross-layer regions (xlayer.cu) share: the bf16 staging of an
// fp32 plane, the one-pass packed CSR gather, and the 16-row tile GEMM through shared memory.
//
// Staging (stage_rows).  dst[r, c] = src[r, c] * [mask[r, c] > 0] (src itself without a mask)
//   for c < H, stored as T (bf16 rounded to nearest even: the "fast" rounding, done once per
//   source row rather than once per edge; or fp32), and 0 for H <= c < ld.  Rows of the plane
//   are ld elements, 16-byte aligned (ld8 for bf16, ld4 for fp32), so a gather reads whole
//   16-byte packs, and a pack that runs past H sums zeros that are never stored.
//
// Gather (gather_row).  A lane group of LPR lanes (8, 16 or 32) owns a destination row; lane
//   sl of it owns the packs sl, sl + LPR, ... (PACKS of them a pass) of VEC elements (8 bf16 or
//   4/2/1 fp32) of the row, walks the row's edges in CSR order and sums each element in fp32
//   from 0.  One pass covers LPR * PACKS packs: a staged 602-wide row is 76 packs, one pass of
//   three packs a lane (an fp32 row of 602 is aligned to 8 bytes only).  The loads of a
//   pass are unconditional (a lane's surplus packs re-read the row's last pack), so they are
//   all in flight at once.  bf16 -> fp32 is exact, so a sum over a staged plane equals the sum
//   of the per-edge roundings of x.
//
// Tile GEMM (tile_gemm).  The tile [rb <= 16, K] in shared memory (rows of an odd count of
//   16-byte chunks, so float4 reads along k are free of bank conflicts) times B [K, N] (row
//   stride ldb % 4 == 0, 16-byte aligned rows).  B comes through shared memory in cp.async
//   double-buffered slices; the output is walked in passes of 4 CG columns; thread (warp w,
//   lane l) owns the 4 columns of column group w * CG / 8 + l % (CG / 8) and the rows
//   l / (CG / 8) + (256 / CG) i: CG = 64 gives 256-column passes and a 4 x 4 register tile,
//   CG = 16 (outputs at most 64 wide) 64-column passes and a 1 x 4 tile, so a 41-wide output
//   keeps 11 of 16 column groups busy instead of 11 of 64.  Each output element is one fmaf
//   per k in ascending k from 0.  No tensor cores: the contract is fp32 at
//   Precision.HIGHEST, which TF32 and bf16 would break.
//
// Every sum is fp32 from 0 in CSR order and every GEMM element one fmaf per k from 0, so a
// region layer (xlayer.cu) and the per-layer megakernel (aggregate_linear.cu) give the same
// bits on the same input, as the unstaged per-edge rounding did.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace roc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStaticSmem = 48 * 1024;  // above this a launch must opt in
constexpr int kRows = 16;               // destination rows per tile
constexpr int kKSlice = 8;              // B rows per cp.async stage of a 256-column pass
constexpr int kPassCols = 256;          // output columns of the widest GEMM pass
constexpr int kMaxPacks = 3;            // bf16 16-byte packs per lane per pass over the edges
// Edges a lane group keeps in flight in the kernels whose warps run free over rows (the sum,
// the megakernel backward's u): many resident warps already overlap their loads, and over the
// transposed (sorted) CSR more edges in flight a warp read slower: 4 took 2.02 against 1.83
// ms for the sum at H = 256 and 2.13 against 1.98 for the backward's u at 602 <- 256
// (chip_variants.py's sum_four_edges and linear_four_edges; NVIDIA H100 80GB HBM3, 700 W).  A
// tile's warps wait for each other at the tile GEMM, so the tile kernels keep more in flight
// (gather_row's default).  kRowEdges is the sum's default: its launch takes edges in flight (1,
// 2 or 4) and lanes a row as arguments (aggregate_sum.cu's launch_sum), which the autotuner
// chooses per graph, direction and width (roc_tpu_torch/tune/).
constexpr int kRowEdges = 2;

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem <= kStaticSmem) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)));
}

__host__ __device__ inline int64_t ld4(int64_t h) { return (h + 3) / 4 * 4; }
__host__ __device__ inline int64_t ld8(int64_t h) { return (h + 7) / 8 * 8; }

// Row stride of a T plane: 16-byte aligned rows.
template <typename T>
__host__ __device__ inline int64_t ld_of(int64_t h) {
  return sizeof(T) == 2 ? ld8(h) : ld4(h);
}

// ---------------------------------------------------------------------------
// Conversions and packed loads.  Gathered planes are read through L2 (__ldcg): a plane may
// have been written earlier in the same launch (the regions), and the other kernels read theirs
// the same way.

// fp32 -> bf16, rounded to nearest even: the "fast" rounding.
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }

// The two bf16 halves of a 32-bit word as fp32 (exact): the low half is the first element.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// VEC elements of T at p (aligned to the pack) as fp32: 8 bf16 or 4, 2, 1 fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_pack(const T* p, float (&v)[VEC]) {
  if constexpr (sizeof(T) == 2) {
    static_assert(VEC == 8, "bf16 planes are read in 16-byte packs");
    const uint4 t = __ldcg(reinterpret_cast<const uint4*>(p));
    v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x);
    v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
    v[4] = bf16_lo(t.z); v[5] = bf16_hi(t.z);
    v[6] = bf16_lo(t.w); v[7] = bf16_hi(t.w);
  } else if constexpr (VEC == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    static_assert(VEC == 1, "fp32 packs are 4, 2 or 1 elements");
    v[0] = __ldcg(p);
  }
}

// dst[c .. c + VEC) of an fp32 row of width H (the columns below H only); dst + c is
// aligned to the pack when the pack is whole.
template <int VEC>
__device__ __forceinline__ void store_pack(float* dst, int64_t c, int64_t H,
                                           const float (&a)[VEC]) {
  if (c + VEC <= H) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        *reinterpret_cast<float4*>(dst + c + 4 * q) =
            make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(dst + c) = make_float2(a[0], a[1]);
    } else {
      dst[c] = a[0];
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (c + j < H) dst[c + j] = a[j];
  }
}

// row[c .. c + VEC) of an fp32 output with rows of H elements (the columns below H only):
// the widest stores the row's alignment allows (row 0 is 16-byte aligned; c % VEC == 0).
template <int VEC>
__device__ __forceinline__ void store_row(float* __restrict__ row, int64_t c, int64_t H,
                                          const float (&a)[VEC]) {
  if (c + VEC <= H) {
    if constexpr (VEC % 4 == 0) {
      if (H % 4 == 0) {
        store_pack<VEC>(row, c, H, a);
        return;
      }
    }
    if constexpr (VEC % 2 == 0) {
      if (H % 2 == 0) {
#pragma unroll
        for (int q = 0; q < VEC / 2; ++q)
          *reinterpret_cast<float2*>(row + c + 2 * q) = make_float2(a[2 * q], a[2 * q + 1]);
        return;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (c + j < H) row[c + j] = a[j];
}

// VEC fp32 values of a read-only input at p (aligned to the pack).
template <int VEC>
__device__ __forceinline__ void load_in(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// VEC values stored as T at p (aligned to the pack): bf16 rounded to nearest even.
template <typename T, int VEC>
__device__ __forceinline__ void store_low(T* p, const float (&v)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    store_pack<VEC>(reinterpret_cast<float*>(p), 0, VEC, v);
  } else if constexpr (VEC == 1) {
    *p = to_bf16(v[0]);
  } else {
    unsigned w[VEC / 2];
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) {
      const __nv_bfloat162 h = __halves2bfloat162(to_bf16(v[2 * q]), to_bf16(v[2 * q + 1]));
      w[q] = *reinterpret_cast<const unsigned*>(&h);
    }
    if constexpr (VEC == 4) *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else *reinterpret_cast<unsigned*>(p) = w[0];
  }
}

// ---------------------------------------------------------------------------
// Staging.

// dst[r, c] = src[r, c] * [mask[r, c] > 0] (src itself without mask) for c < H, stored as T
// (bf16: rounded to nearest even), and 0 for H <= c < ld.  src's and mask's rows are lds
// elements apart.  A warp per row, rows grid-strided; VEC columns a lane (VEC divides H and
// lds, and src and mask are aligned to it; ld is a multiple of 4).
template <typename T, int VEC>
__device__ void stage_rows(const float* __restrict__ src, const float* __restrict__ mask,
                           int64_t lds, int64_t H, T* dst, int64_t ld, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); row < n;
       row += stride) {
    for (int64_t c = static_cast<int64_t>(lane) * VEC; c < ld; c += 32 * VEC) {
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = 0.f;
      if (c < H) {
        load_in<VEC>(src + row * lds + c, v);
        if (mask != nullptr) {
          float m[VEC];
          load_in<VEC>(mask + row * lds + c, m);
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[j] = m[j] > 0.f ? v[j] : 0.f;
        }
      }
      store_low<T, VEC>(dst + row * ld + c, v);
    }
  }
}

// stage_rows at the vector width vec (4, 2 or 1); lds defaults to H (contiguous rows).
template <typename T>
__device__ void stage_plane(const float* src, const float* mask, int vec, int64_t H, T* dst,
                            int64_t ld, int64_t n, int64_t lds) {
  switch (vec) {
    case 4: stage_rows<T, 4>(src, mask, lds, H, dst, ld, n); break;
    case 2: stage_rows<T, 2>(src, mask, lds, H, dst, ld, n); break;
    default: stage_rows<T, 1>(src, mask, lds, H, dst, ld, n); break;
  }
}

template <typename T>
__device__ __forceinline__ void stage_plane(const float* src, const float* mask, int vec,
                                            int64_t H, T* dst, int64_t ld, int64_t n) {
  stage_plane<T>(src, mask, vec, H, dst, ld, n, H);
}

// ---------------------------------------------------------------------------
// Gather.

// Row `row` of a CSR summed over its edges, in CSR order, in fp32 from 0, by the LPR lanes of
// a lane group: lane sl of it owns the packs sl + LPR p (p < PACKS) of each pass of LPR * PACKS
// packs over the row's columns, and hands each pack's sums to emit(c, acc) (columns c .. c +
// VEC, c < H).  src is [*, ld]; a pack may run past H into the row's padding (ld >= the packs'
// end), whose columns are summed in their own registers and never emitted.  UNROLL edges are
// in flight at once (times PACKS loads a lane).  With CLAMP, a pack
// that lies wholly past the row's last pack reads that last pack instead (its sums are never
// emitted), so every load of an edge is unconditional; without it the load is guarded, which
// compiles to a branch around a load and its use and serializes the loads of a pass: the
// megakernel forward read 14.59 against 9.54 ms at 602 -> 256 so (chip_variants.py's
// linear_guarded_loads), and the region kernels, whose sweeps keep the guarded loads, read
// 20.38 / 37.06 ms with CLAMP against 22.99 / 40.88 (xlayer_clamped_loads).  The free-running
// row kernels (the sum where a lane owns one pack a pass, the megakernel backward's u) guard:
// there it measured faster.
template <typename T, int VEC, int PACKS, int LPR = 32, bool CLAMP = true,
          int UNROLL = (PACKS <= 2 ? 4 : 2), class Emit>
__device__ __forceinline__ void gather_row(const int64_t* __restrict__ rp,
                                           const int32_t* __restrict__ ci, const T* src,
                                           int64_t ld, int64_t row, int64_t H, int sl,
                                           const Emit& emit) {
  const int64_t beg = rp[row], end = rp[row + 1];
  for (int64_t c0 = 0; c0 < H; c0 += LPR * VEC * PACKS) {
    float acc[PACKS][VEC];
#pragma unroll
    for (int p = 0; p < PACKS; ++p)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[p][j] = 0.f;
    if constexpr (CLAMP) {
      const int64_t last = (H + VEC - 1) / VEC * VEC - VEC;  // the row's last pack
      int64_t off[PACKS];
#pragma unroll
      for (int p = 0; p < PACKS; ++p) {
        const int64_t c = c0 + (p * LPR + sl) * VEC;
        off[p] = c < last ? c : last;
      }
#pragma unroll UNROLL
      for (int64_t e = beg; e < end; ++e) {
        const T* s = src + static_cast<int64_t>(ci[e]) * ld;
#pragma unroll
        for (int p = 0; p < PACKS; ++p) {
          float v[VEC];
          load_pack<T, VEC>(s + off[p], v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[p][j] += v[j];
        }
      }
    } else {
      const T* base = src + c0 + sl * VEC;
#pragma unroll UNROLL
      for (int64_t e = beg; e < end; ++e) {
        const T* s = base + static_cast<int64_t>(ci[e]) * ld;
#pragma unroll
        for (int p = 0; p < PACKS; ++p) {
          if (c0 + (p * LPR + sl) * VEC < H) {
            float v[VEC];
            load_pack<T, VEC>(s + p * LPR * VEC, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[p][j] += v[j];
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PACKS; ++p) {
      const int64_t c = c0 + (p * LPR + sl) * VEC;
      if (c < H) emit(c, acc[p]);
    }
  }
}

// The block's tile: warp w sums rows row0 + w, row0 + w + 8, ... below row0 + rb into the
// tile (row stride ts) and, when u is given, into u [*, ldu].  With tile == nullptr (u alone,
// no GEMM) the warp instead claims single rows from *counter (rb is then the row count), so no
// warp waits for another's hub row.
template <typename T, int VEC, int PACKS, bool CLAMP>
__device__ __forceinline__ void gather_rows(const int64_t* rp, const int32_t* ci, const T* src,
                                            int64_t ld, int64_t row0, int rb, int64_t H,
                                            float* tile, int ts, float* u, int64_t ldu,
                                            int* counter) {
  const int lane = threadIdx.x & 31;
  if (tile == nullptr) {
    for (;;) {
      int row = 0;
      if (lane == 0) row = atomicAdd(counter, 1);
      row = __shfl_sync(0xffffffffu, row, 0);
      if (row >= rb) return;
      float* urow = u + row * ldu;
      gather_row<T, VEC, PACKS, 32, CLAMP>(
          rp, ci, src, ld, row, H, lane,
          [&](int64_t c, const float (&a)[VEC]) { store_pack<VEC>(urow, c, H, a); });
    }
  }
  for (int r = threadIdx.x >> 5; r < rb; r += kWarps) {
    const int64_t row = row0 + r;
    float* trow = tile + static_cast<int64_t>(r) * ts;
    float* urow = u != nullptr ? u + row * ldu : nullptr;
    gather_row<T, VEC, PACKS, 32, CLAMP>(rp, ci, src, ld, row, H, lane,
                                      [&](int64_t c, const float (&a)[VEC]) {
                                        store_pack<VEC>(trow, c, H, a);
                                        if (urow != nullptr) store_pack<VEC>(urow, c, H, a);
                                      });
  }
}

// Lanes per row: the fewest of 8, 16, 32 that cover a row's packs in one pass.
__host__ __device__ inline int lanes_per_row(int64_t packs) {
  return packs <= 8 ? 8 : packs <= 16 ? 16 : 32;
}

// Packs a lane owns per pass for a row of `packs` packs: as many as the row needs, up to
// kMaxPacks bf16 packs (the 602-wide row in one pass at 76 packs) or 4 fp32 packs (three
// passes of 2-float packs at 602 in exact: one pass of up to 12 read 30.45 against 22.16 ms
// for the region's 602-wide layer; NVIDIA H100 80GB HBM3, 700 W).
template <typename T>
__host__ __device__ inline int packs_per_lane(int64_t packs, int lanes) {
  constexpr int kBig = sizeof(T) == 2 ? kMaxPacks : 4;
  const int64_t per_lane = (packs + lanes - 1) / lanes;
  return per_lane <= 1 ? 1 : per_lane == 2 ? 2 : per_lane == 3 ? 3 : kBig;
}

template <typename T, int VEC, bool CLAMP>
__device__ __forceinline__ void gather_rows_v(const int64_t* rp, const int32_t* ci, const T* src,
                                              int64_t ld, int64_t row0, int rb, int64_t H,
                                              float* tile, int ts, float* u, int64_t ldu,
                                              int* counter) {
  constexpr int kBig = sizeof(T) == 2 ? kMaxPacks : 4;
  switch (packs_per_lane<T>((H + VEC - 1) / VEC, 32)) {
    case 1: gather_rows<T, VEC, 1, CLAMP>(rp, ci, src, ld, row0, rb, H, tile, ts, u, ldu, counter); break;
    case 2: gather_rows<T, VEC, 2, CLAMP>(rp, ci, src, ld, row0, rb, H, tile, ts, u, ldu, counter); break;
    case 3: gather_rows<T, VEC, 3, CLAMP>(rp, ci, src, ld, row0, rb, H, tile, ts, u, ldu, counter); break;
    default:
      gather_rows<T, VEC, kBig, CLAMP>(rp, ci, src, ld, row0, rb, H, tile, ts, u, ldu, counter);
      break;
  }
}

// rb rows from row0 of a T plane [*, ld] at width H into the tile (and u), or every row into
// u alone (see gather_rows); vec is the fp32 vector width (bf16 planes are always read as
// 8-element packs).
template <typename T, bool CLAMP = true>
__device__ __forceinline__ void gather_tile(const int64_t* rp, const int32_t* ci, const T* src,
                                            int64_t ld, int vec, int64_t row0, int rb, int64_t H,
                                            float* tile, int ts, float* u, int64_t ldu,
                                            int* counter) {
  if constexpr (sizeof(T) == 2) {
    gather_rows_v<T, 8, CLAMP>(rp, ci, src, ld, row0, rb, H, tile, ts, u, ldu, counter);
  } else {
    switch (vec) {
      case 4: gather_rows_v<T, 4, CLAMP>(rp, ci, src, ld, row0, rb, H, tile, ts, u, ldu, counter); break;
      case 2: gather_rows_v<T, 2, CLAMP>(rp, ci, src, ld, row0, rb, H, tile, ts, u, ldu, counter); break;
      default: gather_rows_v<T, 1, CLAMP>(rp, ci, src, ld, row0, rb, H, tile, ts, u, ldu, counter); break;
    }
  }
}

// ---------------------------------------------------------------------------
// The tile GEMM and its epilogues.

// What a tile GEMM's output element v at (row, col) becomes: relu (v < 0 -> 0; NaN passes, as
// maximum(v, 0) lets it), then (v * s) * s with the row's scale, then 0 unless
// mask[row, col] > 0; then it is stored to f32 (fp32 [*, ld32], columns below N) and/or to
// low (T [*, ldl]; the columns of the last group of four from N on are 0, and a padding
// column no group reaches is never summed into a real column by the next gather).
template <typename T>
struct Epilogue {
  bool relu;
  const float* scale;
  const float* mask;
  int64_t ldm;
  float* f32;
  int64_t ld32;
  T* low;
  int64_t ldl;
  int64_t N;

  // The four columns col .. col + 3 (col % 4 == 0) of row `row`.
  __device__ __forceinline__ void operator()(int64_t row, int64_t col, const float (&a)[4]) const {
    float v[4];
    float s = 1.f;
    if (scale != nullptr) s = __ldg(scale + row);
    float m[4] = {1.f, 1.f, 1.f, 1.f};
    if (mask != nullptr && col < ldm) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(mask + row * ldm + col));
      m[0] = t.x; m[1] = t.y; m[2] = t.z; m[3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float t = a[j];
      if (relu && t < 0.f) t = 0.f;
      if (scale != nullptr) t = (t * s) * s;
      if (mask != nullptr) t = m[j] > 0.f ? t : 0.f;
      v[j] = col + j < N ? t : 0.f;
    }
    if (f32 != nullptr) {
      if (col + 4 <= N && ld32 % 4 == 0) {
        *reinterpret_cast<float4*>(f32 + row * ld32 + col) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) f32[row * ld32 + col + j] = v[j];
      }
    }
    // ldl % 4 == 0: the four columns are all inside
    if (low != nullptr && col < ldl) store_low<T, 4>(low + row * ldl + col, v);
  }
};

// The tile's row stride: K rounded up to 4 floats with an odd count of 16-byte chunks.
__host__ __device__ inline int tile_stride(int64_t K) {
  return static_cast<int>(((K + 3) / 4 | 1) * 4);
}

// Floats of shared memory the GEMM's B slices take (two buffers of one slice).
constexpr int kWbufFloats = 2 * kKSlice * kPassCols;

// epi(row, col, v[4]) for the tile [rb, K] (row stride ts) times B [K, N] (row stride ldb,
// ldb % 4 == 0, 16-byte aligned rows; columns N .. ldb are padding).  The output is walked in
// passes of 4 CG columns (CG = 64 or 16 column groups); the thread layout is in the header.
// B comes through shared memory in slices of 2048 / (4 CG) rows of the pass's columns,
// cp.async double-buffered into wbuf (kWbufFloats); each output element is one fmaf per k in
// ascending k from 0.  The first slice's __syncthreads also publishes the gathered tile; on
// return every thread is past the last read of the tile and of wbuf.
template <int CG = 64, class Epi>
__device__ __forceinline__ void tile_gemm(const float* tile, int ts, int rb, int64_t row0,
                                          const float* __restrict__ B, int64_t ldb, int64_t K,
                                          int64_t N, float* wbuf, const Epi& epi) {
  static_assert(CG == 64 || CG == 16, "column groups per pass: 64 or 16");
  constexpr int kPass = 4 * CG;                       // output columns per pass
  constexpr int kGroupsPerWarp = CG / 8;              // column groups a warp covers
  constexpr int kRowGroups = kThreads / CG;           // 4 or 16
  constexpr int kRpt = kRows / kRowGroups;            // rows a thread owns: 4 or 1
  constexpr int kSlice = kKSlice * kPassCols / kPass; // B rows per slice: 8 or 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgp = warp * kGroupsPerWarp + lane % kGroupsPerWarp;  // column group: 4 columns
  const int rg = lane / kGroupsPerWarp;                            // rows rg + kRowGroups i
  const int nsl = static_cast<int>((K + kSlice - 1) / kSlice);
  const float* arow[kRpt];  // a row past rb reads row rb - 1: its sums are never stored
#pragma unroll
  for (int i = 0; i < kRpt; ++i)
    arow[i] = tile + (rg + kRowGroups * i < rb ? rg + kRowGroups * i : rb - 1) * ts;
  for (int64_t j0 = 0; j0 < N; j0 += kPass) {
    const int64_t chunks = (ldb - j0) / 4 < kPass / 4 ? (ldb - j0) / 4 : kPass / 4;
    auto load_slice = [&](int sl, int buf) {
      float* dst = wbuf + buf * (kSlice * kPass);
      for (int q = tid; q < kSlice * kPass / 4; q += kThreads) {
        const int kk = q / (kPass / 4), c4 = q % (kPass / 4);
        const int64_t k = static_cast<int64_t>(sl) * kSlice + kk;
        if (k < K && c4 < chunks)
          cp_async16(dst + kk * kPass + c4 * 4, B + k * ldb + j0 + c4 * 4);
      }
      cp_async_commit();
    };
    float acc[kRpt][4];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
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
      const float* b = wbuf + (sl & 1) * (kSlice * kPass) + cgp * 4;
      const int64_t k0 = static_cast<int64_t>(sl) * kSlice;
      const int kn = K - k0 < kSlice ? static_cast<int>(K - k0) : kSlice;
      int kk = 0;
      for (; kk + 4 <= kn; kk += 4) {
        float4 a[kRpt], bv[4];
#pragma unroll
        for (int i = 0; i < kRpt; ++i) a[i] = *reinterpret_cast<const float4*>(arow[i] + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bv[q] = *reinterpret_cast<const float4*>(b + (kk + q) * kPass);
#pragma unroll
        for (int i = 0; i < kRpt; ++i) {
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
        const float4 bv = *reinterpret_cast<const float4*>(b + kk * kPass);
#pragma unroll
        for (int i = 0; i < kRpt; ++i) {
          const float av = arow[i][k0 + kk];
          acc[i][0] = fmaf(av, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av, bv.w, acc[i][3]);
        }
      }
      __syncthreads();  // the buffer is free for the slice after next
    }
    const int64_t col = j0 + cgp * 4;
    if (col < N) {
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
        if (rg + kRowGroups * i < rb) epi(row0 + rg + kRowGroups * i, col, acc[i]);
    }
  }
}

}  // namespace roc
