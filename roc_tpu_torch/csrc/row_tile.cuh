// Row-tile device code of the whole-layer megakernel forward (aggregate_linear.cu): the CSR
// gather of up to 16 destination rows into an fp32 shared-memory tile, and the fp32 FMA GEMM
// of that tile with a row-major weight; and the launch constants and prepare() that the
// cross-layer region kernels (xlayer.cu) share.  xlayer.cu has its own gather and
// shared-memory GEMM, with the same arithmetic (the same addends summed in CSR order from 0,
// one fmaf per k in ascending k from 0), so a region layer gives the same bits as the
// per-layer megakernel on the same input.
//
// Gather (gather_rows).  A block of 256 threads owns RB <= 16 consecutive rows of the CSR it
// walks.  Each warp takes rows r = warp, warp + 8, ...; it walks the row's edges in CSR
// order and loads the source row with VEC-element vector loads (VEC in {4, 2, 1}, the
// widest that divides the width), kPacks packs per lane per pass over the edges, and sums
// in fp32 registers starting from 0.  What is summed per element is the source policy's
// staged value (Rows::load), rounded once to bf16 (round to nearest even) when ROUND
// ("fast"), as is (fp32, "exact") otherwise.  The row's sums go to the tile [RB, H] (row
// stride rounded up to 4 floats) and, when gout is given, once to gout.
//
// GEMM (tile_gemm).  After __syncthreads, thread t owns output column j = t mod CT of a pass
// over the output columns (CT = the power of two >= the output width, 32..256) and rows
// t / CT + i * (256 / CT); it reads the tile through shared-memory broadcasts (float4 along
// k) and the weight [K, N] row-major through the read-only path, and sums k in order in
// fp32 FMA registers.  No tensor cores: the contract is fp32 at Precision.HIGHEST, which
// TF32 and bf16 would break.  The epilogue is relu (v < 0 -> 0, NaN passes, as maximum(v, 0)
// lets it), then, when a scale vector is given, (v * s[row]) * s[row]: the GCN norm pair
// between two layers, in the order the per-layer chain applies it.
//
// Each output row is written exactly once: no atomics, the same bits on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;              // RB: destination rows per block, at most
constexpr int kPacks = 2;                 // column packs per lane per pass over the edges
constexpr int kStaticSmem = 48 * 1024;    // above this a launch must opt in

template <int VEC>
struct alignas(4 * VEC) Pack {
  float v[VEC];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The megakernel forward's source rows: src[u, c .. c + VEC).  Read-only for the launch.
struct SourceRows {
  const float* __restrict__ src;

  template <int VEC>
  __device__ __forceinline__ Pack<VEC> load(int64_t u, int64_t c, int64_t H) const {
    return *reinterpret_cast<const Pack<VEC>*>(src + u * H + c);
  }
};

// tile[r, :] = sum over the edges of CSR row row0 + r of rows.load(u, :) (each element
// rounded once to bf16 when ROUND), for r < rb and rows below num_rows.  When gout is given
// the row also goes to gout[row0 + r, :].
template <int VEC, bool ROUND, class Rows>
__device__ __forceinline__ void gather_rows(const int64_t* __restrict__ row_ptr,
                                            const int32_t* __restrict__ col_idx, const Rows& rows,
                                            int64_t row0, int rb, int64_t num_rows, int64_t H,
                                            float* tile, int stride, float* __restrict__ gout) {
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
#pragma unroll
        for (int p = 0; p < kPacks; ++p) {
          const int64_t c = c0 + static_cast<int64_t>(p * 32 + lane) * VEC;
          if (c < H) {  // H % VEC == 0: a pack is wholly inside or outside
            const Pack<VEC> s = rows.template load<VEC>(u, c, H);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              float v = s.v[j];
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

// out[row0 + r, j] = epilogue(sum_k tile[r, k] * B[k, j]) for r < rb, rows below num_rows
// and j < N; B is [K, N] row-major.  RPT = 16 / (256 / CT) rows per thread.
template <int RPT>
__device__ __forceinline__ void tile_gemm_rows(const float* tile, int stride, int rb, int64_t row0,
                                               int64_t num_rows, const float* __restrict__ B,
                                               int64_t K, int64_t N, float* __restrict__ out,
                                               bool relu, const float* __restrict__ scale,
                                               int ct) {
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
        if (scale != nullptr) {
          const float s = scale[row0 + r];
          v = (v * s) * s;
        }
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
                                          float* out, bool relu, const float* scale) {
  const int ct = column_threads(N);
  switch (kThreads / ct) {
    case 1:
      tile_gemm_rows<kMaxRows>(tile, stride, rb, row0, num_rows, B, K, N, out, relu, scale, ct);
      break;
    case 2:
      tile_gemm_rows<kMaxRows / 2>(tile, stride, rb, row0, num_rows, B, K, N, out, relu, scale,
                                   ct);
      break;
    case 4:
      tile_gemm_rows<kMaxRows / 4>(tile, stride, rb, row0, num_rows, B, K, N, out, relu, scale,
                                   ct);
      break;
    default:
      tile_gemm_rows<kMaxRows / 8>(tile, stride, rb, row0, num_rows, B, K, N, out, relu, scale,
                                   ct);
      break;
  }
}

// Rows per block and the tile's row stride for a gather width H: 16 rows while the tile
// fits the 48 KB a launch gets without opting in, fewer (down to 1) for wide rows.
__host__ __device__ inline void tile_shape(int64_t H, int* rb, int* stride) {
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

}  // namespace roc
