// GAT attention for Hopper (sm_90a): per-head edge score -> edge softmax ->
// weighted aggregate over the in-edge CSR, and its backward.
//
// Replaces the four Pallas TPU kernels of roc_tpu/ops/pallas/gat.py:
//   _gat_max_kernel (gat.py:328) and _gat_sum_kernel (gat.py:428)  -> gat_fwd_rows
//   _gat_bwd_dst_kernel (gat.py:536)                                -> gat_bwd_dst_rows
//   _gat_bwd_src_kernel (gat.py:632)                                -> gat_bwd_src_rows
// and the source score the Pallas kernels compute in their own bodies
// (_chunk_score, gat.py:310) -> gat_score_rows, run once per node (its own design below).
//
// Function (roc_tpu/ops/edge.py:gat_attend_plan).  Features are x [T, H],
// H = K * F (K heads of F features, head k in columns [k*F, (k+1)*F)).
//   as[t, k] = sum_f x[t, kF + f] * a_src[k, f]                    (gat_score)
//   q = ad[v, k] + as[u, k],  s = lrelu(q),  m[v, k] = max over v's in-edges of s
//   e = exp(s - m[v, k]),  z[v, k] = sum e,  out[v, c] = sum e * x[u, c] / max(z, 1e-15)
// Backward, with du = g / zc and dz = -sum_f g * out / zc computed by the
// caller, and lrelu'(q) = (q >= 0 ? 1 : slope):
//   dadl[v, k]   = sum over v's in-edges of e * lrelu'(q) * (sum_f du[v, kF+f] * x[u, kF+f] + dz[v, k])
//   dtable[u, c] = sum over u's out-edges (u -> v) of e * du[v, c]
//   dast[u, k]   = sum over u's out-edges of e * lrelu'(q) * (sum_f du[v, kF+f] * x[u, kF+f] + dz[v, k])
//
// None of the TPU schedule carries over (the binned plan, the 128-lane alpha
// planes, the A/M/MT iota matrices, staging DMAs, head-group splitting, VMEM
// admission).  Every kernel is a deterministic segment reduction over a CSR:
// one warp owns one output row and walks its edge list in order; each output
// row is written exactly once, so there are no atomics and a run is bitwise
// reproducible.
//
// Layout of a warp's work.  Edges are taken in batches of 32: lane l loads
// the batch's l-th index (one coalesced load) and computes that edge's
// per-head quantities (K scores, exps, slopes) into the warp's slice of
// shared memory.  Then the warp walks the batch edge by edge: the row
// gathered for an edge is read as packs of VEC floats per lane, kNP packs per
// lane, neighbouring lanes on neighbouring addresses; each column takes its
// head's value from shared memory (a broadcast read).  A row wider than
// 32 * VEC * kNP columns is covered in tiles, re-walking the edge list once
// per tile.  The ragged tail of H is masked per pack (the wrapper picks VEC
// so that H % VEC == 0) and heads may straddle packs (F need not divide VEC).
//
// The forward is the two-pass softmax: pass 1 takes the exact per-head max
// over the row's edges before pass 2 forms exp(s - m), so there is no online
// rescaling and the result is the oracle's two-pass value.  A row with no
// in-edges writes m = 0 (the oracle's isfinite guard), z = 0 and out = 0.
//
// The backward's per-head contractions are reassociated: instead of a
// per-edge dot over the head's F columns (a segmented warp reduction per
// edge), each column accumulates sum_e c_e * x[u, c] (or c_e * du[v, c]) over
// the edges, with c_e = e * lrelu'(q), and one per-head reduction over the
// columns closes the row: dadl[v, k] = sum_f du[v, kF+f] * W[kF+f] +
// dz[v, k] * sum_e c_e.  The same sums in another order (fp32).
//
// Precision.  ROUND = true is "fast": the product e * x (forward) and
// e * du (dtable) takes one bf16 rounding (round to nearest even) before its
// fp32 add, as the Pallas kernels' single-pass bf16 one-hot dot does.
// ROUND = false is "exact", fp32 throughout.  Scores, maxima, normalizers
// and the score gradients are fp32 in both.  expf (not __expf), and no fast
// math, so the exponentials are torch.exp's.
//
// Bound.  Forward: reading x (T * H * 4 B), the CSR, as, ad once and writing
// out, m, z once, against E * H multiply-adds.  Each edge gathers a full
// source row (E * H * 4 B, 24 GB at the Reddit shape for H = 256), so the
// time depends on how often a hot row is found in the 50 MB L2, as for
// aggregate_sum.cu.  Prefetching the next edge's row and splitting hub rows
// across warps are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kMaxWarps = 8;            // warps per block, fewer when K is large
constexpr int kNP = 2;                  // column packs per lane per tile
constexpr int kSmemBytes = 48 * 1024;   // static limit, no opt-in attribute
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lrelu(float q, float slope) { return q >= 0.f ? q : q * slope; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int VEC>
struct alignas(4 * VEC) Pack {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Pack<VEC> load_pack(const float* p) {
  return *reinterpret_cast<const Pack<VEC>*>(p);
}

template <int VEC>
__device__ __forceinline__ void store_pack(float* p, const Pack<VEC>& v) {
  *reinterpret_cast<Pack<VEC>*>(p) = v;
}

// Columns of (tile t0, pack p, lane): c0 = t0 + p * 32 * VEC + lane * VEC.
template <int VEC>
__device__ __forceinline__ int64_t pack_col(int64_t t0, int p, int lane) {
  return t0 + static_cast<int64_t>(p) * 32 * VEC + static_cast<int64_t>(lane) * VEC;
}

// Per-head sum of the tile's column values pbuf[0, width) into hacc[k] (each
// head summed by one lane, columns in order), then a warp barrier.
__device__ __forceinline__ void head_reduce(const float* pbuf, float* hacc, int64_t t0, int64_t width,
                                            int K, int F, int lane) {
  __syncwarp();
  for (int k = lane; k < K; k += 32) {
    const int64_t h0 = static_cast<int64_t>(k) * F, h1 = h0 + F;
    const int64_t lo = h0 > t0 ? h0 : t0;
    const int64_t hi = h1 < t0 + width ? h1 : t0 + width;
    float acc = hacc[k];
    for (int64_t c = lo; c < hi; ++c) acc += pbuf[c - t0];
    hacc[k] = acc;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// as[t, k] = sum_f x[t, kF + f] * a[kF + f]  (gat_score)
//
// x is [T, H] contiguous, so a block's R consecutive rows are one contiguous span.  A block
// of kScoreThreads threads copies a (into sa) and its rows (into sx) to shared memory, then
// each thread forms the dot product of one (row, head) pair of the block's R * K pairs: pair
// p is row p % R and head p / R, so the lanes of a warp take consecutive rows of one head.
// The dot runs in f order from 0 and rounds each product before its add (__fmul_rn and
// __fadd_rn, which nvcc does not contract into an FMA): the order and rounding of the plain
// serial reference and of the warp-per-row kernel this one replaced, so as keeps its bits.
//   padded (H % 4 == 0 and x 16-byte aligned): row r is copied with 16-byte cp.async to
//     sx + r * ts, ts = H rounded up to an odd number of 16-byte chunks, so a quarter warp's
//     float4 reads of 8 consecutive rows fall in 8 distinct bank groups; VEC4 (F % 4 == 0)
//     reads the dot's operands as float4.
//   otherwise: the span is copied as it lies, from its 16-byte-aligned start with cp.async
//     when x is 16-byte aligned (row 0 then sits at sx + off, off < 4), else by 4-byte loads;
//     rows are H apart, which for odd H puts a warp's 32 rows on 32 distinct banks.
// shared memory: sa [H rounded up to 4] | sx
// Bound: x once (T * H * 4 B) against T * H multiply-adds: bytes bind.
constexpr int kScoreThreads = 256;

template <bool VEC4>
__global__ void __launch_bounds__(kScoreThreads)
gat_score_rows(const float* __restrict__ x, const float* __restrict__ a, float* __restrict__ as,
               int64_t rows, int K, int F, int R, int ts, int padded, int aligned) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int64_t H = static_cast<int64_t>(K) * F;
  float* sa = reinterpret_cast<float*>(smem4);
  float* sx = sa + (H + 3) / 4 * 4;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int nr = rows - row0 < R ? static_cast<int>(rows - row0) : R;
  for (int64_t i = tid; i < H; i += kScoreThreads) sa[i] = a[i];
  int64_t off = 0;
  if (padded) {
    const int64_t cpr = H / 4;  // 16-byte chunks per row
    for (int64_t q = tid; q < nr * cpr; q += kScoreThreads) {
      const int64_t r = q / cpr, c = q - r * cpr;
      roc::cp_async16(sx + r * ts + 4 * c, x + (row0 + r) * H + 4 * c);
    }
  } else if (aligned) {
    const int64_t s0 = row0 * H, s1 = (row0 + nr) * H, total = rows * H;
    const int64_t a0 = s0 / 4 * 4;
    off = s0 - a0;
    for (int64_t q = tid; q < (s1 - a0 + 3) / 4; q += kScoreThreads) {
      const int64_t g0 = a0 + 4 * q;
      if (g0 + 4 <= total) {
        roc::cp_async16(sx + 4 * q, x + g0);
      } else {  // the array's ragged end: no 16-byte read past it
        for (int j = 0; j < 4; ++j)
          if (g0 + j < total) sx[4 * q + j] = x[g0 + j];
      }
    }
  } else {
    for (int64_t i = tid; i < nr * H; i += kScoreThreads) sx[i] = x[row0 * H + i];
  }
  roc::cp_async_commit();
  roc::cp_async_wait<0>();
  __syncthreads();
  const int64_t stride = padded ? ts : H;
  for (int p = tid; p < nr * K; p += kScoreThreads) {
    const int r = p % nr, k = p / nr;
    const float* xr = sx + off + r * stride + static_cast<int64_t>(k) * F;
    const float* ar = sa + static_cast<int64_t>(k) * F;
    float acc = 0.f;
    if (VEC4) {
      for (int f = 0; f < F; f += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + f);
        const float4 av = *reinterpret_cast<const float4*>(ar + f);
        acc = __fadd_rn(acc, __fmul_rn(xv.x, av.x));
        acc = __fadd_rn(acc, __fmul_rn(xv.y, av.y));
        acc = __fadd_rn(acc, __fmul_rn(xv.z, av.z));
        acc = __fadd_rn(acc, __fmul_rn(xv.w, av.w));
      }
    } else {
      for (int f = 0; f < F; ++f) acc = __fadd_rn(acc, __fmul_rn(xr[f], ar[f]));
    }
    as[(row0 + r) * K + k] = acc;
  }
}

// ---------------------------------------------------------------------------
// Forward (rows 9 and 10): out, m, z for one destination row per warp.
// shared memory per warp: adv[K] | mv[K] | ebuf[32 K]
template <int VEC, bool ROUND>
__global__ void gat_fwd_rows(const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
                             const float* __restrict__ x, const float* __restrict__ as,
                             const float* __restrict__ ad, float* __restrict__ out,
                             float* __restrict__ m_out, float* __restrict__ z_out, int64_t rows, int K,
                             int F, float slope) {
  extern __shared__ float smem[];
  constexpr int kTile = 32 * VEC * kNP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wpb = blockDim.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * wpb + warp;
  if (row >= rows) return;
  float* adv = smem + static_cast<int64_t>(warp) * (34 * K);
  float* mv = adv + K;
  float* ebuf = mv + K;
  const int64_t H = static_cast<int64_t>(K) * F;
  const int64_t beg = row_ptr[row], end = row_ptr[row + 1];

  for (int k = lane; k < K; k += 32) adv[k] = ad[row * K + k];
  __syncwarp();
  // pass 1: the per-head max of the row's scores
  for (int k = 0; k < K; ++k) {
    const float adk = adv[k];
    float mx = -INFINITY;
    for (int64_t e = beg + lane; e < end; e += 32) {
      const int64_t u = col_idx[e];
      mx = fmaxf(mx, lrelu(adk + as[u * K + k], slope));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    if (lane == 0) mv[k] = end > beg ? mx : 0.f;
  }
  __syncwarp();
  for (int k = lane; k < K; k += 32) m_out[row * K + k] = mv[k];

  // pass 2: z and the weighted sum, then the normalised output
  for (int64_t t0 = 0; t0 < H; t0 += kTile) {
    float u[kNP][VEC], z[kNP][VEC];
    int kc[kNP][VEC];
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const int64_t c = pack_col<VEC>(t0, p, lane);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        u[p][j] = 0.f;
        z[p][j] = 0.f;
        kc[p][j] = c + j < H ? static_cast<int>((c + j) / F) : 0;
      }
    }
    for (int64_t b = beg; b < end; b += 32) {
      const int n = end - b < 32 ? static_cast<int>(end - b) : 32;
      int src = 0;
      __syncwarp();  // the previous batch's readers are done with ebuf
      if (lane < n) {
        src = col_idx[b + lane];
        const int64_t s64 = src;
        for (int k = 0; k < K; ++k)
          ebuf[lane * K + k] = expf(lrelu(adv[k] + as[s64 * K + k], slope) - mv[k]);
      }
      __syncwarp();
#pragma unroll 2
      for (int i = 0; i < n; ++i) {
        const int64_t uu = __shfl_sync(kFull, src, i);
        const float* eb = ebuf + i * K;
#pragma unroll
        for (int p = 0; p < kNP; ++p) {
          const int64_t c = pack_col<VEC>(t0, p, lane);
          if (c < H) {
            const Pack<VEC> xv = load_pack<VEC>(x + uu * H + c);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float e = eb[kc[p][j]];
              float t = e * xv.v[j];
              if (ROUND) t = round_bf16(t);
              z[p][j] += e;
              u[p][j] += t;
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const int64_t c = pack_col<VEC>(t0, p, lane);
      if (c < H) {
        Pack<VEC> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          o.v[j] = u[p][j] / fmaxf(z[p][j], 1e-15f);
          if ((c + j) % F == 0) z_out[row * K + kc[p][j]] = z[p][j];
        }
        store_pack<VEC>(out + row * H + c, o);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward over the forward CSR (row 11): dadl for one destination row.
// shared memory per warp: adv[K] | mv[K] | hacc[K] | csum[K] | cbuf[32 K] | pbuf[kTile]
template <int VEC>
__global__ void gat_bwd_dst_rows(const int64_t* __restrict__ row_ptr,
                                 const int32_t* __restrict__ col_idx, const float* __restrict__ x,
                                 const float* __restrict__ as, const float* __restrict__ ad,
                                 const float* __restrict__ m, const float* __restrict__ du,
                                 const float* __restrict__ dz, float* __restrict__ dadl,
                                 int64_t rows, int K, int F, float slope) {
  extern __shared__ float smem[];
  constexpr int kTile = 32 * VEC * kNP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wpb = blockDim.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * wpb + warp;
  if (row >= rows) return;
  float* adv = smem + static_cast<int64_t>(warp) * (36 * K + kTile);
  float* mv = adv + K;
  float* hacc = mv + K;
  float* csum = hacc + K;
  float* cbuf = csum + K;
  float* pbuf = cbuf + 32 * K;
  const int64_t H = static_cast<int64_t>(K) * F;
  const int64_t beg = row_ptr[row], end = row_ptr[row + 1];

  for (int k = lane; k < K; k += 32) {
    adv[k] = ad[row * K + k];
    mv[k] = m[row * K + k];
    hacc[k] = 0.f;
  }
  for (int64_t t0 = 0; t0 < H; t0 += kTile) {
    float w[kNP][VEC], cs[kNP][VEC], dur[kNP][VEC];
    int kc[kNP][VEC];
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const int64_t c = pack_col<VEC>(t0, p, lane);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        w[p][j] = 0.f;
        cs[p][j] = 0.f;
        dur[p][j] = c + j < H ? du[row * H + c + j] : 0.f;
        kc[p][j] = c + j < H ? static_cast<int>((c + j) / F) : 0;
      }
    }
    for (int64_t b = beg; b < end; b += 32) {
      const int n = end - b < 32 ? static_cast<int>(end - b) : 32;
      int src = 0;
      __syncwarp();
      if (lane < n) {
        src = col_idx[b + lane];
        const int64_t s64 = src;
        for (int k = 0; k < K; ++k) {
          const float q = adv[k] + as[s64 * K + k];
          const float e = expf(lrelu(q, slope) - mv[k]);
          cbuf[lane * K + k] = q >= 0.f ? e : e * slope;
        }
      }
      __syncwarp();
#pragma unroll 2
      for (int i = 0; i < n; ++i) {
        const int64_t uu = __shfl_sync(kFull, src, i);
        const float* cb = cbuf + i * K;
#pragma unroll
        for (int p = 0; p < kNP; ++p) {
          const int64_t c = pack_col<VEC>(t0, p, lane);
          if (c < H) {
            const Pack<VEC> xv = load_pack<VEC>(x + uu * H + c);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float cc = cb[kc[p][j]];
              w[p][j] += cc * xv.v[j];
              cs[p][j] += cc;
            }
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const int64_t c = pack_col<VEC>(t0, p, lane);
      if (c < H) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          pbuf[c - t0 + j] = dur[p][j] * w[p][j];
          if ((c + j) % F == 0) csum[kc[p][j]] = cs[p][j];
        }
      }
    }
    head_reduce(pbuf, hacc, t0, kTile, K, F, lane);
  }
  for (int k = lane; k < K; k += 32) dadl[row * K + k] = hacc[k] + dz[row * K + k] * csum[k];
}

// ---------------------------------------------------------------------------
// Backward over the transposed CSR (row 12): dtable and dast for one source
// row.  shared memory per warp:
//   asv[K] | hacc[K] | dsum[K] | ebuf[32 K] | cbuf[32 K] | cdbuf[32 K] | pbuf[kTile]
template <int VEC, bool ROUND>
__global__ void gat_bwd_src_rows(const int64_t* __restrict__ t_row_ptr,
                                 const int32_t* __restrict__ t_col_idx, const float* __restrict__ x,
                                 const float* __restrict__ as, const float* __restrict__ ad,
                                 const float* __restrict__ m, const float* __restrict__ du,
                                 const float* __restrict__ dz, float* __restrict__ dtable,
                                 float* __restrict__ dast, int64_t rows, int K, int F, float slope) {
  extern __shared__ float smem[];
  constexpr int kTile = 32 * VEC * kNP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wpb = blockDim.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * wpb + warp;
  if (row >= rows) return;
  float* asv = smem + static_cast<int64_t>(warp) * (99 * K + kTile);
  float* hacc = asv + K;
  float* dsum = hacc + K;
  float* ebuf = dsum + K;
  float* cbuf = ebuf + 32 * K;
  float* cdbuf = cbuf + 32 * K;
  float* pbuf = cdbuf + 32 * K;
  const int64_t H = static_cast<int64_t>(K) * F;
  const int64_t beg = t_row_ptr[row], end = t_row_ptr[row + 1];

  for (int k = lane; k < K; k += 32) {
    asv[k] = as[row * K + k];
    hacc[k] = 0.f;
  }
  for (int64_t t0 = 0; t0 < H; t0 += kTile) {
    float acc[kNP][VEC], w[kNP][VEC], d[kNP][VEC], xr[kNP][VEC];
    int kc[kNP][VEC];
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const int64_t c = pack_col<VEC>(t0, p, lane);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        acc[p][j] = 0.f;
        w[p][j] = 0.f;
        d[p][j] = 0.f;
        xr[p][j] = c + j < H ? x[row * H + c + j] : 0.f;
        kc[p][j] = c + j < H ? static_cast<int>((c + j) / F) : 0;
      }
    }
    for (int64_t b = beg; b < end; b += 32) {
      const int n = end - b < 32 ? static_cast<int>(end - b) : 32;
      int dst = 0;
      __syncwarp();
      if (lane < n) {
        dst = t_col_idx[b + lane];
        const int64_t d64 = dst;
        for (int k = 0; k < K; ++k) {
          const float q = ad[d64 * K + k] + asv[k];
          const float e = expf(lrelu(q, slope) - m[d64 * K + k]);
          const float cc = q >= 0.f ? e : e * slope;
          ebuf[lane * K + k] = e;
          cbuf[lane * K + k] = cc;
          cdbuf[lane * K + k] = cc * dz[d64 * K + k];
        }
      }
      __syncwarp();
#pragma unroll 2
      for (int i = 0; i < n; ++i) {
        const int64_t vv = __shfl_sync(kFull, dst, i);
        const float* eb = ebuf + i * K;
        const float* cb = cbuf + i * K;
        const float* cdb = cdbuf + i * K;
#pragma unroll
        for (int p = 0; p < kNP; ++p) {
          const int64_t c = pack_col<VEC>(t0, p, lane);
          if (c < H) {
            const Pack<VEC> gv = load_pack<VEC>(du + vv * H + c);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const int kk = kc[p][j];
              float t = eb[kk] * gv.v[j];
              if (ROUND) t = round_bf16(t);
              acc[p][j] += t;
              w[p][j] += cb[kk] * gv.v[j];
              d[p][j] += cdb[kk];
            }
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const int64_t c = pack_col<VEC>(t0, p, lane);
      if (c < H) {
        Pack<VEC> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          o.v[j] = acc[p][j];
          pbuf[c - t0 + j] = xr[p][j] * w[p][j];
          if ((c + j) % F == 0) dsum[kc[p][j]] = d[p][j];
        }
        store_pack<VEC>(dtable + row * H + c, o);
      }
    }
    head_reduce(pbuf, hacc, t0, kTile, K, F, lane);
  }
  for (int k = lane; k < K; k += 32) dast[row * K + k] = hacc[k] + dsum[k];
}

// Warps per block so that the block's shared memory fits the static limit;
// 0 when not even one warp's slice fits.
int warps_for(int64_t floats_per_warp) {
  const int64_t bytes = floats_per_warp * static_cast<int64_t>(sizeof(float));
  const int64_t w = bytes > 0 ? kSmemBytes / bytes : kMaxWarps;
  return static_cast<int>(w < kMaxWarps ? w : kMaxWarps);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int64_t rows, int64_t floats_per_warp, cudaStream_t stream, Args... args) {
  const int wpb = warps_for(floats_per_warp);
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((rows + wpb - 1) / wpb));
  const size_t smem = static_cast<size_t>(wpb) * floats_per_warp * sizeof(float);
  kernel<<<grid, wpb * 32, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

constexpr int tile_of(int vec) { return 32 * vec * kNP; }

bool bad_shape(long long rows, int K, int F) { return rows <= 0 || K <= 0 || F <= 0; }

}  // namespace

// C interface, bound with ctypes by roc_tpu_torch/ops/kernels/gat.py.  Every
// tensor is float32 and contiguous; row_ptr is int64, col_idx int32.  vec is
// 4, 2 or 1 (H % vec == 0 and the packed tensors aligned to vec floats);
// round_bf16 = 1 is "fast".  Each returns cudaGetLastError() after its launch
// (0 on success).

extern "C" int roc_gat_score(const void* x, const void* a, void* as, long long rows, int K, int F,
                             int x_aligned16, void* stream) {
  if (bad_shape(rows, K, F)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t H = static_cast<int64_t>(K) * F;
  const bool padded = H % 4 == 0 && x_aligned16;
  const int64_t ts = padded ? (H / 4 | 1) * 4 : H;
  // R rows a block: enough (row, head) pairs for every thread, fewer while the block's
  // shared memory (a, the rows and off's slack) exceeds what one block may use
  constexpr int64_t kMaxSmem = 227 * 1024;
  int64_t R = K >= kScoreThreads ? 1 : kScoreThreads / K;
  auto smem_of = [&](int64_t r) { return ((H + 3) / 4 * 4 + r * ts + 4) * 4; };
  while (R > 1 && smem_of(R) > kMaxSmem) R /= 2;
  const int64_t smem = smem_of(R);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = padded && F % 4 == 0 ? gat_score_rows<true> : gat_score_rows<false>;
  if (smem > kSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((rows + R - 1) / R));
  const size_t bytes = static_cast<size_t>(smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kScoreThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<float*>(as),
      static_cast<int64_t>(rows), K, F, static_cast<int>(R), static_cast<int>(ts), padded ? 1 : 0,
      x_aligned16 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int roc_gat_forward(const void* row_ptr, const void* col_idx, const void* x,
                               const void* as, const void* ad, void* out, void* m, void* z,
                               long long rows, int K, int F, float slope, int round_bf16, int vec,
                               void* stream) {
  if (bad_shape(rows, K, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* rp = static_cast<const int64_t*>(row_ptr);
  const int32_t* ci = static_cast<const int32_t*>(col_idx);
  const float *xp = static_cast<const float*>(x), *asp = static_cast<const float*>(as),
              *adp = static_cast<const float*>(ad);
  float *op = static_cast<float*>(out), *mp = static_cast<float*>(m), *zp = static_cast<float*>(z);
  const int64_t fpw = 34 * static_cast<int64_t>(K);
#define ROC_GAT_FWD(V, R) \
  launch(gat_fwd_rows<V, R>, rows, fpw, s, rp, ci, xp, asp, adp, op, mp, zp, (int64_t)rows, K, F, slope)
  switch (vec * 2 + (round_bf16 ? 1 : 0)) {
    case 9: return ROC_GAT_FWD(4, true);
    case 8: return ROC_GAT_FWD(4, false);
    case 5: return ROC_GAT_FWD(2, true);
    case 4: return ROC_GAT_FWD(2, false);
    case 3: return ROC_GAT_FWD(1, true);
    case 2: return ROC_GAT_FWD(1, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROC_GAT_FWD
}

extern "C" int roc_gat_bwd_dst(const void* row_ptr, const void* col_idx, const void* x,
                               const void* as, const void* ad, const void* m, const void* du,
                               const void* dz, void* dadl, long long rows, int K, int F, float slope,
                               int vec, void* stream) {
  if (bad_shape(rows, K, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* rp = static_cast<const int64_t*>(row_ptr);
  const int32_t* ci = static_cast<const int32_t*>(col_idx);
  const float *xp = static_cast<const float*>(x), *asp = static_cast<const float*>(as),
              *adp = static_cast<const float*>(ad), *mp = static_cast<const float*>(m),
              *dup = static_cast<const float*>(du), *dzp = static_cast<const float*>(dz);
  float* op = static_cast<float*>(dadl);
#define ROC_GAT_DST(V)                                                                         \
  launch(gat_bwd_dst_rows<V>, rows, 36 * static_cast<int64_t>(K) + tile_of(V), s, rp, ci, xp, \
         asp, adp, mp, dup, dzp, op, (int64_t)rows, K, F, slope)
  switch (vec) {
    case 4: return ROC_GAT_DST(4);
    case 2: return ROC_GAT_DST(2);
    case 1: return ROC_GAT_DST(1);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROC_GAT_DST
}

extern "C" int roc_gat_bwd_src(const void* t_row_ptr, const void* t_col_idx, const void* x,
                               const void* as, const void* ad, const void* m, const void* du,
                               const void* dz, void* dtable, void* dast, long long rows, int K,
                               int F, float slope, int round_bf16, int vec, void* stream) {
  if (bad_shape(rows, K, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* rp = static_cast<const int64_t*>(t_row_ptr);
  const int32_t* ci = static_cast<const int32_t*>(t_col_idx);
  const float *xp = static_cast<const float*>(x), *asp = static_cast<const float*>(as),
              *adp = static_cast<const float*>(ad), *mp = static_cast<const float*>(m),
              *dup = static_cast<const float*>(du), *dzp = static_cast<const float*>(dz);
  float *tp = static_cast<float*>(dtable), *sp = static_cast<float*>(dast);
#define ROC_GAT_SRC(V, R)                                                                         \
  launch(gat_bwd_src_rows<V, R>, rows, 99 * static_cast<int64_t>(K) + tile_of(V), s, rp, ci, xp, \
         asp, adp, mp, dup, dzp, tp, sp, (int64_t)rows, K, F, slope)
  switch (vec * 2 + (round_bf16 ? 1 : 0)) {
    case 9: return ROC_GAT_SRC(4, true);
    case 8: return ROC_GAT_SRC(4, false);
    case 5: return ROC_GAT_SRC(2, true);
    case 4: return ROC_GAT_SRC(2, false);
    case 3: return ROC_GAT_SRC(1, true);
    case 2: return ROC_GAT_SRC(1, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROC_GAT_SRC
}
