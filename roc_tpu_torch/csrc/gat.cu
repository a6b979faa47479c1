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
// one warp (or lane group) owns one output row and walks its edge list in order; each output
// element is written by one thread, so there are no atomics and a run is
// bitwise reproducible.
//
// Forward, one kernel (gat_fwd_rows, its design below): a lane group of 8, 16 or 32 lanes per
// destination row.  Pass 1 takes each head's exact max over the row's edges in one sweep;
// pass 2 forms each edge's exps once and gathers the source rows in packs, unconditional
// loads with 2 edges in flight where a lane owns 2 packs a pass and 4 where it owns 1, one
// weight a pack (a pack lies in one head).  So it is the two-pass softmax, and the result is
// the oracle's two-pass value; a row with no in-edges writes m = 0 (the oracle's isfinite
// guard), z = 0 and out = 0.  A K = 1 row that is not 16-byte aligned is first staged as a
// padded fp32 plane (aggregate_sum.cu's roc_stage_plane; the wrapper decides).
//
// Backward, two kernels, the oracle's per-edge form (edge.py:_gat_plan_bwd):
// the score gradient dq[e, k] = e * (sum_f du[v, kF+f] x[u, kF+f] + dz[v, k])
// * lrelu'(q) is formed once per edge, then summed twice.
//   gat_bwd_src_rows (row 12) walks the transposed CSR, a source row u per
//     lane group of 8, 16 or 32 lanes sized to the row's packs, as the
//     forward's: one gather of du[v] per edge, which gives both dtable (the
//     column sums of e * du) and, against x[u] held in registers, each
//     head's dot; from it dq, summed into dast and written to an [E, K]
//     buffer in transposed edge order (coalesced).  Bound: the du gather,
//     E * H * 4 B (24 GB at Reddit's H = 256).
//   gat_bwd_dst_rows (row 11) sums dq over each destination's in-edges,
//     reading each in-edge's dq row through t_pos (the forward edge's
//     position in the transpose): no gather of x or du.  Bound: dq's bytes
//     and t_pos, once.  A lane loads up to 8 heads of an edge's dq row a
//     pass (its design and passes below).  Writing dq at forward
//     positions instead (a 16-byte scatter per edge at K = 4) and summing
//     it contiguously made the src kernel the slower by far: 14.2 + 0.14
//     ms at Reddit's layer 1 in this design's first form (PERF.md).
// The edge's destination state (dz, ad, m) comes as one packed row of P
// floats (16-byte cp.async, a batch ahead).  The du gather's loads are
// unconditional (a surplus pack re-reads the row's last pack and is
// masked).  VEC divides F, so each pack lies in one head and takes one e.
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
// aggregate_sum.cu.  Splitting hub rows across groups would reassociate the
// sums and is not done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "gather_tile.cuh"

namespace {

constexpr int kMaxWarps = 8;            // warps per block of the backward kernels
constexpr int kSmemBytes = 48 * 1024;   // above this a launch opts in
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
// Forward (rows 9 and 10): out, m, z for one destination row per lane group.
//
// Geometry (chosen by the wrapper, ops/kernels/gat.py:forward_geometry): a group of LPR lanes
// (8, 16 or 32; 32 / LPR rows a warp) owns a row; lane sl of it owns the packs sl + LPR p
// (p < PACKS) of VEC floats of each pass of LPR * PACKS packs over the row's H columns.  VEC
// divides F (or K = 1), so a pack lies in one head and takes one weight.  src is x itself
// ([*, ld], a column slice allowed) or, for K = 1 rows that are not 16-byte aligned, x staged
// once as an fp32 plane [T, ld4(H)] whose padding columns are 0 (roc_stage_plane: no rounding,
// so the function is the same).  Passes are re-walks of the edge list: one at the main path's
// shapes (256 columns as 32 lanes x 2 packs of 4; 41, staged to 44, as 16 lanes x 1 pack of 4:
// in place, 16 x 3 packs of 1 read 2.44 ms and a warp of 2 packs of 1 1.66, against 1.56-1.60
// staged, the staging's 0.04 included; chip_variants.py's gat_fwd_in_place_at_41 and
// gat_fwd_warp_at_41, fast, Reddit, NVIDIA H100 80GB HBM3, 700 W).
//   pass 1, the maxima: lane sl walks the edges beg + sl, beg + sl + LPR, ... once, keeping up
//     to 4 heads' running maxima in registers (as[u] one 16-byte load at K = 4), then a
//     butterfly in the group: one read of col_idx instead of one a head.  A max takes no
//     order, so m is the parent's.
//   pass 2, the weighted gather: batches of LPR edges; lane sl holds the batch's edge sl (its
//     source and, for the first 4 heads, its scores, loaded a batch ahead), forms its exps
//     e[k] = exp(lrelu(ad + as) - m) once into the group's slice of shared memory, then the
//     group walks the batch edge by edge, EDGES edges in flight (4 loads a lane: 2 edges of 2
//     packs, 4 of 1): each lane reads its packs of the edge's source row (unconditional
//     loads: a surplus pack re-reads the row's last pack, and its sums are never stored), one
//     weight a pack from shared memory, and adds e * x (rounded to bf16 in fast) to the
//     pack's sums and e to the pack's z, in CSR order from 0.  Every element of u and z is
//     the parent's serial sum, so out = u / max(z, 1e-15) keeps its bits; the lane whose pack
//     starts a head writes its z.
//   Rows are claimed one at a time from a counter (zeroed by the wrapper) by a grid of
//     resident blocks, so a hub row holds one group, not a block.
// shared memory per group: adv[K] | mv[K] | ebuf[LPR K]; a block holds kFwdThreads / LPR groups,
// fewer where their shared memory would pass a block's 227 KB (K above about 200 at LPR 32).
// Bound: the gather of an fp32 source row per edge (E * H * 4 B, 24 GB at Reddit's layer 1),
// most of it from L2: the fp32 sum at H = 256 (7.0 ms exact, PERF.md) is its floor.
constexpr int kFwdThreads = 256;
// Edges a lane group keeps in flight in the weighted gather where a lane owns one pack a pass
// (kFwdEdgesOne) and where it owns more (kFwdEdgesMany).  chip_variants.py's gat_fwd_* variants
// reverse each, and patch in guarded loads and static rows; in one call (fast, Reddit, NVIDIA
// H100 80GB HBM3, 700 W) layer 1 read 7.92-7.99 ms against 8.10 with 4 edges, 8.57 guarded and
// 9.14 static (80 registers, not 59), layer 2 1.56-1.60 against 1.80 with 2 edges and 1.69
// static (PERF.md §6).
constexpr int kFwdEdgesOne = 4;
constexpr int kFwdEdgesMany = 2;

struct FwdArgs {
  const int64_t* row_ptr;
  const int32_t* col_idx;
  const float* src;  // x, or its staged plane
  int64_t ld;        // src's row stride
  const float* as;
  const float* ad;
  float* out;
  float* m;
  float* z;
  int64_t rows;
  int K, F;
  float slope;
  int as4;       // K % 4 == 0 and as 16-byte aligned: 4 heads' scores in one load
  int* claimed;  // rows claimed so far: 0 at the launch
};

__host__ __device__ constexpr int64_t fwd_floats_per_group(int K, int lpr) {
  return (2 + static_cast<int64_t>(lpr)) * K;
}

template <int LPR>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (LPR == 32) {
    return kFull;
  } else {
    return ((1u << LPR) - 1u) << (lane / LPR * LPR);
  }
}

// Scores of heads k0 .. k0 + 3 of source u (those below K; the others 0).
__device__ __forceinline__ void load_scores(const float* __restrict__ as, int64_t u, int K, int k0,
                                            bool as4, float (&s)[4]) {
  if (as4) {
    const float4 t = *reinterpret_cast<const float4*>(as + u * K + k0);
    s[0] = t.x; s[1] = t.y; s[2] = t.z; s[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = k0 + j < K ? as[u * K + k0 + j] : 0.f;
  }
}

template <int VEC, int PACKS, int LPR, bool ROUND,
          int EDGES = (PACKS > 1 ? kFwdEdgesMany : kFwdEdgesOne)>
__device__ __forceinline__ void fwd_row(const FwdArgs& p, int64_t row, int sl, unsigned gm,
                                        float* adv, float* mv, float* ebuf) {
  const int K = p.K, F = p.F;
  const int64_t H = static_cast<int64_t>(K) * F;
  const int64_t beg = p.row_ptr[row], end = p.row_ptr[row + 1];
  for (int k = sl; k < K; k += LPR) adv[k] = p.ad[row * K + k];
  __syncwarp(gm);

  // pass 1: one sweep of the row's edges for each 4 heads
  for (int k0 = 0; k0 < K; k0 += 4) {
    const bool as4 = p.as4 != 0;
    float a[4], mx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = k0 + j < K ? adv[k0 + j] : 0.f;
      mx[j] = -INFINITY;
    }
#pragma unroll 4
    for (int64_t e = beg + sl; e < end; e += LPR) {
      float s[4];
      load_scores(p.as, p.col_idx[e], K, k0, as4, s);
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[j] = fmaxf(mx[j], lrelu(a[j] + s[j], p.slope));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(gm, mx[j], off));
      if (sl == 0 && k0 + j < K) mv[k0 + j] = end > beg ? mx[j] : 0.f;
    }
  }
  __syncwarp(gm);
  for (int k = sl; k < K; k += LPR) p.m[row * K + k] = mv[k];

  // pass 2: z and the weighted sum, then the normalised output
  const int64_t last = (H + VEC - 1) / VEC * VEC - VEC;  // the row's last pack
  for (int64_t c0 = 0; c0 < H; c0 += static_cast<int64_t>(LPR) * VEC * PACKS) {
    float u[PACKS][VEC], z[PACKS];
    int64_t off[PACKS];
    int kc[PACKS];
#pragma unroll
    for (int q = 0; q < PACKS; ++q) {
      const int64_t c = c0 + static_cast<int64_t>(q * LPR + sl) * VEC;
      off[q] = c > last ? last : c;
      kc[q] = static_cast<int>(off[q] / F);
      z[q] = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) u[q][j] = 0.f;
    }
    // the first batch's sources and scores; each batch loads the next one's before its walk
    int src = 0;
    float sa[4] = {0.f, 0.f, 0.f, 0.f};
    if (beg + sl < end) {
      src = p.col_idx[beg + sl];
      load_scores(p.as, src, K, 0, p.as4 != 0, sa);
    }
    for (int64_t b = beg; b < end; b += LPR) {
      const int n = end - b < LPR ? static_cast<int>(end - b) : LPR;
      __syncwarp(gm);  // the previous batch's readers are done with ebuf
      if (sl < n) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < K) ebuf[sl * K + k] = expf(lrelu(adv[k] + sa[k], p.slope) - mv[k]);
        for (int k = 4; k < K; ++k)
          ebuf[sl * K + k] =
              expf(lrelu(adv[k] + p.as[static_cast<int64_t>(src) * K + k], p.slope) - mv[k]);
      }
      __syncwarp(gm);
      const int cur = src;
      if (b + LPR + sl < end) {
        src = p.col_idx[b + LPR + sl];
        load_scores(p.as, src, K, 0, p.as4 != 0, sa);
      }
#pragma unroll EDGES
      for (int i = 0; i < n; ++i) {
        const int64_t uu = __shfl_sync(gm, cur, i, LPR);
        const float* xr = p.src + uu * p.ld;
        const float* eb = ebuf + i * K;
#pragma unroll
        for (int q = 0; q < PACKS; ++q) {
          const Pack<VEC> xv = load_pack<VEC>(xr + off[q]);
          const float e = eb[kc[q]];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float t = e * xv.v[j];
            if (ROUND) t = round_bf16(t);
            u[q][j] += t;
          }
          z[q] += e;
        }
      }
    }
    float* orow = p.out + row * H;
#pragma unroll
    for (int q = 0; q < PACKS; ++q) {
      const int64_t c = c0 + static_cast<int64_t>(q * LPR + sl) * VEC;
      if (c < H) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = u[q][j] / fmaxf(z[q], 1e-15f);
        roc::store_row<VEC>(orow, c, H, o);
        if (c % F == 0) p.z[row * K + c / F] = z[q];
      }
    }
  }
}

template <int VEC, int PACKS, int LPR, bool ROUND>
__global__ void __launch_bounds__(kFwdThreads) gat_fwd_rows(const FwdArgs p) {
  extern __shared__ float4 smem4[];
  constexpr int kGroups = 32 / LPR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sl = lane % LPR;
  const int group = warp * kGroups + lane / LPR;  // the block's group
  const unsigned gm = group_mask<LPR>(lane);
  float* adv = reinterpret_cast<float*>(smem4) + group * fwd_floats_per_group(p.K, LPR);
  float* mv = adv + p.K;
  float* ebuf = mv + p.K;
  for (;;) {
    int row = 0;
    if (sl == 0) row = atomicAdd(p.claimed, 1);
    row = __shfl_sync(gm, row, 0, LPR);
    if (row >= p.rows) return;
    fwd_row<VEC, PACKS, LPR, ROUND>(p, row, sl, gm, adv, mv, ebuf);
    __syncwarp(gm);  // the row's readers of the group's shared memory are done
  }
}

// A kernel whose lane groups of lpr lanes claim rows from a counter, each group with fpg floats
// of shared memory: threads a block, halved (down to one warp) while the groups' shared memory
// passes 227 KB, on a grid of the resident blocks, at most one a row's group.
template <typename Kernel, typename... Args>
int launch_claimed(Kernel kernel, int threads, int lpr, int64_t fpg, int64_t rows, cudaStream_t s,
                   Args... args) {
  constexpr int64_t kMaxSmem = 227 * 1024;
  auto smem_of = [&](int t) { return t / lpr * fpg * 4; };
  while (threads > 32 && smem_of(threads) > kMaxSmem) threads /= 2;
  const int64_t smem = smem_of(threads);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t groups_per_block = threads / lpr;
  int64_t blocks = (rows + groups_per_block - 1) / groups_per_block;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    static_cast<size_t>(smem)) != cudaSuccess ||
      per_sm < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  blocks = blocks < resident ? blocks : resident;
  kernel<<<dim3(static_cast<unsigned>(blocks)), threads, static_cast<size_t>(smem), s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int PACKS, int LPR, bool ROUND>
int launch_fwd(const FwdArgs& p, cudaStream_t s) {
  return launch_claimed(gat_fwd_rows<VEC, PACKS, LPR, ROUND>, kFwdThreads, LPR,
                        fwd_floats_per_group(p.K, LPR), p.rows, s, p);
}

// (lanes, packs) pairs: forward_geometry's FWD_GROUPS at every vec, and at 4-float packs (the
// main path's: F = 64, and 41 columns staged to 44) three more the autotuner may choose
// (ops/kernels/gat.py:FWD_PAIRS, roc_tpu_torch/tune/lattice.py).  The lane count changes no
// bit: pass 1's maxima take no order, and each lane sums its packs over the row's edges in
// CSR order from 0.  Any other pair returns cudaErrorInvalidValue.
template <int VEC, bool ROUND>
int launch_fwd_group(const FwdArgs& p, int lanes, int packs, cudaStream_t s) {
  if (lanes == 8 && packs == 1) return launch_fwd<VEC, 1, 8, ROUND>(p, s);
  if (lanes == 16 && packs == 1) return launch_fwd<VEC, 1, 16, ROUND>(p, s);
  if (lanes == 16 && packs == 3) return launch_fwd<VEC, 3, 16, ROUND>(p, s);
  if (lanes == 32 && packs == 2) return launch_fwd<VEC, 2, 32, ROUND>(p, s);
  if constexpr (VEC == 4) {
    if (lanes == 8 && packs == 2) return launch_fwd<VEC, 2, 8, ROUND>(p, s);
    if (lanes == 16 && packs == 4) return launch_fwd<VEC, 4, 16, ROUND>(p, s);
    if (lanes == 32 && packs == 1) return launch_fwd<VEC, 1, 32, ROUND>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Backward over the transposed CSR (row 12): dtable, dast and the per-edge score gradient dq
// for one source row u per lane group.  Its edges e' (u -> v) come in transposed order, and dq
// [E, K] is written in that order.
//
// Geometry (chosen by the wrapper, ops/kernels/gat.py:src_geometry, by the forward's rule over
// the row's packs from SRC_GROUPS): a group of LPR lanes (8, 16 or 32; 32 / LPR rows a warp)
// owns a row; lane sl of it owns the packs sl + LPR q (q < PACKS) of VEC floats of each tile of
// LPR * PACKS packs, so a tile's pack slots are all used but at the row's ragged end.  At
// Reddit's layer 1 (H = 64) that is 16 lanes x 1 pack of 4; a warp over a 256-column tile, the
// earlier geometry, used 16 of its 64 pack slots there and still loaded and multiplied the
// other 48.  Rows are claimed one at a time from a counter (zeroed by the wrapper) by a grid of
// resident blocks, as in the forward, so a long row holds one group, not a block.
//
// The group walks u's edges in batches of LPR.  Lane sl takes the batch's edge sl: the
// destination's packed state row (dz | ad | m, P floats, 16-byte aligned) reaches its slice of
// st by 16-byte cp.async, issued during the previous batch's gather (and the index a batch
// before that), and the lane forms e for the heads of the tile into ebuf.  Then the group walks
// the batch edge by edge, 8 edges in flight: each lane gathers its PACKS packs of du[v]
// (unconditional loads: a surplus pack re-reads the row's last pack and is masked), adds the
// rounded e * du into dtable's column sums, and writes the pack's dot with x[u] (held in
// registers) to pbuf, a [kDot edges, LPR * PACKS packs] transpose: the whole batch where a lane
// owns one pack, halves of it where it owns more (src_dot_edges).  After each kDot edges, the
// lane of each sums its edge's slots per head (slots in column order, one head a contiguous
// run, since F % VEC == 0), forms dq and adds it into dast's partial sum of the edge's slot,
// its position in the row modulo 32 (dsacc; the 32 partials are added in slot order at the
// end).  Where a lane owns one pack and the row is one tile of K > 1 heads, dq takes e's place
// in ebuf and the group writes the batch's dq rows, contiguous, once the batch is summed
// (whole, below); otherwise each lane writes its edge's dq a head at a time, and a head that
// spans two tiles keeps its partial dot in dq between them (the same lane reads it back, the
// batches being the same in every tile).  So each output takes the same additions in the same
// order at every geometry, and a launch at (32, 2) gives the rule's pair's bits.
//   shared memory per group: st[2][LPR P] | pbuf[kDot (LPR PACKS + 1)] | ebuf[LPR K] |
//   dsacc[32 K] | asv[K]: 5.6 KB at K = 8 in (16, 1), 8.3 KB at K = 4 and 5.5 KB at K = 1 in
//   (32, 2).  At K = 8 it allows 2 blocks of 8 warps an SM, so 32 rows in flight.
// The readings behind each choice (rows claimed, 8 edges in flight, dq rows written whole, the
// whole batch dotted at once at one pack a lane) are chip_variants.py's gat_* variants (PERF.md
// §6).
__host__ __device__ constexpr int src_dot_edges(int lpr, int packs) {
  return lpr * packs > 16 ? lpr / 2 : lpr;
}

// Resident blocks an SM the src kernel asks for: 2 (128 registers a thread) with 4-float packs,
// 4 (64) with narrower ones.  With 4-float packs (16, 1) takes 108 registers and (32, 2) 128,
// no spills; with 1-float packs (32, 2) takes 64, no spills, and the narrow groups, which no
// main-path shape takes, spill 24-44 bytes.  3 blocks with 4-float packs (80 registers) and 3
// with narrower ones read no faster at Reddit's three shapes.
__host__ __device__ constexpr int src_min_blocks(int vec) { return vec == 4 ? 2 : 4; }

__host__ __device__ constexpr int64_t src_floats_per_group(int K, int P, int lpr, int packs) {
  return (2 * static_cast<int64_t>(lpr) * P +
          static_cast<int64_t>(src_dot_edges(lpr, packs)) * (lpr * packs + 1) +
          static_cast<int64_t>(lpr + 32) * K + K + 3) /
         4 * 4;
}

// A lane's edge's destination state row (P floats) into shared memory by cp.async, one commit
// group (empty for a lane past the row's end).  The group copying the batch's rows together, a
// copy's lanes on adjacent chunks, read 5 % faster at K = 8 and slower at K = 4 and K = 1
// (spills at 1-float packs; PERF.md §6).
__device__ __forceinline__ void stage_state(const float* state, int dst, float* to, int P,
                                            bool valid) {
  if (valid) {
    const float* from = state + static_cast<int64_t>(dst) * P;
    for (int q = 0; q < P; q += 4) roc::cp_async16(to + q, from + q);
  }
  roc::cp_async_commit();
}

template <int VEC, int PACKS, int LPR, bool ROUND>
__global__ void __launch_bounds__(kMaxWarps * 32, src_min_blocks(VEC))
    gat_bwd_src_rows(const int64_t* __restrict__ t_row_ptr, const int32_t* __restrict__ t_col_idx,
                     const float* __restrict__ x, const float* __restrict__ as,
                     const float* __restrict__ state, const float* __restrict__ du,
                     float* __restrict__ dtable, float* __restrict__ dast, float* dq,
                     int64_t rows, int K, int F, int P, float slope, int* __restrict__ claimed) {
  extern __shared__ float4 smem4[];
  constexpr int kTile = LPR * PACKS * VEC, kSlots = LPR * PACKS + 1;
  constexpr int kDot = src_dot_edges(LPR, PACKS);
  const int lane = threadIdx.x & 31, sl = lane % LPR, group = threadIdx.x / LPR;
  const unsigned gm = group_mask<LPR>(lane);
  float* st = reinterpret_cast<float*>(smem4) + group * src_floats_per_group(K, P, LPR, PACKS);
  float* pbuf = st + 2 * LPR * P;
  float* ebuf = pbuf + kDot * kSlots;
  float* dsacc = ebuf + LPR * K;
  float* asv = dsacc + 32 * K;
  const int64_t H = static_cast<int64_t>(K) * F;
  // one pack a lane and one tile of more than one head: a batch's dq rows are written whole,
  // from ebuf.  At (32, 2) it read no faster at K = 4, and its code alone cost 15 % at K = 1,
  // where the lanes' own stores are adjacent already (PERF.md §6)
  const bool whole = PACKS == 1 && H <= kTile && K > 1;
  for (;;) {
    int claim = 0;
    if (sl == 0) claim = atomicAdd(claimed, 1);
    const int64_t row = __shfl_sync(gm, claim, 0, LPR);
    if (row >= rows) return;
    const int64_t beg = t_row_ptr[row], end = t_row_ptr[row + 1];

    for (int k = sl; k < K; k += LPR) asv[k] = as[row * K + k];
    for (int i = sl; i < 32 * K; i += LPR) dsacc[i] = 0.f;
    __syncwarp(gm);
    for (int64_t t0 = 0; t0 < H; t0 += kTile) {
      float acc[PACKS][VEC], xr[PACKS][VEC];
      int64_t cl[PACKS];
      int kc[PACKS];
      bool ok[PACKS];
#pragma unroll
      for (int q = 0; q < PACKS; ++q) {
        const int64_t c = t0 + static_cast<int64_t>(q * LPR + sl) * VEC;
        ok[q] = c < H;
        cl[q] = ok[q] ? c : H - VEC;
        kc[q] = static_cast<int>(cl[q] / F);
        const Pack<VEC> xv = load_pack<VEC>(x + row * H + cl[q]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[q][j] = 0.f;
          xr[q][j] = ok[q] ? xv.v[j] : 0.f;
        }
      }
      // the heads whose columns meet this tile
      const int k0 = static_cast<int>(t0 / F);
      const int64_t t1 = t0 + kTile < H ? t0 + kTile : H;
      const int k1 = static_cast<int>((t1 - 1) / F);
      const int tw = static_cast<int>(t1 - t0);  // the tile's columns
      // the first batch's indices and state rows; each batch stages the next one's during its
      // gather (st holds two batches' rows)
      int dst = beg + sl < end ? t_col_idx[beg + sl] : 0;
      stage_state(state, dst, st + sl * P, P, beg + sl < end);
      int buf = 0;
      for (int64_t b = beg; b < end; b += LPR, buf ^= 1) {
        const int n = end - b < LPR ? static_cast<int>(end - b) : LPR;
        const int64_t te = b + sl;  // this lane's transposed edge, and its dq row
        const int slot = static_cast<int>((te - beg) & 31);  // its partial sum of dast
        const bool more = b + LPR < end;
        const int next = te + LPR < end ? t_col_idx[te + LPR] : 0;
        float* mine = st + (buf * LPR + sl) * P;  // this lane's edge: dz | ad | m
        roc::cp_async_wait<0>();
        __syncwarp(gm);  // the batch's rows have landed; the previous batch's readers are done
        if (sl < n) {
          for (int k = k0; k <= k1; ++k)
            ebuf[sl * K + k] = expf(lrelu(mine[K + k] + asv[k], slope) - mine[2 * K + k]);
        }
        __syncwarp(gm);
        for (int i0 = 0; i0 < n; i0 += kDot) {
          const int m = n - i0 < kDot ? n - i0 : kDot;
#pragma unroll 8
          for (int ii = 0; ii < m; ++ii) {
            const int i = i0 + ii;
            const int64_t vv = __shfl_sync(gm, dst, i, LPR);
            float* prow = pbuf + ii * kSlots + sl;
#pragma unroll
            for (int q = 0; q < PACKS; ++q) {
              const Pack<VEC> gv = load_pack<VEC>(du + vv * H + cl[q]);
              const float e = ebuf[i * K + kc[q]];
              float s = 0.f;
#pragma unroll
              for (int j = 0; j < VEC; ++j) {
                float t = e * gv.v[j];
                if (ROUND) t = round_bf16(t);
                acc[q][j] += t;
                s += gv.v[j] * xr[q][j];
              }
              if (ok[q]) prow[q * LPR] = s;
            }
          }
          if (i0 == 0 && more)
            stage_state(state, next, st + ((buf ^ 1) * LPR + sl) * P, P, te + LPR < end);
          __syncwarp(gm);
          if (sl >= i0 && sl < i0 + m) {
            const float* slots = pbuf + (sl - i0) * kSlots;
            // head k's columns from the tile's first: [c, c + F), c <= 0 at k0
            int c = static_cast<int>(static_cast<int64_t>(k0) * F - t0);
            for (int k = k0; k <= k1; ++k, c += F) {
              float d = c >= 0 ? 0.f : dq[te * K + k];
              const int s1 = (c + F < tw ? c + F : tw) / VEC;
              for (int s = (c > 0 ? c : 0) / VEC; s < s1; ++s) d += slots[s];
              if (c + F <= tw) {  // the head's last tile: its dot is whole
                const float q = mine[K + k] + asv[k];
                const float g = ebuf[sl * K + k] * (d + mine[k]) * (q >= 0.f ? 1.f : slope);
                if (whole)
                  ebuf[sl * K + k] = g;  // its e is read no more: the batch's gathers are done
                else
                  dq[te * K + k] = g;
                dsacc[slot * K + k] += g;
              } else {
                dq[te * K + k] = d;
              }
            }
          }
          __syncwarp(gm);  // pbuf's readers are done before the next kDot edges write it
        }
        if (whole)  // the batch's dq rows, contiguous, as ebuf holds them
          for (int j = sl; j < n * K; j += LPR) dq[b * K + j] = ebuf[j];
        dst = next;
      }
#pragma unroll
      for (int q = 0; q < PACKS; ++q) {
        if (ok[q]) {
          Pack<VEC> o;
#pragma unroll
          for (int j = 0; j < VEC; ++j) o.v[j] = acc[q][j];
          store_pack<VEC>(dtable + row * H + cl[q], o);
        }
      }
    }
    __syncwarp(gm);
    for (int k = sl; k < K; k += LPR) {
      float s = 0.f;
      for (int l = 0; l < 32; ++l) s += dsacc[l * K + k];
      dast[row * K + k] = s;
    }
    __syncwarp(gm);  // the row's readers of st, pbuf, ebuf, dsacc and asv are done
  }
}

template <int VEC, int PACKS, int LPR, bool ROUND>
int launch_src(const int64_t* rp, const int32_t* ci, const float* xp, const float* asp,
               const float* stp, const float* dup, float* tp, float* sp, float* qp,
               int64_t rows, int K, int F, int P, float slope, int* claimed, cudaStream_t s) {
  return launch_claimed(gat_bwd_src_rows<VEC, PACKS, LPR, ROUND>, kMaxWarps * 32, LPR,
                        src_floats_per_group(K, P, LPR, PACKS), rows, s, rp, ci, xp, asp, stp,
                        dup, tp, sp, qp, rows, K, F, P, slope, claimed);
}

// (lanes, packs) pairs: ops/kernels/gat.py's SRC_GROUPS, the wrapper's rule taking the first
// whose lanes * packs cover the row's packs.  Any other pair returns cudaErrorInvalidValue.
template <int VEC, bool ROUND>
int launch_src_group(int lanes, int packs, const int64_t* rp, const int32_t* ci, const float* xp,
                     const float* asp, const float* stp, const float* dup, float* tp, float* sp,
                     float* qp, int64_t rows, int K, int F, int P, float slope, int* claimed,
                     cudaStream_t s) {
#define ROC_GAT_SRC(PK, L)                                                                       \
  if (lanes == L && packs == PK)                                                                 \
  return launch_src<VEC, PK, L, ROUND>(rp, ci, xp, asp, stp, dup, tp, sp, qp, rows, K, F, P,     \
                                       slope, claimed, s)
  ROC_GAT_SRC(1, 8);
  ROC_GAT_SRC(1, 16);
  ROC_GAT_SRC(2, 32);
#undef ROC_GAT_SRC
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Backward over the forward CSR (row 11): dadl[v, k] = sum of dq[t_pos[e], k] over v's in-edges
// e, one destination row per warp.  dq is [E, K] in transposed edge order, so a row's in-edges
// read scattered dq rows: the kernel is bound by loading each in-edge's row once.
//
// sum_heads sums the heads [c, c + G) in one pass over the row's edges: lane l takes the edges
// l, l + 32, ... of the row, reads the edge's position in the transpose (a coalesced load) and
// the G floats of that dq row, W floats a load (W divides K and c, so the loads are aligned:
// the wrapper checks that dq starts 16-byte aligned), adds them into G accumulators in edge
// order, then reduces each head across the warp by the same xor tree; lane j writes head c + j.
// Each head's sum takes the same additions in the same order whatever G is, so every pass plan
// gives the same bits as summing one head at a time.
//
// The passes: K in {1, 2, 4} one, in the instantiation KV = K; KV = 0 takes every other K, an
// even K in groups of 8 heads, then 4, then 2 (W = 4 where 4 divides K, else 2), an odd K a
// head a pass.  ops/kernels/gat.py:dst_head_groups lists the groups for the counters; the card
// test that holds every plan bitwise against one-head launches covers each branch.  A pass a
// head reads each row's sector once a head, and dq (753 MB at K = 8 on Reddit's shape) does
// not stay in the 50 MB L2: 5.17 ms there at K = 8 against one pass's 0.76 (PERF.md §6 row 11).
template <int G, int W>
__device__ __forceinline__ void sum_heads(const int32_t* __restrict__ t_pos,
                                          const float* __restrict__ dq, float* __restrict__ dadl,
                                          int64_t row, int64_t beg, int64_t end, int lane, int K,
                                          int c) {
  static_assert(G % W == 0 && (W == 4 || W == 2 || W == 1), "a pass loads whole packs");
  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int64_t e = beg + lane; e < end; e += 32) {
    const float* r = dq + static_cast<int64_t>(t_pos[e]) * K + c;
#pragma unroll
    for (int j = 0; j < G; j += W) {
      if constexpr (W == 4) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(r + j));
        acc[j] += v.x; acc[j + 1] += v.y; acc[j + 2] += v.z; acc[j + 3] += v.w;
      } else if constexpr (W == 2) {
        const float2 v = __ldcs(reinterpret_cast<const float2*>(r + j));
        acc[j] += v.x; acc[j + 1] += v.y;
      } else {
        acc[j] += __ldcs(r + j);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
  }
  if (lane < G) {
    float s = acc[0];
#pragma unroll
    for (int j = 1; j < G; ++j)
      if (lane == j) s = acc[j];
    dadl[row * K + c + lane] = s;
  }
}

// An even K's passes: groups of 8 heads, then 4, then 2, W floats a load.
template <int W>
__device__ __forceinline__ void sum_head_groups(const int32_t* __restrict__ t_pos,
                                                const float* __restrict__ dq,
                                                float* __restrict__ dadl, int64_t row,
                                                int64_t beg, int64_t end, int lane, int K) {
  int c = 0;
  for (; K - c >= 8; c += 8) sum_heads<8, W>(t_pos, dq, dadl, row, beg, end, lane, K, c);
  if (K - c >= 4) {
    sum_heads<4, W>(t_pos, dq, dadl, row, beg, end, lane, K, c);
    c += 4;
  }
  if (K - c >= 2) sum_heads<2, 2>(t_pos, dq, dadl, row, beg, end, lane, K, c);
}

template <int KV>
__global__ void gat_bwd_dst_rows(const int64_t* __restrict__ row_ptr,
                                 const int32_t* __restrict__ t_pos, const float* __restrict__ dq,
                                 float* __restrict__ dadl, int64_t rows, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wpb = blockDim.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * wpb + warp;
  if (row >= rows) return;
  const int64_t beg = row_ptr[row], end = row_ptr[row + 1];
  if constexpr (KV > 0) {
    sum_heads<KV, (KV < 4 ? KV : 4)>(t_pos, dq, dadl, row, beg, end, lane, KV, 0);
  } else if (K % 4 == 0) {
    sum_head_groups<4>(t_pos, dq, dadl, row, beg, end, lane, K);
  } else if (K % 2 == 0) {
    sum_head_groups<2>(t_pos, dq, dadl, row, beg, end, lane, K);
  } else {
    for (int k = 0; k < K; ++k) sum_heads<1, 1>(t_pos, dq, dadl, row, beg, end, lane, K, k);
  }
}

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

// src is x [*, ld] (a column slice allowed) or its staged plane; vec divides F (or K = 1) and
// ld, src is aligned to it, and the row's packs end within ld; (lanes, packs) is one of
// launch_fwd_group's pairs; claimed is one int32, 0 at the launch, so rows < 2^30 (the claims
// past the last row, one a lane group, stay below 2^31).  An unsigned row is slower at Reddit's
// layer 2 in fast (chip_variants.py's gat_fwd_unsigned_rows; PERF.md §6).
extern "C" int roc_gat_forward(const void* row_ptr, const void* col_idx, const void* src,
                               long long ld, const void* as, const void* ad, void* out, void* m,
                               void* z, long long rows, int K, int F, float slope, int round_bf16,
                               int vec, int lanes, int packs, void* claimed, void* stream) {
  const int64_t H = static_cast<int64_t>(K) * F;
  if (bad_shape(rows, K, F) || rows >= (1ll << 30) || (vec != 4 && vec != 2 && vec != 1) ||
      (K != 1 && F % vec != 0) || ld % vec != 0 || (H + vec - 1) / vec * vec > ld)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs p;
  p.row_ptr = static_cast<const int64_t*>(row_ptr);
  p.col_idx = static_cast<const int32_t*>(col_idx);
  p.src = static_cast<const float*>(src);
  p.ld = ld;
  p.as = static_cast<const float*>(as);
  p.ad = static_cast<const float*>(ad);
  p.out = static_cast<float*>(out);
  p.m = static_cast<float*>(m);
  p.z = static_cast<float*>(z);
  p.rows = rows;
  p.K = K;
  p.F = F;
  p.slope = slope;
  p.as4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(as) % 16 == 0;
  p.claimed = static_cast<int*>(claimed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec * 2 + (round_bf16 ? 1 : 0)) {
    case 9: return launch_fwd_group<4, true>(p, lanes, packs, s);
    case 8: return launch_fwd_group<4, false>(p, lanes, packs, s);
    case 5: return launch_fwd_group<2, true>(p, lanes, packs, s);
    case 4: return launch_fwd_group<2, false>(p, lanes, packs, s);
    case 3: return launch_fwd_group<1, true>(p, lanes, packs, s);
    case 2: return launch_fwd_group<1, false>(p, lanes, packs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int roc_gat_bwd_dst(const void* row_ptr, const void* t_pos, const void* dq, void* dadl,
                               long long rows, int K, void* stream) {
  if (bad_shape(rows, K, 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* rp = static_cast<const int64_t*>(row_ptr);
  const int32_t* tp = static_cast<const int32_t*>(t_pos);
  const float* dp = static_cast<const float*>(dq);
  float* op = static_cast<float*>(dadl);
  const dim3 grid(static_cast<unsigned>((rows + kMaxWarps - 1) / kMaxWarps));
  const int threads = kMaxWarps * 32;
  switch (K) {
    case 4: gat_bwd_dst_rows<4><<<grid, threads, 0, s>>>(rp, tp, dp, op, rows, K); break;
    case 2: gat_bwd_dst_rows<2><<<grid, threads, 0, s>>>(rp, tp, dp, op, rows, K); break;
    case 1: gat_bwd_dst_rows<1><<<grid, threads, 0, s>>>(rp, tp, dp, op, rows, K); break;
    default: gat_bwd_dst_rows<0><<<grid, threads, 0, s>>>(rp, tp, dp, op, rows, K); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// state is [N, P] (dz | ad | m | zeros), P = 3K rounded up to 4, 16-byte aligned; dq is
// [E, K] in transposed edge order; vec divides F; (lanes, packs) is one of launch_src_group's
// pairs; claimed is one int32, 0 at the launch, so rows < 2^30.
extern "C" int roc_gat_bwd_src(const void* t_row_ptr, const void* t_col_idx, const void* x,
                               const void* as, const void* state, const void* du, void* dtable,
                               void* dast, void* dq, long long rows, int K, int F, int P,
                               float slope, int round_bf16, int vec, int lanes, int packs,
                               void* claimed, void* stream) {
  if (bad_shape(rows, K, F) || rows >= (1ll << 30) || P % 4 != 0 || P < 3 * K || F % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* rp = static_cast<const int64_t*>(t_row_ptr);
  const int32_t* ci = static_cast<const int32_t*>(t_col_idx);
  const float *xp = static_cast<const float*>(x), *asp = static_cast<const float*>(as),
              *stp = static_cast<const float*>(state), *dup = static_cast<const float*>(du);
  float *tp = static_cast<float*>(dtable), *sp = static_cast<float*>(dast),
        *qp = static_cast<float*>(dq);
#define ROC_GAT_SRC(V, R)                                                                        \
  return launch_src_group<V, R>(lanes, packs, rp, ci, xp, asp, stp, dup, tp, sp, qp, rows, K, F, \
                                P, slope, static_cast<int*>(claimed), s)
  switch (vec * 2 + (round_bf16 ? 1 : 0)) {
    case 9: ROC_GAT_SRC(4, true);
    case 8: ROC_GAT_SRC(4, false);
    case 5: ROC_GAT_SRC(2, true);
    case 4: ROC_GAT_SRC(2, false);
    case 3: ROC_GAT_SRC(1, true);
    case 2: ROC_GAT_SRC(1, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROC_GAT_SRC
}
