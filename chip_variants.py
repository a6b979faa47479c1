#!/usr/bin/env python3
"""Time design variants of the hand-written kernels against the checkout's
own sources on one NVIDIA GPU, in one call.

    python3 chip_variants.py [sum] [linear] [xlayer] [gat] [gat_fwd]
                             [dropout]              # default: all

Each variant is the checkout's roc_tpu_torch/csrc/ with one design choice
reversed by a source edit (VARIANTS below: each names the choice, the
library it rebuilds and its edits, which may fall in a shared header, and
may name the cases it is timed on when the checkout's wrapper cannot
reach the reversed path),
built with the same nvcc flags into chip_check/variants/ (gitignored), all
builds started together.  On the Reddit graph, for each variant in turn (the
checkout's build first and last), the variant's library takes the place of
the checkout's and is timed at the main path's shapes:

  sum     aggregate_sum (ops/kernels/aggregate_sum.py, staging included in
          fast) at H = 41 over the CSR and its transpose, H = 256 and 602
          over the CSR, both precisions at 256
  linear  aggregate_linear at 602->256 relu and 256->41 in fast, 602->256
          relu in exact (in fast the checkout's staging launch is included),
          and aggregate_linear_bwd's u alone at 602 <- 256 relu, fast
  xlayer  the region kernels at the full-width path's region (depth 3,
          602-256-256-256, relu, the norm pair), both precisions: xlayer_fwd
          and xlayer_bwd without dx, and the phase split
  gat     the GAT backward at the published GAT's two layers (K=8, F=8
          and K=1, F=41) and the full-width GAT's first (K=4, F=64):
          gat_bwd_src in fast and exact (dtable, dast, dq), gat_bwd_dst on
          its dq, in fast
  gat_fwd the GAT forward (gat_forward: out, m, z) at the same two layers,
          fast and exact (a staging launch included where the geometry
          stages x)
  dropout the dropout kernel's forward at H = 602 and 256, fp32 and bf16,
          rate 0.5; each record also holds the SASS of its grid-stride
          loop (cuobjdump -sass): instructions an element in all, on the
          INT32 pipe and as integer IMADs on the FMA pipe

Each time is the median of 10 CUDA-event timed calls on chip_smoke.py's
Gaussian inputs; each record holds the compiler's registers and spill
bytes of the target's kernels and whether every output equals the
checkout's bitwise (a variant that changes only the schedule keeps them;
a region's dW may differ in its last bits where the schedule of its sums
changes).  One JSON line per variant, then the card's name and power limit
as nvidia-smi gives them.  Exits non-zero without CUDA or when a build
fails.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "roc_tpu_torch" / "csrc"
OUT = ROOT / "chip_check" / "variants"
SOURCES = {"sum": "aggregate_sum.cu", "linear": "aggregate_linear.cu",
           "xlayer": "xlayer.cu", "gat": "gat.cu", "gat_fwd": "gat.cu",
           "dropout": "dropout.cu"}

# The tile counter of the megakernel forward, as the region kernels claim
# their tiles: a grid of resident blocks (the occupancy's count on every SM)
# takes tiles from one device-global counter, zeroed before each launch (one
# counter for the library: the variant is timed on one stream).
_TILE_COUNTER = [
    ("aggregate_linear.cu", "constexpr int kMinBlocks = 3;\n",
     "constexpr int kMinBlocks = 3;\n__device__ int g_tiles;\n"),
    ("aggregate_linear.cu",
     "  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;\n"
     "  const int rb = p.n - row0 < kRows ? static_cast<int>(p.n - row0) "
     ": kRows;\n"
     "  gather_tile<T>(p.row_ptr, p.col_idx, static_cast<const T*>(p.src), "
     "p.ld, p.vec, row0, rb,\n"
     "                 p.k, tile, ts, nullptr, 0, nullptr);\n"
     "  tile_gemm<CG>(tile, ts, rb, row0, p.w, p.ldw, p.k, p.m, wbuf, epi);\n",
     "  __shared__ int claim;\n"
     "  const int64_t tiles = (p.n + kRows - 1) / kRows;\n"
     "  for (;;) {\n"
     "    if (threadIdx.x == 0) claim = atomicAdd(&g_tiles, 1);\n"
     "    __syncthreads();\n"
     "    const int64_t t = claim;\n"
     "    if (t >= tiles) break;\n"
     "    const int64_t row0 = t * kRows;\n"
     "    const int rb = p.n - row0 < kRows ? static_cast<int>(p.n - row0) "
     ": kRows;\n"
     "    gather_tile<T>(p.row_ptr, p.col_idx, static_cast<const T*>(p.src), "
     "p.ld, p.vec, row0, rb,\n"
     "                   p.k, tile, ts, nullptr, 0, nullptr);\n"
     "    tile_gemm<CG>(tile, ts, rb, row0, p.w, p.ldw, p.k, p.m, wbuf, epi);"
     "\n"
     "    __syncthreads();\n"
     "  }\n"),
    ("aggregate_linear.cu",
     "  const dim3 grid(static_cast<unsigned>((p.n + kRows - 1) / kRows));\n"
     "  mega_fwd<T, CG><<<grid, kThreads, smem, s>>>(p);\n",
     "  int dev = 0, sms = 0, per_sm = 0;\n"
     "  void* tiles = nullptr;\n"
     "  if (cudaGetDevice(&dev) != cudaSuccess ||\n"
     "      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) "
     "!= cudaSuccess ||\n"
     "      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, "
     "mega_fwd<T, CG>, kThreads, smem) !=\n"
     "          cudaSuccess ||\n"
     "      per_sm < 1 || cudaGetSymbolAddress(&tiles, g_tiles) != "
     "cudaSuccess ||\n"
     "      cudaMemsetAsync(tiles, 0, sizeof(int), s) != cudaSuccess)\n"
     "    return static_cast<int>(cudaErrorInvalidConfiguration);\n"
     "  const int64_t n_tiles = (p.n + kRows - 1) / kRows;\n"
     "  const dim3 grid(static_cast<unsigned>(\n"
     "      static_cast<int64_t>(per_sm) * sms < n_tiles ? "
     "static_cast<int64_t>(per_sm) * sms : n_tiles));\n"
     "  mega_fwd<T, CG><<<grid, kThreads, smem, s>>>(p);\n"),
]

# The fp32 gather rounding each element to bf16 as it loads it ("fast"
# without staging; every fp32 gather of the variant's library rounds).
_ROUND_PER_EDGE = [
    ("gather_tile.cuh", load, load + "\n" + " " * indent +
     "if constexpr (sizeof(T) == 4) for (int j = 0; j < VEC; ++j) "
     "v[j] = __bfloat162float(to_bf16(v[j]));")
    for load, indent in (
        ("          load_pack<T, VEC>(s + off[p], v);", 10),
        ("            load_pack<T, VEC>(s + p * LPR * VEC, v);", 12))]


# The GAT forward's gather with guarded loads: a surplus pack (past the row's
# last) is skipped instead of re-reading the last pack.
_FWD_GUARDED = [
    ("gat.cu", "      off[q] = c > last ? last : c;\n",
     "      off[q] = c;\n"),
    ("gat.cu", "          const Pack<VEC> xv = load_pack<VEC>(xr + off[q]);\n",
     "          if (off[q] >= H) continue;\n"
     "          const Pack<VEC> xv = load_pack<VEC>(xr + off[q]);\n")]

# The GAT forward's rows in a static order: lane group g of block b takes row
# b * groups + g, one block for every groups rows, instead of claiming rows
# from the counter over the resident blocks.
_FWD_STATIC = [
    ("gat.cu",
     "  for (;;) {\n"
     "    int row = 0;\n"
     "    if (sl == 0) row = atomicAdd(p.claimed, 1);\n"
     "    row = __shfl_sync(gm, row, 0, LPR);\n"
     "    if (row >= p.rows) return;\n"
     "    fwd_row<VEC, PACKS, LPR, ROUND>(p, row, sl, gm, adv, mv, ebuf);\n"
     "    __syncwarp(gm);  // the row's readers of the group's shared memory "
     "are done\n"
     "  }\n",
     "  const int64_t row = static_cast<int64_t>(blockIdx.x) * "
     "(blockDim.x / LPR) + group;\n"
     "  if (row >= p.rows) return;\n"
     "  fwd_row<VEC, PACKS, LPR, ROUND>(p, row, sl, gm, adv, mv, ebuf);\n"),
    ("gat.cu", "  blocks = blocks < resident ? blocks : resident;\n",
     "  (void)resident;\n")]


# name -> (the design choice it reverses, target, [(file, old, new)]
#          [, the function giving its cases in place of the target's])
VARIANTS = {
    "sum_unstaged_at_41": (
        "fast stages x (a launch, then one-pass bf16 packs) instead of "
        "gathering x in place and rounding each element per edge, at H = 41",
        "sum", _ROUND_PER_EDGE, "_sum_per_edge_cases"),
    "sum_four_edges": (
        "2 edges in flight a lane group instead of 4",
        "sum", [("gather_tile.cuh", "constexpr int kRowEdges = 2;",
                 "constexpr int kRowEdges = 4;")]),
    "sum_guarded_loads": (
        "guarded loads where a lane owns one pack a pass and unconditional "
        "ones where it owns more, instead of guarded ones at every count",
        "sum", [("aggregate_sum.cu",
                 "gather_row<T, VEC, PACKS, LPR, (PACKS > 1), EDGES>(",
                 "gather_row<T, VEC, PACKS, LPR, false, EDGES>(")]),
    "sum_clamped_loads": (
        "guarded loads where a lane owns one pack a pass and unconditional "
        "ones where it owns more, instead of unconditional ones at every "
        "count",
        "sum", [("aggregate_sum.cu",
                 "gather_row<T, VEC, PACKS, LPR, (PACKS > 1), EDGES>(",
                 "gather_row<T, VEC, PACKS, LPR, true, EDGES>(")]),
    "sum_two_packs": (
        "up to 3 bf16 packs a lane a pass instead of 2 (602: 1 pass, not 2)",
        "sum", [("gather_tile.cuh", "constexpr int kMaxPacks = 3;",
                 "constexpr int kMaxPacks = 2;")]),
    "linear_guarded_loads": (
        "unconditional loads of a pass (clamped to the row's last pack) "
        "instead of guarded ones",
        "linear", [("aggregate_linear.cu", "  gather_tile<T>(p.row_ptr,",
                    "  gather_tile<T, false>(p.row_ptr,")]),
    "linear_u_clamped_loads": (
        "guarded loads in the backward's u (one pack a lane), as the sum's "
        "at one pack, instead of unconditional ones",
        "linear", [("aggregate_linear.cu",
                    "gather_row<T, VEC, 1, LPR, false, kRowEdges>(",
                    "gather_row<T, VEC, 1, LPR, true, kRowEdges>(")]),
    "linear_four_edges": (
        "2 edges in flight a lane group in the backward's u instead of 4",
        "linear", [("gather_tile.cuh", "constexpr int kRowEdges = 2;",
                    "constexpr int kRowEdges = 4;")]),
    "linear_tile_counter": (
        "one block a tile instead of tiles claimed from an atomic counter",
        "linear", _TILE_COUNTER),
    "linear_four_blocks": (
        "3 resident blocks an SM (80 registers) instead of 4 (64)",
        "linear", [("aggregate_linear.cu", "constexpr int kMinBlocks = 3;",
                    "constexpr int kMinBlocks = 4;")]),
    "linear_wide_gemm_at_41": (
        "64-column GEMM passes for outputs <= 64 wide instead of 256",
        "linear", [("aggregate_linear.cu",
                    "return p.m <= 64 ? launch_fwd_cg<T, 16>(p, s)",
                    "return p.m <= 0 ? launch_fwd_cg<T, 16>(p, s)")]),
    "linear_two_packs": (
        "up to 3 bf16 packs a lane a pass instead of 2 (602: 1 pass, not 2)",
        "linear", [("gather_tile.cuh", "constexpr int kMaxPacks = 3;",
                    "constexpr int kMaxPacks = 2;")]),
    "xlayer_clamped_loads": (
        "the region's sweeps with guarded loads (as before the shared "
        "gather) instead of the unconditional ones the per-layer kernels use",
        "xlayer", [("xlayer.cu",
                    "gather_tile<T, false>(rp, ci, src, ld, vec, 0,",
                    "gather_tile<T, true>(rp, ci, src, ld, vec, 0,"),
                   ("xlayer.cu",
                    "gather_tile<T, false>(rp, ci, src, ld, vec, row0,",
                    "gather_tile<T, true>(rp, ci, src, ld, vec, row0,")]),
    "two_blocks_an_sm": (
        "3 resident blocks an SM (80 registers) instead of 2 (128)",
        "xlayer", [("xlayer.cu", "constexpr int kMinBlocks = 3;",
                    "constexpr int kMinBlocks = 2;")]),
    "dw_tile_64": (
        "dW tiles of 64 x 128 (4 x 8 a thread) instead of 64 x 64 (4 x 4)",
        "xlayer", [("xlayer.cu", "constexpr int kDwJ = 128;",
                    "constexpr int kDwJ = 64;")]),
    "dw_stage_16": (
        "32 rows a dW stage instead of 16",
        "xlayer", [("xlayer.cu", "constexpr int kDwStage = 32;",
                    "constexpr int kDwStage = 16;")]),
    "bwd_inlined": (
        "the backward's sweeps and dW out of line instead of inlined",
        "xlayer", [("xlayer.cu", "__device__ __noinline__ void dw_partials(",
                    "__device__ __forceinline__ void dw_partials("),
                   ("xlayer.cu", "    sweep_outlined<T>(p.row_ptr,",
                    "    sweep<T>(p.row_ptr,"),
                   ("xlayer.cu", "    sweep_outlined<T>(p.t_row_ptr,",
                    "    sweep<T>(p.t_row_ptr,")]),
    "bf16_four_packs": (
        "at most 3 bf16 packs a lane a pass instead of 4",
        "xlayer", [("gather_tile.cuh", "constexpr int kMaxPacks = 3;",
                    "constexpr int kMaxPacks = 4;")]),
    "fp32_one_pass": (
        "three fp32 passes of 4 packs at 602 (exact) instead of one of 12",
        "xlayer", [("gather_tile.cuh",
                    "  constexpr int kBig = sizeof(T) == 2 ? kMaxPacks : 4;\n"
                    "  switch (packs_per_lane<T>((H + VEC - 1) / VEC, 32)) {",
                    "  constexpr int kBig = sizeof(T) == 2 ? kMaxPacks"
                    " : (VEC == 1 ? 12 : 24 / VEC);\n"
                    "  switch (packs_per_lane<T>((H + VEC - 1) / VEC, 32))"
                    " {")]),
    "gat_two_edges": (
        "8 edges in flight in the src kernel's du gather instead of 2",
        "gat", [("gat.cu",
                 "#pragma unroll 8\n          for (int ii = 0; ii < m; ++ii) {",
                 "#pragma unroll 2\n          for (int ii = 0; ii < m; ++ii) {")]),
    "gat_four_edges": (
        "8 edges in flight in the src kernel's du gather instead of 4",
        "gat", [("gat.cu",
                 "#pragma unroll 8\n          for (int ii = 0; ii < m; ++ii) {",
                 "#pragma unroll 4\n          for (int ii = 0; ii < m; ++ii) {")]),
    "gat_dq_per_edge": (
        "a one-tile row's dq written a batch at a time from shared memory "
        "(coalesced) where a lane owns one pack and K > 1 instead of by "
        "each edge's lane, a head at a time",
        "gat", [("gat.cu", "  const bool whole = PACKS == 1 && H <= kTile && K > 1;",
                 "  const bool whole = false;")]),
    "gat_dq_rows_at_two_packs": (
        "a one-tile row's dq written a batch at a time only where a lane "
        "owns one pack instead of at two packs too",
        "gat", [("gat.cu", "  const bool whole = PACKS == 1 && H <= kTile && K > 1;",
                 "  const bool whole = H <= kTile && K > 1;")]),
    "gat_src_static_rows": (
        "rows claimed from a counter by the resident blocks in the src kernel "
        "instead of a static order (a lane group's row from its block and "
        "place)",
        "gat", [("gat.cu", "    int claim = 0;\n"
                 "    if (sl == 0) claim = atomicAdd(claimed, 1);\n"
                 "    const int64_t row = __shfl_sync(gm, claim, 0, LPR);\n",
                 "    const int64_t row = static_cast<int64_t>(blockIdx.x) * "
                 "(blockDim.x / LPR) + group;\n"),
                ("gat.cu", "    __syncwarp(gm);  // the row's readers of st, pbuf, "
                 "ebuf, dsacc and asv are done\n", "    return;\n"),
                ("gat.cu", "  blocks = blocks < resident ? blocks : resident;\n",
                 "  (void)resident;\n")]),
    "gat_four_warps": (
        "8 warps a block in the src kernel instead of 4",
        "gat", [("gat.cu", "gat_bwd_src_rows<VEC, PACKS, LPR, ROUND>, kMaxWarps * 32,",
                 "gat_bwd_src_rows<VEC, PACKS, LPR, ROUND>, 4 * 32,")]),
    "gat_guarded_loads": (
        "unconditional du loads in the src kernel (a surplus pack re-reads "
        "the row's last pack) instead of guarded ones",
        "gat", [("gat.cu",
                 "            const Pack<VEC> gv = load_pack<VEC>(du + vv * H "
                 "+ cl[q]);\n",
                 "            Pack<VEC> gv = {};\n"
                 "            if (ok[q]) gv = load_pack<VEC>(du + vv * H "
                 "+ cl[q]);\n")]),
    "gat_three_blocks": (
        "2 resident blocks an SM (128 registers) in the src kernel with "
        "4-float packs instead of 3 (80)",
        "gat", [("gat.cu", "return vec == 4 ? 2 : 4;", "return vec == 4 ? 3 : 4;")]),
    "gat_narrow_three_blocks": (
        "4 resident blocks an SM (64 registers) in the src kernel with "
        "narrower packs instead of 3 (80)",
        "gat", [("gat.cu", "return vec == 4 ? 2 : 4;", "return vec == 4 ? 2 : 3;")]),
    "gat_dot_edges_whole": (
        "a batch's dots formed in halves where a lane owns several packs "
        "(8.3 KB of shared memory a warp at K = 4) instead of all at once "
        "(12.4 KB)",
        "gat", [("gat.cu", "return lpr * packs > 16 ? lpr / 2 : lpr;",
                 "return lpr;")]),
    "gat_dot_halves": (
        "a narrow group's batch dotted at once (one sum phase a batch) "
        "instead of in halves",
        "gat", [("gat.cu", "return lpr * packs > 16 ? lpr / 2 : lpr;",
                 "return lpr / 2;")]),
    "gat_src_warp_a_row": (
        "a lane group sized to the row's packs (16 lanes of one 4-float "
        "pack at H = 64) instead of a warp of two packs a lane, the earlier "
        "geometry", "gat", [], "_gat_warp_cases"),
    "gat_fwd_four_edges": (
        "2 edges in flight a lane group where a forward lane owns several "
        "packs a pass (layer 1) instead of 4",
        "gat_fwd", [("gat.cu", "constexpr int kFwdEdgesMany = 2;",
                     "constexpr int kFwdEdgesMany = 4;")]),
    "gat_fwd_two_edges": (
        "4 edges in flight a lane group where a forward lane owns one pack a "
        "pass (layer 2's staged plane) instead of 2",
        "gat_fwd", [("gat.cu", "constexpr int kFwdEdgesOne = 4;",
                     "constexpr int kFwdEdgesOne = 2;")]),
    "gat_fwd_guarded_loads": (
        "unconditional loads in the forward's gather (a surplus pack re-reads "
        "the row's last pack) instead of guarded ones",
        "gat_fwd", _FWD_GUARDED),
    "gat_fwd_static_rows": (
        "rows claimed from a counter by the resident blocks instead of a "
        "static order (a lane group's row from its block and place)",
        "gat_fwd", _FWD_STATIC),
    "gat_fwd_unsigned_rows": (
        "a claimed row held as a signed int instead of an unsigned one",
        "gat_fwd", [("gat.cu", "    int row = 0;\n"
                     "    if (sl == 0) row = atomicAdd(p.claimed, 1);\n",
                     "    unsigned row = 0;\n"
                     "    if (sl == 0) row = atomicAdd(reinterpret_cast<"
                     "unsigned*>(p.claimed), 1u);\n"),
                    ("gat.cu", "    if (row >= p.rows) return;\n"
                     "    fwd_row<VEC, PACKS, LPR, ROUND>(p, row, sl",
                     "    if (row >= static_cast<unsigned>(p.rows)) return;\n"
                     "    fwd_row<VEC, PACKS, LPR, ROUND>(p, static_cast<int64_t>"
                     "(row), sl")]),
    "gat_fwd_in_place_at_41": (
        "layer 2 (K = 1, 41 columns, 4-byte aligned rows) staged as an fp32 "
        "plane of 44 columns (one more launch) and gathered as 16 lanes x 1 "
        "four-float pack instead of gathered in place as 16 lanes x 3 "
        "one-float packs",
        "gat_fwd", [], "_gat_fwd_in_place_cases"),
    "gat_fwd_warp_at_41": (
        "layer 2 staged, in 16-lane groups, instead of gathered in place by "
        "a full warp a row (2 one-float packs a lane, the earlier geometry)",
        "gat_fwd", [], "_gat_fwd_warp_cases"),
    "dropout_one_element": (
        "one element a thread an iteration (2- or 4-byte loads and stores, "
        "the address arithmetic, loop control and first key injection per "
        "element) instead of 16-byte packs of 4 fp32 or 8 bf16",
        "dropout",
        [("dropout.cu",
          "  constexpr int N = kPackBytes / static_cast<int>(sizeof(T));\n",
          "  constexpr int N = 1;\n")]),
}


def _build(name: str, target: str, edits) -> tuple:
    import chip_smoke as C
    from roc_tpu_torch.ops.kernels import build as B
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for file, old, new in edits:
        src = (d / file).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {file} "
                               f"once")
        (d / file).write_text(src.replace(old, new))
    source = d / SOURCES[target]
    lib = d / f"libroc_{source.stem}.so"
    proc = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", str(lib),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return name, target, lib, C.ptxas_report(proc.stdout + proc.stderr)


def _sum_cases(ctx):
    """(label, call) of the sum target."""
    from roc_tpu_torch.ops.kernels import aggregate_sum as KS
    csr, xs = ctx["csr"], ctx["x"]
    cases = []
    for h, prec, d in ((41, "fast", "fwd"), (41, "fast", "transposed"),
                       (256, "fast", "fwd"), (256, "exact", "fwd"),
                       (256, "fast", "transposed"), (602, "fast", "fwd")):
        rp, ci = (csr.row_ptr, csr.col_idx) if d == "fwd" else \
            (csr.t_row_ptr, csr.t_col_idx)
        cases.append((f"H{h}_{d}_{prec}",
                      lambda x=xs[h], rp=rp, ci=ci, prec=prec:
                      KS.aggregate_sum(x, rp, ci, prec)))
    return cases


def _sum_per_edge_cases(ctx):
    """The sum target's fast H = 41 cases on x itself (the variant's
    per-edge rounding, kind 0 of roc_aggregate_sum), no staging launch."""
    from roc_tpu_torch.ops.kernels import aggregate_sum as KS
    csr, x = ctx["csr"], ctx["x"][41]

    def call(rp, ci):
        n = rp.numel() - 1
        out = torch.empty((n, x.shape[1]), device=x.device)
        KS.LIBRARY.launch(KS.aggregate_sum, "roc_aggregate_sum", x.device,
                          rp.data_ptr(), ci.data_ptr(), x.data_ptr(),
                          x.stride(0), 0, KS._vec_width(x), out.data_ptr(),
                          n, x.shape[1], 0, 0)
        return out
    return [(f"H41_{d}_fast", lambda rp=rp, ci=ci: call(rp, ci))
            for d, rp, ci in (("fwd", csr.row_ptr, csr.col_idx),
                              ("transposed", csr.t_row_ptr, csr.t_col_idx))]


def _linear_cases(ctx):
    from roc_tpu_torch.ops.kernels import aggregate_linear as KL
    csr, xs, ws = ctx["csr"], ctx["x"], ctx["w"]
    cases = [(f"{hi}_{ho}_{act}_{prec}",
              lambda hi=hi, ho=ho, act=act, prec=prec: KL.aggregate_linear(
                  xs[hi], ws[(hi, ho)], csr.row_ptr, csr.col_idx, prec, act))
             for hi, ho, act, prec in ((602, 256, "relu", "fast"),
                                       (256, 41, "none", "fast"),
                                       (602, 256, "relu", "exact"))]
    # the backward as the first layer asks for it: u alone, 602 <- 256 relu
    g, y = xs[256], xs[256].flip(0)
    cases.append(("bwd_602_256_relu_u_fast",
                  lambda: KL.aggregate_linear_bwd(
                      g, y, ws[(602, 256)], csr.t_row_ptr, csr.t_col_idx,
                      "fast", True, False)[0]))
    return cases


def _gat_cases(ctx):
    """The GAT backward at the main path's two layers: the src kernel in
    fast and exact, and the dst kernel on the checkout's fast dq."""
    from roc_tpu_torch.ops.kernels import gat as G
    csr = ctx["csr"]
    cases = []
    for (k, f), i in ctx["gat"].items():
        args = (i["x"], i["as_"], i["ad"], i["m"], i["du"], i["dz"],
                csr.t_row_ptr, csr.t_col_idx, 0.2)
        for prec in ("fast", "exact"):
            cases.append((f"src_K{k}_F{f}_{prec}",
                          lambda a=args, p=prec: G.gat_bwd_src(*a, p)))
        cases.append((f"dst_K{k}_F{f}",
                      lambda dq=i["dq"]: G.gat_bwd_dst(dq, csr.t_pos,
                                                       csr.row_ptr,
                                                       csr.col_idx)))
    return cases


def _gat_warp_cases(ctx):
    """The src kernel at a warp of two packs a lane, (32, 2), at every
    shape."""
    from roc_tpu_torch.ops.kernels import gat as G
    csr = ctx["csr"]
    cases = []
    for (k, f), i in ctx["gat"].items():
        args = (i["x"], i["as_"], i["ad"], i["m"], i["du"], i["dz"],
                csr.t_row_ptr, csr.t_col_idx, 0.2)
        vec = G.src_geometry(k, f, i["x"], i["du"]).vec
        for prec in ("fast", "exact"):
            cases.append((f"src_K{k}_F{f}_{prec}",
                          lambda a=args, p=prec, v=vec: G._src_launch(
                              *a, p, G.SrcGeometry(v, 32, 2))))
    return cases


def _gat_fwd_cases(ctx, geometry=None, shapes=((4, 64), (1, 41))):
    """The GAT forward at the main path's two layers, fast and exact, at
    the checkout's geometry or at ``geometry(k, f)``'s (the staging launch
    included where it stages)."""
    from roc_tpu_torch.ops.kernels import gat as G
    csr = ctx["csr"]

    def call(i, prec, geo):
        k, f = G._heads(i["x"], i["as_"])
        if geo is None:
            return G.gat_forward(i["x"], i["as_"], i["ad"], csr.row_ptr,
                                 csr.col_idx, 0.2, prec)
        return G._forward_launch(i["x"], i["as_"], i["ad"], csr.row_ptr,
                                 csr.col_idx, 0.2, prec, geo)[:3]
    cases = []
    for (k, f), i in ctx["gat"].items():
        if (k, f) not in shapes:
            continue
        geo = geometry(k, f) if geometry else None
        for prec in ("fast", "exact"):
            cases.append((f"fwd_K{k}_F{f}_{prec}",
                          lambda i=i, p=prec, g=geo: call(i, p, g)))
    return cases


def _gat_fwd_in_place_cases(ctx):
    """Layer 2's forward gathered from x in place (no staging)."""
    from roc_tpu_torch.ops.kernels import gat as G
    return _gat_fwd_cases(ctx, lambda k, f: G.FwdGeometry(1, 16, 3, False,
                                                          k * f),
                          shapes=((1, 41),))


def _gat_fwd_warp_cases(ctx):
    """Layer 2's forward with a full warp a row, 2 one-float packs a lane
    (the parent's geometry)."""
    from roc_tpu_torch.ops.kernels import gat as G
    return _gat_fwd_cases(ctx, lambda k, f: G.FwdGeometry(1, 32, 2, False,
                                                          k * f),
                          shapes=((1, 41),))


def _dropout_cases(ctx):
    """The dropout kernel's forward at the GCN's two dropout widths, fp32
    and bf16 (the -bf16 first layer), rate 0.5, chip_smoke.py's key."""
    import chip_smoke as C
    from roc_tpu_torch.ops import prng
    from roc_tpu_torch.ops.kernels import dropout as D
    key = prng.fold_in(prng.fold_in(prng.prng_key(C.SEED), 3), 1)
    return [(f"H{h}_{str(dt).split('.')[-1]}",
             lambda x=ctx["x"][h].to(dt): D.dropout(x, 0.5, key))
            for dt in (torch.float32, torch.bfloat16) for h in (602, 256)]


_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_SASS_HEX = re.compile(r"0x([0-9a-f]+)")
# opcodes issued to the INT32 pipe (64 lanes an SM on the H100), and the
# integer ones the FMA pipe takes (the compiler issues many adds as IMAD)
_INT_PIPE = ("IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT", "IABS",
             "IMNMX", "FLO", "POPC", "BMSK", "SGXT", "IADD", "SHL", "SHR",
             "LOP")
_FMA_INT = ("IMAD", "VIADD")


def _store_bytes(op: str) -> int:
    mods = op.split(".")[1:]
    for mod, n in (("128", 16), ("64", 8), ("U16", 2), ("16", 2),
                   ("U8", 1)):
        if mod in mods:
            return n
    return 4


def sass_loop(lib: Path, symbol: str, itemsize: int) -> dict:
    """Instructions an element of kernel ``symbol``'s grid-stride loop, from
    ``cuobjdump -sass`` of the built library: the instructions from the
    target of the widest backward branch to the branch, each counted once,
    over the elements the loop's global stores write."""
    out = subprocess.run([str(Path(_nvcc_dir()) / "cuobjdump"), "-sass",
                          str(lib)], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    body = next(f for f in out.split("Function : ")[1:]
                if symbol in f.splitlines()[0])
    instrs, loop = [], None
    for m in _SASS_INSTR.finditer(body):
        addr, op = int(m.group(1), 16), m.group(2)
        instrs.append((addr, op))
        tgt = _SASS_HEX.findall(m.group(3))
        if op.startswith("BRA") and tgt and int(tgt[-1], 16) < addr:
            span = (int(tgt[-1], 16), addr)
            if loop is None or span[1] - span[0] > loop[1] - loop[0]:
                loop = span
    ops = [op for a, op in instrs if loop and loop[0] <= a <= loop[1]]
    per = sum(_store_bytes(op) for op in ops
              if op.split(".")[0] in ("STG", "ST")) / itemsize or 1
    counts = {}
    for op in ops:
        counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
    return {"elements_an_iteration": per,
            "per_element": {"all": len(ops) / per,
                            "int32_pipe": sum(counts.get(o, 0)
                                              for o in _INT_PIPE) / per,
                            "fma_int": sum(counts.get(o, 0)
                                           for o in _FMA_INT) / per},
            "opcodes": counts}


def _nvcc_dir() -> str:
    from roc_tpu_torch.ops.kernels import build as B
    return str(Path(B._nvcc()).parent)


def _measure_cases(cases, ref: dict) -> dict:
    import chip_smoke as C
    rec = {}
    for label, call in cases:
        out = C._gat_parts(call())
        torch.cuda.synchronize()
        ref.setdefault(label, out)
        rec[label] = {"ms": C.time_ms(call, reps=10, warmup=2),
                      "bitwise": C._same_bits(out, ref[label])}
    return rec


def _measure_xlayer(ctx, ref: dict) -> dict:
    import chip_smoke as C
    from roc_tpu_torch.ops.kernels import xlayer as KX
    csr = ctx["csr"]
    x, ws, s, gg = ctx["region"]
    acts, depth = C.REGION_ACTS, len(C.REGION) - 1
    rec = {}
    for prec in ("fast", "exact"):
        def fwd(st=None):
            return KX.xlayer_fwd(x, ws, s, csr.row_ptr, csr.col_idx, prec,
                                 acts, stamps=st)
        y = fwd()

        def bwd(st=None):
            return KX.xlayer_bwd(gg, y, x, ws, s, csr.row_ptr, csr.col_idx,
                                 csr.t_row_ptr, csr.t_col_idx, prec, acts,
                                 False, stamps=st)
        _, dws = bwd()
        torch.cuda.synchronize()
        ref.setdefault(prec, (y, dws))
        rec[prec] = {
            "out_bitwise": bool(torch.equal(y, ref[prec][0])),
            "dw_bitwise": all(bool(torch.equal(a, b))
                              for a, b in zip(dws, ref[prec][1])),
            "fwd_ms": C.time_ms(fwd, reps=10, warmup=2),
            "bwd_ms": C.time_ms(bwd, reps=10, warmup=2),
            "fwd_phase_ms": C.region_phase_ms(fwd, depth, False, prec),
            "bwd_phase_ms": C.region_phase_ms(bwd, depth, True, prec)}
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    targets = sys.argv[1:] or list(SOURCES)
    if not set(targets) <= set(SOURCES):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.ops.kernels import aggregate_linear as KL
    from roc_tpu_torch.ops.kernels import aggregate_sum as KS
    from roc_tpu_torch.ops.kernels import build_all
    from roc_tpu_torch.ops.kernels import dropout as KD
    from roc_tpu_torch.ops.kernels import gat as KG
    from roc_tpu_torch.ops.kernels import xlayer as KX

    todo = [(f"checkout_{t}", t, []) for t in targets] + \
        [(k, v[1], v[2]) for k, v in VARIANTS.items() if v[1] in targets]
    own_cases = {"sum": _sum_cases, "linear": _linear_cases,
                 "gat": _gat_cases, "gat_fwd": _gat_fwd_cases,
                 "dropout": _dropout_cases}
    with ThreadPoolExecutor(len(todo)) as pool:
        built = list(pool.map(lambda a: _build(*a), todo))
        pool.submit(build_all).result()     # the checkout's other libraries
    dev = torch.device("cuda", 0)
    g = datasets.get("reddit", seed=C.SEED).graph
    n = g.num_nodes
    csr = DeviceCsr.from_csr(g, dev, edge_map="gat" in targets)
    gen = torch.Generator(device=dev).manual_seed(C.SEED + 7)
    ctx = {"csr": csr,
           "x": {h: torch.randn((n, h), generator=gen, device=dev)
                 for h in (41, 256, 602)},
           "w": {k: torch.randn(k, generator=gen, device=dev)
                 for k in ((602, 256), (256, 41))}}
    if "xlayer" in targets:
        scale = torch.rsqrt(torch.as_tensor(g.in_degrees,
                                            dtype=torch.float32, device=dev))
        ctx["region"] = C.region_gauss_inputs(n, C.REGION, scale, gen, dev)
    if {"gat", "gat_fwd"} & set(targets):
        ctx["gat"] = {}
        for k, f in ((8, 8), (4, 64), (1, 41)):
            i = C._gat_inputs(n, k, f, gen, dev)
            i["m"] = KG.gat_forward(i["x"], i["as_"], i["ad"], csr.row_ptr,
                                    csr.col_idx, 0.2, "fast")[1]
            if "gat" in targets:
                i["dq"] = KG.gat_bwd_src(i["x"], i["as_"], i["ad"], i["m"],
                                         i["du"], i["dz"], csr.t_row_ptr,
                                         csr.t_col_idx, 0.2, "fast")[2]
            ctx["gat"][(k, f)] = i
    modules = {"sum": KS, "linear": KL, "xlayer": KX, "gat": KG,
               "gat_fwd": KG, "dropout": KD}
    own = {t: modules[t].LIBRARY.load() for t in targets}
    refs = {t: {} for t in targets}
    order = built + [b for b in built if b[0].startswith("checkout_")]
    for name, target, path, ptxas in order:
        mod = modules[target]
        lib = ctypes.CDLL(str(path))
        mod._bind(lib)
        mod.LIBRARY._lib = lib
        kernels = {"sum": ("sum_rows", "stage_kernel"),
                   "linear": ("mega_fwd", "mega_bwd_u"),
                   "xlayer": ("xlayer_",),
                   "gat": ("gat_bwd_",),
                   "gat_fwd": ("gat_fwd_",),
                   "dropout": ("dropout_kernel",)}[target]
        rec = {"variant": name, "target": target,
               "reverses": VARIANTS[name][0] if name in VARIANTS else None,
               "ptxas": {k: v for k, v in ptxas.items()
                         if any(s in k for s in kernels)}}
        if target == "xlayer":
            rec.update(_measure_xlayer(ctx, refs[target]))
        else:
            spec = VARIANTS.get(name, ())
            cases = (globals()[spec[3]] if len(spec) > 3
                     else own_cases[target])(ctx)
            rec["cases"] = _measure_cases(cases, refs[target])
        if target == "dropout":
            rec["sass"] = {dt: sass_loop(path, f"dropout_kernel{tag}", size)
                           for dt, tag, size in (
                               ("float32", "If", 4),
                               ("bfloat16", "I13__nv_bfloat16", 2))}
        mod.LIBRARY._lib = own[target]
        C.emit(rec)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
