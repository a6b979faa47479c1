#!/usr/bin/env python3
"""Time design variants of the region kernels (roc_tpu_torch/csrc/xlayer.cu)
against the checkout's own source on one NVIDIA GPU, in one call.

    python3 chip_variants.py

Each variant is the checkout's xlayer.cu with one source edit (VARIANTS
below: each names the design choice it reverses), built with the same nvcc
flags into chip_check/variants/ (gitignored), all builds started together.
On the Reddit graph, at the full-width path's region (depth 3,
602-256-256-256, relu, the norm pair) with chip_smoke.py's Gaussian
inputs, for each variant in turn (the checkout first and last), both
precisions: the CUDA-event time of xlayer_fwd and of xlayer_bwd without dx
(median of 10 launches), the phase split (median of 5 stamped launches),
the compiler's registers and spill bytes, and whether the outputs equal the
checkout's bitwise (a variant that changes only the schedule keeps them;
dW may differ in its last bits where the schedule of its sums changes).
One JSON line per variant, then the card's name and power limit as
nvidia-smi gives them.  Exits non-zero without CUDA or when a build fails.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "roc_tpu_torch" / "csrc"
OUT = ROOT / "chip_check" / "variants"

# name -> (the design choice it reverses, [(old, new) source edits])
VARIANTS = {
    "two_blocks_an_sm": (
        "3 resident blocks an SM (80 registers) instead of 2 (128)",
        [("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")]),
    "dw_tile_64": (
        "dW tiles of 64 x 128 (4 x 8 a thread) instead of 64 x 64 (4 x 4)",
        [("constexpr int kDwJ = 128;", "constexpr int kDwJ = 64;")]),
    "dw_stage_16": (
        "32 rows a dW stage instead of 16",
        [("constexpr int kDwStage = 32;", "constexpr int kDwStage = 16;")]),
    "bwd_inlined": (
        "the backward's sweeps and dW out of line instead of inlined",
        [("__device__ __noinline__ void dw_partials(",
          "__device__ __forceinline__ void dw_partials("),
         ("    sweep_outlined<T>(p.row_ptr,", "    sweep<T>(p.row_ptr,"),
         ("    sweep_outlined<T>(p.t_row_ptr,", "    sweep<T>(p.t_row_ptr,")]),
    "bf16_four_packs": (
        "at most 3 bf16 packs a lane a pass instead of 4",
        [("constexpr int kMaxPacks = 3;", "constexpr int kMaxPacks = 4;")]),
    "fp32_one_pass": (
        "three fp32 passes of 4 packs at 602 (exact) instead of one of 12",
        [("constexpr int kBig = sizeof(T) == 2 ? kMaxPacks : 4;",
          "constexpr int kBig = sizeof(T) == 2 ? kMaxPacks"
          " : (VEC == 1 ? 12 : 24 / VEC);")]),
}


def _build(name: str, edits) -> tuple:
    import chip_smoke as C
    from roc_tpu_torch.ops.kernels import build as B
    src = (CSRC / "xlayer.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               f"xlayer.cu once")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "xlayer.cu").write_text(src)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, d)
    lib = d / "libroc_xlayer.so"
    proc = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", str(lib),
                           str(d / "xlayer.cu")], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return name, lib, C.ptxas_report(proc.stdout + proc.stderr)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.ops.kernels import xlayer as KX

    todo = {"checkout": []} | {k: v[1] for k, v in VARIANTS.items()}
    with ThreadPoolExecutor(len(todo)) as pool:
        built = list(pool.map(lambda kv: _build(*kv), todo.items()))
    dev = torch.device("cuda", 0)
    g = datasets.get("reddit", seed=C.SEED).graph
    n = g.num_nodes
    csr = DeviceCsr.from_csr(g, dev)
    scale = torch.rsqrt(torch.as_tensor(g.in_degrees, dtype=torch.float32,
                                        device=dev))
    gen = torch.Generator(device=dev).manual_seed(C.SEED + 7)
    x, ws, s, gg = C.region_gauss_inputs(n, C.REGION, scale, gen, dev)
    acts, depth = C.REGION_ACTS, len(C.REGION) - 1
    ref = {}
    for name, path, ptxas in built + built[:1]:
        lib = ctypes.CDLL(str(path))
        KX._bind(lib)
        KX.LIBRARY._lib = lib
        rec = {"variant": name,
               "reverses": VARIANTS[name][0] if name in VARIANTS else None,
               "ptxas": {k: v for k, v in ptxas.items() if "xlayer_" in k}}
        for prec in ("fast", "exact"):
            def fwd(st=None):
                return KX.xlayer_fwd(x, ws, s, csr.row_ptr, csr.col_idx,
                                     prec, acts, stamps=st)
            y = fwd()

            def bwd(st=None):
                return KX.xlayer_bwd(gg, y, x, ws, s, csr.row_ptr,
                                     csr.col_idx, csr.t_row_ptr,
                                     csr.t_col_idx, prec, acts, False,
                                     stamps=st)
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
        C.emit(rec)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
