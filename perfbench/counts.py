"""Operations and bytes of the work a step or a forward needs, counted
from the shapes, and the card's peaks.  Each model module under
``perfbench/reference/`` counts its own step (``counts``) from the
functions here.

Rules: a multiply-add is 2 operations, an add, a compare, a max or an exp
is 1; each input byte is read once and each output byte written once,
whatever a kernel reads again; recomputed work is not counted, and neither
is the first layer's dX, which no step needs.  A function's least time is
the larger of its operations over the peak rate and its bytes over the
peak bandwidth.

Peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W limit): 67
TFLOP/s fp32 outside the tensor cores, the precision these configurations
compute in, and 3.35 TB/s of HBM3."""

from __future__ import annotations

import re

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32, I32, I64 = 4, 4, 8


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _csr_bytes(n: int, e: int) -> int:
    return (n + 1) * I64 + e * I32


def sum_call(n: int, e: int, h: int):
    """One in-edge sum of an fp32 [N, H] (its staging included): an add
    per gathered element; x read, the CSR read, out written."""
    return e * h, 2 * n * h * F32 + _csr_bytes(n, e)


def _widths(cfg, heads: int):
    """(in width, out width, heads, head width) of each layer: ``heads``
    heads on every layer but the last, which has one (a model without
    heads passes 1)."""
    layers = [int(v) for v in cfg["layers"]]
    out, width = [], layers[0]
    for i in range(1, len(layers)):
        k = 1 if i == len(layers) - 1 else heads
        out.append((width, k * layers[i], k, layers[i]))
        width = k * layers[i]
    return out


def gemm_flops(widths, n: int, train: bool) -> float:
    """One [N, in] x [in, out] GEMM a layer of ``widths`` (``_widths``'
    rows): forward, and in training dW and dX (past the first layer)."""
    total = 0
    for i, (din, dout, _, _) in enumerate(widths):
        f = 2 * n * din * dout
        total += f
        if train:
            total += f + (f if i > 0 else 0)   # dW, and dX past layer 1
    return total


def gat_score_call(n: int, k: int, f: int):
    """a_src . h[u] a source and head."""
    h = k * f
    return 2 * n * h, n * h * F32 + h * F32 + n * k * F32


def gat_fwd_call(n: int, e: int, k: int, f: int):
    """Per edge and head: the score's add and leaky relu, the max, the
    shift and exp, the normaliser's add (5) and F multiply-adds; per
    output element a division."""
    h = k * f
    ops = e * k * (2 * f + 5) + n * h
    nbytes = (n * h * F32 + 2 * n * k * F32 + _csr_bytes(n, e)
              + n * h * F32 + 2 * n * k * F32)
    return ops, nbytes


def gat_bwd_call(n: int, e: int, k: int, f: int):
    """Per edge and head: F multiply-adds into dtable, F into the score
    gradient's dot, the softmax and leaky-relu gradient and the two
    per-node sums (5); reads x, the scores, m, z, du and dz and one form
    of the graph; writes dtable, dast and dadl."""
    h = k * f
    ops = e * k * (4 * f + 5)
    nbytes = (2 * n * h * F32 + 5 * n * k * F32 + _csr_bytes(n, e)
              + n * h * F32 + 2 * n * k * F32)
    return ops, nbytes


def step_totals(gemm, sum_flops=0.0, gat_flops=0.0, sum_least_s=0.0,
                gat_least_s=0.0) -> dict:
    """The dict :func:`step_counts` returns, from a model's GEMM
    operations and its other parts; a model without sums or GAT kernels
    leaves theirs at 0."""
    return {"flops": gemm + sum_flops + gat_flops,
            "gemm_flops": gemm, "sum_flops": sum_flops,
            "gat_flops": gat_flops, "sum_least_s": sum_least_s,
            "gat_least_s": gat_least_s}


def step_counts(cfg, n: int, e: int, train: bool) -> dict:
    """Model operations of one step (``train``) or one full-graph eval
    forward, and the least seconds of the sum and the GAT functions in
    it: the ``counts`` of the model module the configuration names
    under ``reference``."""
    from perfbench.reference import model_module
    return model_module(cfg).counts(cfg, n, e, train)


# the port's kernels by name in the device trace
SUM_KERNELS = r"sum_rows|stage_kernel(?!_f32)"
GAT_KERNELS = (r"gat_score_rows|gat_fwd_rows|gat_bwd_src_rows|"
               r"gat_bwd_dst_rows|stage_kernel_f32")
GEMM_KERNELS = r"(?i)gemm|splitkreduce"


def kernel_seconds(trace: dict, pattern: str) -> float:
    """Device seconds of the traced window's kernels whose names match."""
    rx = re.compile(pattern)
    return sum(s for name, s in trace["kernels"].items() if rx.search(name))
