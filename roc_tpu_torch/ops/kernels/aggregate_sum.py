"""CSR sum aggregation: the CUDA kernel, its loader and its plain version.

``aggregate_sum(x, row_ptr, col_idx, precision)`` computes
``out[v] = sum over in-edges (u -> v) of x[u]`` over the in-edge CSR
(``col_idx[row_ptr[v]:row_ptr[v+1]]`` are v's sources), the function the
JAX package computes with four Pallas kernels through
``roc_tpu/ops/pallas/binned.py:run_binned``.  Precision contract
(``binned.py:37-46``):

  fast   every feature takes exactly one bf16 rounding; fp32 accumulation
  exact  fp32 end to end

A bf16 input makes the two identical.  The output is in ``x.dtype``.

On a CUDA tensor the wrapper launches ``csrc/aggregate_sum.cu`` (built with
``nvcc`` for ``sm_90a`` into ``roc_tpu_torch/build/`` at first use and
loaded with ctypes) or raises; on a CPU tensor it runs
:func:`aggregate_sum_plain`.  In "fast" on an fp32 x the card runs two
kernels: :func:`stage_plane` writes x once as a bf16 plane (the rounding
done once per source row, not once per edge), then the gather sums that
plane.  ``aggregate_sum.launches`` and ``stage_plane.launches`` count the
two kernels' launches, so a caller can show that a run went through them;
``aggregate_sum.by_launch`` splits the gather's by launch configuration
(the autotuner's, ``tune/``: lanes a row and edges in flight).
:func:`stage_plain` is the plain twin of the staged plane, for the tests.
Gradients flow through ``ops.aggregate``'s autograd Function, whose
backward is this same function over the transposed CSR.

x may be a column slice of a wider tensor (rows ``x.stride(0)`` elements
apart, each row contiguous); a bf16 x must be contiguous.

Index bounds are not checked per call (that would cost a device sync on
every aggregation): ``col_idx`` must lie in ``[0, x.shape[0])`` and
``row_ptr`` must be a monotone prefix ending at ``col_idx.numel()``.
``train.graph_data.dense_graph_data`` validates the CSR once when it puts
it on the device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from roc_tpu_torch.ops.kernels.build import CudaLibrary, _require_cuda

# Edges per plain-version chunk: the gathered [chunk, H] block stays near
# 2^25 elements (128 MiB fp32).  Unchunked, x[col_idx] at Reddit shape is
# 23.5 M x 256 x 4 B = 24 GB (roc_tpu/ops/aggregate.py:47-78 chunks the
# same way).  It sizes the plain version's chunks only and never reaches
# the card, so it is no launch parameter of the kernel.
_CHUNK_TARGET_ELEMS = 1 << 25

# The kernel's launch configuration, (lanes a row, edges in flight):
# (0, 0) is csrc/aggregate_sum.cu's own rule (lanes_per_row, kRowEdges).
DEFAULT_LAUNCH = (0, 0)


def check_precision(precision: str, dtype: torch.dtype) -> None:
    """Reject unknown precisions and dtypes the contract does not cover: a
    silent fallthrough to fast would drop the fp32-exact guarantee
    (binned.py:3708-3718)."""
    if precision not in ("fast", "exact"):
        raise ValueError(f"precision={precision!r}: must be 'fast' or "
                         f"'exact'")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"aggregate_sum supports float32/bfloat16 inputs, "
                         f"got {dtype}")


def _bind(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.roc_aggregate_sum
    fn.argtypes = [p, p, p, ll, i, i, p, ll, ll, i, i, p]
    fn.restype = i
    stage = lib.roc_stage_plane
    stage.argtypes = [p, ll, ll, ll, i, p, ll, i, p]
    stage.restype = i


LIBRARY = CudaLibrary("aggregate_sum.cu", _bind)


def _check_csr(x, row_ptr, col_idx) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [table_rows, H], got shape "
                         f"{tuple(x.shape)}")
    if row_ptr.dim() != 1 or row_ptr.numel() < 1:
        raise ValueError("row_ptr must be 1-D of length num_rows + 1")
    if row_ptr.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"row_ptr must be int64 or int32, got "
                         f"{row_ptr.dtype}")
    if col_idx.dim() != 1 or col_idx.dtype != torch.int32:
        raise ValueError(f"col_idx must be 1-D int32, got "
                         f"{col_idx.dtype} of shape {tuple(col_idx.shape)}")
    if not (x.device == row_ptr.device == col_idx.device):
        raise ValueError(f"x, row_ptr and col_idx must share a device, got "
                         f"{x.device}, {row_ptr.device}, {col_idx.device}")


def aggregate_sum_plain(x: torch.Tensor, row_ptr: torch.Tensor,
                        col_idx: torch.Tensor, precision: str = "fast",
                        launch=DEFAULT_LAUNCH) -> torch.Tensor:
    """The plain PyTorch version: the same function on any device, gathered
    in edge chunks and ``index_add_``-ed into an fp32 accumulator.  It is the
    reference the kernel is held against, and what the wrapper runs for CPU
    tensors.  ``launch`` is the kernel's and is ignored here."""
    _check_csr(x, row_ptr, col_idx)
    check_precision(precision, x.dtype)
    n, h = row_ptr.numel() - 1, x.shape[1]
    if precision == "fast" or x.dtype == torch.bfloat16:
        xs = x.to(torch.bfloat16).to(torch.float32)
    else:
        xs = x
    acc = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    num_edges = col_idx.numel()
    chunk = max(_CHUNK_TARGET_ELEMS // max(h, 1), 1024)
    for lo in range(0, num_edges, chunk):
        hi = min(lo + chunk, num_edges)
        e = torch.arange(lo, hi, dtype=row_ptr.dtype, device=x.device)
        dst = torch.searchsorted(row_ptr, e, right=True) - 1
        acc.index_add_(0, dst, xs.index_select(0, col_idx[lo:hi]))
    return acc.to(x.dtype)


def _vec_width(x: torch.Tensor) -> int:
    """Widest vector load (elements per lane) that divides H and the row
    stride and keeps every row start aligned."""
    h, es = x.shape[1], x.element_size()
    for v in (4, 2, 1):
        if (h % v == 0 and x.stride(0) % v == 0
                and x.data_ptr() % (v * es) == 0):
            return v
    return 1


def _ld(h: int, precision: str) -> int:
    """Row stride of a staged plane: 16-byte rows, 8 bf16 (fast) or 4 fp32
    (exact) elements."""
    q = 8 if precision == "fast" else 4
    return -(-h // q) * q


def stage_plain(src: torch.Tensor, mask: Optional[torch.Tensor] = None,
                precision: str = "fast") -> torch.Tensor:
    """The kernels' staging step as plain PyTorch: ``src * [mask > 0]``
    (``src`` itself without a mask) stored as the plane a gather reads,
    [N, ld] with the columns from H on 0: bf16 (round to nearest even) in
    fast, fp32 in exact.  :func:`stage_plane` stages x with no mask; the
    region kernels stage the last layer's cotangent with the saved output
    y."""
    n, h = src.shape
    dtype = torch.bfloat16 if precision == "fast" else torch.float32
    out = torch.zeros((n, _ld(h, precision)), dtype=dtype, device=src.device)
    v = src if mask is None else torch.where(mask > 0, src,
                                             torch.zeros_like(src))
    out[:, :h] = v.to(dtype)
    return out


def stage_plane(x: torch.Tensor) -> torch.Tensor:
    """x [rows, H] fp32 as the bf16 plane [rows, ld8(H)] a "fast" gather
    reads: each element rounded once to bf16 (round to nearest even), the
    columns from H on 0.  Launches the CUDA kernel for CUDA tensors; for
    CPU tensors it is :func:`stage_plain`.  (``gat.gat_stage`` launches the
    same kernel's fp32 plane, counted as its own.)"""
    if x.device.type == "cpu":
        return stage_plain(x)
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"stage_plane takes a 2-D float32 x, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    _require_cuda("stage_plane", rows=(x,))
    return plane_launch(x, "fast", stage_plane)


def plane_launch(x: torch.Tensor, precision: str,
                 wrapper) -> torch.Tensor:
    """The staging kernel on a checked fp32 x: the plane ``stage_plain``
    gives, bf16 in fast and fp32 in exact, its launch counted on
    ``wrapper``."""
    n, h = x.shape
    ld = _ld(h, precision)
    exact = precision == "exact"
    out = torch.empty((n, ld), device=x.device,
                      dtype=torch.float32 if exact else torch.bfloat16)
    if n == 0 or h == 0:
        return out.zero_()
    LIBRARY.launch(wrapper, "roc_stage_plane", x.device, x.data_ptr(),
                   x.stride(0), n, h, _vec_width(x), out.data_ptr(), ld,
                   int(exact))
    return out


def aggregate_sum(x: torch.Tensor, row_ptr: torch.Tensor,
                  col_idx: torch.Tensor, precision: str = "fast",
                  launch=DEFAULT_LAUNCH) -> torch.Tensor:
    """``out[v] = sum over in-edges of x[src]``: [table_rows, H] ->
    [num_rows, H] in ``x.dtype``.  Launches the CUDA kernels for CUDA
    tensors, runs the plain version for CPU tensors.  ``launch`` is the
    gather's (lanes a row, edges in flight), ``DEFAULT_LAUNCH`` for the
    kernel's own rule (the autotuner's choice comes from
    ``ops.DeviceCsr.sum_launch``); a bf16 x takes the default only.  A
    configuration the library does not build raises."""
    if x.device.type == "cpu":
        return aggregate_sum_plain(x, row_ptr, col_idx, precision)
    _check_csr(x, row_ptr, col_idx)
    check_precision(precision, x.dtype)
    _require_cuda("aggregate_sum", row_ptr, col_idx, rows=(x,))
    if x.dtype == torch.bfloat16 and not x.is_contiguous():
        raise ValueError("a bf16 x must be contiguous")
    launch = tuple(int(v) for v in launch)
    if x.dtype == torch.bfloat16 and launch != DEFAULT_LAUNCH:
        raise ValueError(f"a bf16 x is summed at the default launch only, "
                         f"got {launch}")
    row_ptr = row_ptr.to(torch.int64)
    n, h = row_ptr.numel() - 1, x.shape[1]
    out = torch.empty((n, h), dtype=x.dtype, device=x.device)
    if n == 0 or h == 0:
        return out
    if x.dtype == torch.bfloat16:
        src, ld, kind, vec = x, h, 2, _vec_width(x)
    elif precision == "exact":
        src, ld, kind, vec = x, x.stride(0), 0, _vec_width(x)
    else:
        src = plane_launch(x, "fast", stage_plane)
        ld, kind, vec = src.shape[1], 1, 8
    LIBRARY.launch(aggregate_sum, "roc_aggregate_sum", x.device,
                   row_ptr.data_ptr(), col_idx.data_ptr(), src.data_ptr(),
                   ld, kind, vec, out.data_ptr(), n, h, *launch)
    by = aggregate_sum.by_launch
    by[launch] = by.get(launch, 0) + 1
    return out


aggregate_sum.launches = 0
# launches by the (lanes a row, edges in flight) pair passed, (0, 0) for the
# kernel's own rule: where a tuned DeviceCsr.launch reached the kernel
aggregate_sum.by_launch = {}
stage_plane.launches = 0
