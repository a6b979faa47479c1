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
:func:`aggregate_sum_plain`.  ``aggregate_sum.launches`` counts kernel
launches, so a caller can show that a run went through the kernel.
Gradients flow through ``ops.aggregate``'s autograd Function, whose
backward is this same function over the transposed CSR.

Index bounds are not checked per call (that would cost a device sync on
every aggregation): ``col_idx`` must lie in ``[0, x.shape[0])`` and
``row_ptr`` must be a monotone prefix ending at ``col_idx.numel()``.
``train.graph_data.dense_graph_data`` validates the CSR once when it puts
it on the device.
"""

from __future__ import annotations

import ctypes

import torch

from roc_tpu_torch.ops.kernels.build import CudaLibrary

# Edges per plain-version chunk: the gathered [chunk, H] block stays near
# 2^25 elements (128 MiB fp32).  Unchunked, x[col_idx] at Reddit shape is
# 23.5 M x 256 x 4 B = 24 GB (roc_tpu/ops/aggregate.py:47-78 chunks the
# same way).
_CHUNK_TARGET_ELEMS = 1 << 25


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
    fn = lib.roc_aggregate_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int


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
                        col_idx: torch.Tensor,
                        precision: str = "fast") -> torch.Tensor:
    """The plain PyTorch version: the same function on any device, gathered
    in edge chunks and ``index_add_``-ed into an fp32 accumulator.  It is the
    reference the kernel is held against, and what the wrapper runs for CPU
    tensors."""
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
    """Widest vector load (elements per lane) that divides H and keeps every
    row start aligned."""
    h, es = x.shape[1], x.element_size()
    for v in (4, 2, 1):
        if h % v == 0 and x.data_ptr() % (v * es) == 0:
            return v
    return 1


def aggregate_sum(x: torch.Tensor, row_ptr: torch.Tensor,
                  col_idx: torch.Tensor,
                  precision: str = "fast") -> torch.Tensor:
    """``out[v] = sum over in-edges of x[src]``: [table_rows, H] ->
    [num_rows, H] in ``x.dtype``.  Launches the CUDA kernel for CUDA
    tensors, runs the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return aggregate_sum_plain(x, row_ptr, col_idx, precision)
    if x.device.type != "cuda":
        raise ValueError(f"aggregate_sum runs on cuda or cpu tensors, got "
                         f"{x.device}")
    _check_csr(x, row_ptr, col_idx)
    check_precision(precision, x.dtype)
    for name, t in (("x", x), ("row_ptr", row_ptr), ("col_idx", col_idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, h = row_ptr.numel() - 1, x.shape[1]
    out = torch.empty((n, h), dtype=x.dtype, device=x.device)
    if n == 0 or h == 0:
        return out
    fn = LIBRARY.load().roc_aggregate_sum
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(row_ptr.data_ptr(), int(row_ptr.dtype == torch.int64),
                 col_idx.data_ptr(), x.data_ptr(), out.data_ptr(), n, h,
                 0 if x.dtype == torch.float32 else 1,
                 int(precision == "fast" and x.dtype == torch.float32),
                 _vec_width(x), stream)
    if err != 0:
        raise RuntimeError(f"aggregate_sum kernel launch failed: CUDA error "
                           f"{err}")
    aggregate_sum.launches += 1
    return out


aggregate_sum.launches = 0
