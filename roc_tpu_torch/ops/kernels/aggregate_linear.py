"""Whole-layer megakernel: aggregate -> linear (-> relu) and its backward,
the CUDA kernels, their loader and their plain versions.

``aggregate_linear(x, w, row_ptr, col_idx, precision, activation)``
computes ``act((A x) W)``: the sum over v's in-edges of ``x[u]``, times
``w``, then the activation ("none" or "relu").  It is the function of the
JAX package's ``roc_tpu/ops/pallas/binned.py:run_binned_linear``
(``_mega_kernel``).

``aggregate_linear_bwd(g, y, w, t_row_ptr, t_col_idx, precision, relu)``
computes, over the transposed CSR, ``u = A^T (g * [y > 0])`` (``A^T g``
without relu) and ``dx = u W^T``: the function of ``run_binned_linear_bwd``
(``_mega_bwd_kernel``).  ``dW = x^T u`` is left to the caller as one GEMM,
as the JAX package leaves it to XLA.  On the card it runs two kernels:
``stage_cotangent`` writes the masked, rounded cotangent once per source
row (a bf16 plane in "fast", fp32 in exact with relu; exact without relu
gathers g itself), then the backward gathers that plane.

Precision contract (binned.py:2304-2317, :2599-2615):

  fast   one bf16 rounding of each gathered element (x forward, the masked
         g backward), fp32 accumulation, an fp32 GEMM
  exact  fp32 throughout

The GEMM part is fp32 (the JAX kernel's ``Precision.HIGHEST``): no TF32.
Inputs and outputs are fp32.

On a CUDA tensor each wrapper launches its kernel from
``csrc/aggregate_linear.cu`` or raises; on a CPU tensor it runs the plain
version.  In "fast" the forward first stages x once as a bf16 plane
(``aggregate_sum.stage_plane``'s kernel, counted in
``stage_plane.launches``).  ``aggregate_linear.launches``,
``aggregate_linear_bwd.launches`` and ``stage_cotangent.launches`` count
kernel launches.  Index bounds are
the caller's, as for ``aggregate_sum`` (the graph data validates the CSR
once).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from roc_tpu_torch.ops.kernels.aggregate_sum import (_check_csr, _ld,
                                                     _vec_width,
                                                     aggregate_sum_plain,
                                                     check_precision,
                                                     plane_launch,
                                                     stage_plane)
from roc_tpu_torch.ops.kernels.build import (CudaLibrary, _csr_int64,
                                             _require_cuda)
from roc_tpu_torch.ops.linear import linear


def _bind(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd = lib.roc_aggregate_linear
    fwd.argtypes = [p, p, p, ll, i, p, ll, p, ll, ll, ll, i, i, p]
    fwd.restype = ctypes.c_int
    stage = lib.roc_stage_cotangent
    stage.argtypes = [p, p, p, ll, ll, ll, i, i, i, p]
    stage.restype = ctypes.c_int
    bwd = lib.roc_aggregate_linear_bwd
    bwd.argtypes = [p, p, p, ll, i, i, p, ll, p, p, ll, ll, ll, p]
    bwd.restype = ctypes.c_int


LIBRARY = CudaLibrary("aggregate_linear.cu", _bind)


def _check(precision: str, activation: str, *tensors) -> None:
    check_precision(precision, torch.float32)
    if activation not in ("none", "relu"):
        raise ValueError(f"activation={activation!r}: the megakernel fuses "
                         f"'none' or 'relu' only")
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"the megakernel takes float32 tensors, got "
                             f"{t.dtype}")


def aggregate_linear_plain(x: torch.Tensor, w: torch.Tensor,
                           row_ptr: torch.Tensor, col_idx: torch.Tensor,
                           precision: str = "fast",
                           activation: str = "none") -> torch.Tensor:
    """The plain PyTorch version on any device: the chunked aggregation at
    the given precision, then ``ops.linear`` (an fp32 GEMM, TF32 off) and
    the activation."""
    _check_csr(x, row_ptr, col_idx)
    _check(precision, activation, x, w)
    return linear(aggregate_sum_plain(x, row_ptr, col_idx, precision), w,
                  activation)


def stage_cotangent_plain(g: torch.Tensor, y: Optional[torch.Tensor],
                          precision: str = "fast",
                          relu: bool = False) -> torch.Tensor:
    """The staged cotangent as fp32 values: ``g * [y > 0]`` (g without
    relu; a NaN of g passes where y > 0), rounded once to bf16 in
    "fast"."""
    _check(precision, "relu" if relu else "none", g)
    s = torch.where(y > 0, g, torch.zeros_like(g)) if relu else g
    return s.to(torch.bfloat16).to(torch.float32) if precision == "fast" \
        else s


def aggregate_linear_bwd_plain(g: torch.Tensor, y: Optional[torch.Tensor],
                               w: torch.Tensor, t_row_ptr: torch.Tensor,
                               t_col_idx: torch.Tensor,
                               precision: str = "fast", relu: bool = False,
                               need_dx: bool = True
                               ) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """The plain version of the backward: ``(u, dx)`` with ``u`` the sum
    over the transposed CSR of the staged cotangent
    (:func:`stage_cotangent_plain`, already rounded, so summed in fp32) and
    ``dx = u W^T`` in fp32 (None unless ``need_dx``)."""
    _check_csr(g, t_row_ptr, t_col_idx)
    _check(precision, "relu" if relu else "none", g, w)
    s = stage_cotangent_plain(g, y, precision, relu)
    u = aggregate_sum_plain(s, t_row_ptr, t_col_idx, "exact")
    return u, (linear(u, w.t()) if need_dx else None)


def aggregate_linear(x: torch.Tensor, w: torch.Tensor,
                     row_ptr: torch.Tensor, col_idx: torch.Tensor,
                     precision: str = "fast",
                     activation: str = "none") -> torch.Tensor:
    """``act((A x) W)``: x [table_rows, H_in] (rows may be ``x.stride(0)``
    apart), w [H_in, H_out] -> [num_rows, H_out] fp32.  For CUDA tensors it
    stages x in "fast" (``aggregate_sum.stage_plane``'s kernel) and launches
    the forward kernel; for CPU tensors it runs the plain version."""
    if x.device.type == "cpu":
        return aggregate_linear_plain(x, w, row_ptr, col_idx, precision,
                                      activation)
    _check_csr(x, row_ptr, col_idx)
    _check(precision, activation, x, w)
    _require_cuda("aggregate_linear", w, row_ptr, col_idx, rows=(x,))
    _csr_int64("aggregate_linear", row_ptr)
    if w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"w must be [{x.shape[1]}, H_out], got "
                         f"{tuple(w.shape)}")
    n, h_in, h_out = row_ptr.numel() - 1, x.shape[1], w.shape[1]
    out = torch.empty((n, h_out), dtype=torch.float32, device=x.device)
    if n == 0 or h_in == 0 or h_out == 0:
        return out.zero_()
    # W [H_in, ldw], its rows padded to 16 bytes for the GEMM's cp.async
    ldw = _ld(h_out, "exact")
    if ldw != h_out or w.data_ptr() % 16 != 0:
        wp = torch.zeros((h_in, ldw), dtype=torch.float32, device=w.device)
        wp[:, :h_out] = w
        w = wp
    if precision == "fast":
        src = plane_launch(x, "fast", stage_plane)
        ld, vec = src.shape[1], 8
    else:
        src, ld, vec = x, x.stride(0), _vec_width(x)
    LIBRARY.launch(aggregate_linear, "roc_aggregate_linear", x.device,
                   row_ptr.data_ptr(), col_idx.data_ptr(), src.data_ptr(),
                   ld, vec, w.data_ptr(), ldw, out.data_ptr(), n, h_in,
                   h_out, int(precision == "fast"),
                   int(activation == "relu"))
    return out


def _staged_plane(h: int, precision: str, relu: bool):
    """(dtype, row stride) of the staged cotangent plane: bf16 in "fast",
    fp32 in exact with relu, rows padded to 16 bytes; None in exact without
    relu, which gathers g itself."""
    if precision == "fast":
        return torch.bfloat16, -(-h // 8) * 8
    if relu:
        return torch.float32, -(-h // 4) * 4
    return None, h


def stage_cotangent(g: torch.Tensor, y: Optional[torch.Tensor],
                    precision: str = "fast",
                    relu: bool = False) -> torch.Tensor:
    """The staged cotangent plane ``round(g * [y > 0])``: g, y [rows, H]
    fp32 -> [rows, ld] (bf16 in "fast", fp32 in exact with relu; columns
    from H on are 0).  Launches the CUDA kernel for CUDA tensors; for CPU
    tensors it is :func:`stage_cotangent_plain` ([rows, H] fp32).  Exact
    without relu stages nothing: the backward gathers g itself."""
    if g.device.type == "cpu":
        return stage_cotangent_plain(g, y, precision, relu)
    _check(precision, "relu" if relu else "none", g)
    dtype, ld = _staged_plane(g.shape[1], precision, relu)
    if dtype is None:
        raise ValueError("exact without relu has no staged plane")
    if relu and (y is None or y.shape != g.shape or y.dtype != g.dtype):
        raise ValueError("relu needs the saved output y, shaped like g")
    gathered = (g, y) if relu else (g,)
    _require_cuda("stage_cotangent", *gathered)
    rows, h = g.shape
    s = torch.empty((rows, ld), dtype=dtype, device=g.device)
    if rows == 0 or h == 0:
        return s.zero_()
    vec = 4 if h % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in gathered) else 1
    LIBRARY.launch(stage_cotangent, "roc_stage_cotangent", g.device,
                   g.data_ptr(), y.data_ptr() if relu else None,
                   s.data_ptr(), rows, h, ld, int(dtype == torch.bfloat16),
                   int(relu), vec)
    return s


def aggregate_linear_bwd(g: torch.Tensor, y: Optional[torch.Tensor],
                         w: torch.Tensor, t_row_ptr: torch.Tensor,
                         t_col_idx: torch.Tensor, precision: str = "fast",
                         relu: bool = False, need_dx: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's backward over the transposed CSR: g, y [num_rows,
    H_out], w [H_in, H_out] -> (u [table_rows, H_out], dx [table_rows,
    H_in] or None).  For CUDA tensors it stages the cotangent
    (:func:`stage_cotangent`) and launches the backward kernel on the
    staged plane; for CPU tensors it runs the plain version."""
    if g.device.type == "cpu":
        return aggregate_linear_bwd_plain(g, y, w, t_row_ptr, t_col_idx,
                                          precision, relu, need_dx)
    _check_csr(g, t_row_ptr, t_col_idx)
    _check(precision, "relu" if relu else "none", g, w)
    if relu and (y is None or y.shape != g.shape or y.dtype != g.dtype):
        raise ValueError("relu needs the saved output y, shaped like g")
    _require_cuda("aggregate_linear_bwd", g, w, t_row_ptr, t_col_idx)
    _csr_int64("aggregate_linear_bwd", t_row_ptr)
    if w.dim() != 2 or w.shape[1] != g.shape[1]:
        raise ValueError(f"w must be [H_in, {g.shape[1]}], got "
                         f"{tuple(w.shape)}")
    t, h_out, h_in = t_row_ptr.numel() - 1, g.shape[1], w.shape[0]
    u = torch.empty((t, h_out), dtype=torch.float32, device=g.device)
    dx = torch.empty((t, h_in), dtype=torch.float32, device=g.device) \
        if need_dx else None
    if t == 0 or h_out == 0 or h_in == 0:
        return u.zero_(), (dx.zero_() if need_dx else None)
    dtype, ld = _staged_plane(h_out, precision, relu)
    if dtype is None:
        s, vec = g, _vec_width(g)
    else:
        s = stage_cotangent(g, y, precision, relu)
        vec = 8 if dtype == torch.bfloat16 else 4
    # W^T [H_out, ldw], its rows padded to 16 bytes for the GEMM's cp.async
    ldw = -(-h_in // 4) * 4
    if need_dx:
        wt = torch.zeros((h_out, ldw), dtype=torch.float32, device=g.device)
        wt[:, :h_in] = w.t()
    LIBRARY.launch(aggregate_linear_bwd, "roc_aggregate_linear_bwd",
                   g.device, t_row_ptr.data_ptr(), t_col_idx.data_ptr(),
                   s.data_ptr(), ld, int(dtype == torch.bfloat16), vec,
                   wt.data_ptr() if need_dx else None, ldw, u.data_ptr(),
                   dx.data_ptr() if need_dx else None, t, h_out, h_in)
    return u, dx


aggregate_linear.launches = 0
aggregate_linear_bwd.launches = 0
stage_cotangent.launches = 0
