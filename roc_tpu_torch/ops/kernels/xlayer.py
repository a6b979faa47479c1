"""Cross-layer fusion region: the two CUDA kernels, their loader and their
plain versions.

A region is a chain of D >= 2 layers ``aggregate -> linear (-> relu)``
over one square CSR (the same N rows are the table and the destinations).
Layers are numbered 0 .. D-1; layer l maps width ``H_l`` to ``H_{l+1}``
with ``ws[l]`` [H_l, H_{l+1}].

``xlayer_fwd(x, ws, scale, row_ptr, col_idx, precision, activations)``
computes ``act_{D-1}(A ... act_0((A x) W_0) ... W_{D-1})``.  On an interior
layer the epilogue is the activation, then ``(v * scale) * scale`` per row
when ``scale`` is given (GCN's norm pair between two layers: the caller
passes ``torch.rsqrt(in_degree)``, the multiplier ``ops.indegree_norm``
applies); the last layer's epilogue is its activation alone.  It is the
function of the JAX package's ``roc_tpu/ops/pallas/binned.py:
run_binned_region`` (``_xlayer_kernel``).

``xlayer_bwd(g, y, x, ws, scale, row_ptr, col_idx, t_row_ptr, t_col_idx,
precision, activations, need_dx)`` returns ``(dx, (dW_0, ..., dW_{D-1}))``
given the output cotangent g and the saved output y, as
``run_binned_region_bwd`` (``_xlayer_bwd_kernel``) does: the interior
planes are replayed, never saved; then, last layer first, the staged
cotangent (``g * [y > 0]``, or the handed-off one times the scale twice and
masked by the replayed plane ``> 0``) is summed over the transposed CSR into
``u``, ``dW_l = z_l^T u`` (``z_l`` the replayed input plane, x at l = 0) and
``u W_l^T`` is handed to the next layer down (dx at l = 0, None unless
``need_dx``).

Precision as the megakernel's: "fast" rounds each gathered element once to
bf16 and sums in fp32; "exact" is fp32 throughout; every GEMM is fp32 (no
TF32).  On the card the "fast" rounding is done once per source row, where
the element is formed (x staged to a padded bf16 plane, bf16 interior
planes, the staged cotangent written by the hand-off GEMM's epilogue), not
once per edge: ``stage_plain`` and ``handoff_plain`` are the plain twins of
those steps, for the tests (nothing on the card's path calls them).  On a
CUDA tensor each wrapper launches its kernel from ``csrc/xlayer.cu`` (one
cooperative launch per call) or raises; on a CPU tensor it runs the plain
version.  ``xlayer_fwd.launches`` and ``xlayer_bwd.launches`` count kernel
launches; ``.grid`` holds the last launch's grid size.  ``phases`` names
the phases of a launch, whose split a caller can take with ``stamps``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from roc_tpu_torch.ops.kernels.aggregate_sum import (_check_csr, _ld,
                                                     aggregate_sum_plain,
                                                     check_precision,
                                                     stage_plain)
from roc_tpu_torch.ops.kernels.build import (CudaLibrary, _csr_int64,
                                             _require_cuda)
from roc_tpu_torch.ops.linear import linear

MAX_DEPTH = 8     # kMaxDepth in csrc/xlayer.cu


def _bind(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    pp, pi, pll = (ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(i),
                   ctypes.POINTER(ll))
    fwd = lib.roc_xlayer_fwd
    fwd.argtypes = [p, p, p, p, pp, p, pi, pll, i, ll, p, pp, p, p, i, p, pi]
    fwd.restype = i
    bwd = lib.roc_xlayer_bwd
    bwd.argtypes = [p, p, p, p, p, p, pp, pp, p, pi, pll, i, ll, p, p, pp,
                    pp, pp, p, p, pp, p, p, p, i, p, pi]
    bwd.restype = i
    size = lib.roc_xlayer_partial_floats
    size.argtypes = [ll, pll, i]
    size.restype = ll


LIBRARY = CudaLibrary("xlayer.cu", _bind)


def phases(depth: int, backward: bool, precision: str = "fast") -> list:
    """The names of a region kernel's phases, in the order it runs them:
    the grid syncs of ``csrc/xlayer.cu`` cut the launch into these, and a
    call given ``stamps`` writes one ``%globaltimer`` stamp (ns) at the
    start and one after each phase.  "stage" writes the staged x (fast) and,
    backward, the last layer's staged cotangent; "layer{l}" and
    "replay{l}" are forward sweeps, "sweep{l}" the transposed sweep of
    layer l with its hand-off GEMM, then dW_l's partials and reduction."""
    if not backward:
        head = ["stage"] if precision == "fast" else []
        return head + [f"layer{l}" for l in range(depth)]
    out = ["stage"] + [f"replay{l}" for l in range(depth - 1)]
    for l in reversed(range(depth)):
        out += [f"sweep{l}", f"dw_partials{l}", f"dw_reduce{l}"]
    return out


def handoff_plain(v: torch.Tensor, scale: Optional[torch.Tensor],
                  mask: Optional[torch.Tensor],
                  precision: str = "fast") -> torch.Tensor:
    """The hand-off GEMM's epilogue as plain PyTorch: from ``v = u_l
    W_l^T``, the staged cotangent of layer l-1, ``((v * s) * s) * [P_{l-1} >
    0]`` (the scale when given, the mask with layer l-1's relu), stored as
    ``stage_plain`` stores it."""
    return stage_plain(_scaled(v, scale), mask, precision)


def _stamps_ptr(stamps: Optional[torch.Tensor], depth: int,
                backward: bool, precision: str):
    if stamps is None:
        return None
    want = len(phases(depth, backward, precision)) + 1
    if (stamps.dtype != torch.int64 or stamps.device.type != "cuda"
            or not stamps.is_contiguous() or stamps.numel() < want):
        raise ValueError(f"stamps must be a contiguous CUDA int64 tensor of "
                         f"at least {want} entries")
    return stamps.data_ptr()


def _check_region(x: torch.Tensor, ws: Sequence[torch.Tensor],
                  scale: Optional[torch.Tensor], row_ptr: torch.Tensor,
                  col_idx: torch.Tensor, precision: str,
                  activations: Sequence[str]) -> list:
    """Validate a region's inputs; returns its width chain H_0 .. H_D."""
    _check_csr(x, row_ptr, col_idx)
    check_precision(precision, torch.float32)
    depth = len(ws)
    if not 2 <= depth <= MAX_DEPTH:
        raise ValueError(f"a region has 2 to {MAX_DEPTH} layers, got {depth}")
    if len(activations) != depth or any(a not in ("none", "relu")
                                        for a in activations):
        raise ValueError(f"activations={tuple(activations)!r}: one of "
                         f"'none' or 'relu' per layer")
    n = row_ptr.numel() - 1
    if x.shape[0] != n:
        raise ValueError(f"a region is square: x has {x.shape[0]} rows, the "
                         f"CSR {n}")
    widths = [x.shape[1]]
    for w in ws:
        if w.dim() != 2 or w.shape[0] != widths[-1]:
            raise ValueError(f"weight chain breaks at {tuple(w.shape)} "
                             f"after width {widths[-1]}")
        widths.append(w.shape[1])
    if scale is not None and tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be [{n}], got {tuple(scale.shape)}")
    for t in (x, *ws, *(() if scale is None else (scale,))):
        if t.dtype != torch.float32:
            raise ValueError(f"the region kernels take float32 tensors, got "
                             f"{t.dtype}")
    return widths


def _scaled(h: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The interior epilogue's norm pair, (h * s) * s per row."""
    if scale is None:
        return h
    s = scale[:, None]
    return (h * s) * s


def xlayer_fwd_plain(x: torch.Tensor, ws: Sequence[torch.Tensor],
                     scale: Optional[torch.Tensor], row_ptr: torch.Tensor,
                     col_idx: torch.Tensor, precision: str = "fast",
                     activations: Sequence[str] = ()) -> torch.Tensor:
    """The plain forward on any device: the per-layer chain, the chunked
    aggregation at the given precision, ``ops.linear`` with the layer's
    activation, and the interior norm pair."""
    _check_region(x, ws, scale, row_ptr, col_idx, precision, activations)
    h = x
    for l, (w, act) in enumerate(zip(ws, activations)):
        h = linear(aggregate_sum_plain(h, row_ptr, col_idx, precision), w,
                   act)
        if l + 1 < len(ws):
            h = _scaled(h, scale)
    return h


def xlayer_bwd_plain(g: torch.Tensor, y: Optional[torch.Tensor],
                     x: torch.Tensor, ws: Sequence[torch.Tensor],
                     scale: Optional[torch.Tensor], row_ptr: torch.Tensor,
                     col_idx: torch.Tensor, t_row_ptr: torch.Tensor,
                     t_col_idx: torch.Tensor, precision: str = "fast",
                     activations: Sequence[str] = (), need_dx: bool = True
                     ) -> Tuple[Optional[torch.Tensor], Tuple[torch.Tensor,
                                                              ...]]:
    """The plain backward, step by step as the kernel runs it: replay the
    interior planes, then per layer from the last the staged cotangent,
    ``u`` over the transposed CSR, ``dW = z^T u`` and the hand-off
    ``u W^T``."""
    _check_region(x, ws, scale, row_ptr, col_idx, precision, activations)
    depth = len(ws)
    relu = [a == "relu" for a in activations]
    if relu[-1] and (y is None or y.shape != g.shape):
        raise ValueError("a last relu needs the saved output y, shaped "
                         "like g")
    planes = []
    h = x
    for l in range(depth - 1):
        h = _scaled(linear(aggregate_sum_plain(h, row_ptr, col_idx,
                                               precision), ws[l],
                           activations[l]), scale)
        planes.append(h)
    dws = [None] * depth
    c = g
    for l in reversed(range(depth)):
        if l == depth - 1:
            staged, mask = c, y
        else:
            staged, mask = _scaled(c, scale), planes[l]
        if relu[l]:
            staged = torch.where(mask > 0, staged, torch.zeros_like(staged))
        u = aggregate_sum_plain(staged, t_row_ptr, t_col_idx, precision)
        dws[l] = linear((x if l == 0 else planes[l - 1]).t(), u)
        c = linear(u, ws[l].t()) if l > 0 or need_dx else None
    return c, tuple(dws)


def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _ints(vals) -> ctypes.Array:
    return (ctypes.c_int * len(vals))(*vals)


def _longs(vals) -> ctypes.Array:
    return (ctypes.c_longlong * len(vals))(*vals)


def _cuda_inputs(name, x, ws, scale, row_ptr, col_idx, *more) -> None:
    _require_cuda(name, x, *ws, row_ptr, col_idx, *more,
                  *(() if scale is None else (scale,)))
    _csr_int64(name, row_ptr)


def xlayer_fwd(x: torch.Tensor, ws: Sequence[torch.Tensor],
               scale: Optional[torch.Tensor], row_ptr: torch.Tensor,
               col_idx: torch.Tensor, precision: str = "fast",
               activations: Sequence[str] = (),
               stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The region forward: x [N, H_0] -> [N, H_D] fp32.  Launches the CUDA
    kernel for CUDA tensors, runs the plain version for CPU tensors.
    ``stamps`` (CUDA int64, ``len(phases(D, False, precision)) + 1``
    entries, or None) takes the phase split of the launch."""
    if x.device.type == "cpu":
        return xlayer_fwd_plain(x, ws, scale, row_ptr, col_idx, precision,
                                activations)
    widths = _check_region(x, ws, scale, row_ptr, col_idx, precision,
                           activations)
    _cuda_inputs("xlayer_fwd", x, ws, scale, row_ptr, col_idx)
    return _fwd_launch(x, ws, scale, row_ptr, col_idx, precision,
                       activations, stamps, widths)


def _padded(w: torch.Tensor) -> torch.Tensor:
    """A weight with its rows padded to a multiple of 4 columns (16-byte
    rows for the kernels' cp.async copies)."""
    k, h = w.shape
    ld = _ld(h, "exact")
    if ld == h:
        return w.contiguous()
    out = torch.zeros((k, ld), dtype=w.dtype, device=w.device)
    out[:, :h] = w
    return out


def _staged_x(x: torch.Tensor, precision: str) -> Optional[torch.Tensor]:
    """The staged x's workspace: bf16 [N, ld8(H_0)] in fast."""
    if precision != "fast":
        return None
    return torch.empty((x.shape[0], _ld(x.shape[1], "fast")),
                       dtype=torch.bfloat16, device=x.device)


def _fwd_launch(x, ws, scale, row_ptr, col_idx, precision, activations,
                stamps, widths) -> torch.Tensor:
    n, depth, dev = row_ptr.numel() - 1, len(ws), x.device
    fast = precision == "fast"
    out = torch.empty((n, widths[-1]), dtype=torch.float32, device=dev)
    # the interior planes, as the next layer gathers them: one at depth 2, a
    # ping-pong beyond
    planes = [torch.empty(n * _ld(max(widths[1:-1]), precision),
                          dtype=torch.bfloat16 if fast else torch.float32,
                          device=dev) for _ in range(1 if depth == 2 else 2)]
    xs = _staged_x(x, precision)
    wp = [_padded(w) for w in ws]       # alive until the launch is queued
    counter = torch.zeros(depth, dtype=torch.int32, device=dev)
    grid = ctypes.c_int(0)
    LIBRARY.launch(
        xlayer_fwd, "roc_xlayer_fwd", dev, row_ptr.data_ptr(),
        col_idx.data_ptr(), x.data_ptr(),
        None if xs is None else xs.data_ptr(), _ptrs(wp),
        None if scale is None else scale.data_ptr(),
        _ints([a == "relu" for a in activations]), _longs(widths), depth, n,
        out.data_ptr(), _ptrs(planes + planes[:1]), counter.data_ptr(),
        _stamps_ptr(stamps, depth, False, precision), int(fast),
        tail=(ctypes.byref(grid),))
    xlayer_fwd.grid = grid.value
    return out


def xlayer_bwd(g: torch.Tensor, y: Optional[torch.Tensor], x: torch.Tensor,
               ws: Sequence[torch.Tensor], scale: Optional[torch.Tensor],
               row_ptr: torch.Tensor, col_idx: torch.Tensor,
               t_row_ptr: torch.Tensor, t_col_idx: torch.Tensor,
               precision: str = "fast", activations: Sequence[str] = (),
               need_dx: bool = True, stamps: Optional[torch.Tensor] = None
               ) -> Tuple[Optional[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """The region backward: ``(dx [N, H_0] or None, (dW_0, ..., dW_{D-1}))``.
    Launches the CUDA kernel for CUDA tensors, runs the plain version for
    CPU tensors.  ``stamps`` as in :func:`xlayer_fwd`, with
    ``len(phases(D, True, precision)) + 1`` entries."""
    if g.device.type == "cpu":
        return xlayer_bwd_plain(g, y, x, ws, scale, row_ptr, col_idx,
                                t_row_ptr, t_col_idx, precision, activations,
                                need_dx)
    widths = _check_region(x, ws, scale, row_ptr, col_idx, precision,
                           activations)
    relu = [a == "relu" for a in activations]
    n, depth, dev = row_ptr.numel() - 1, len(ws), x.device
    if tuple(g.shape) != (n, widths[-1]):
        raise ValueError(f"g must be [{n}, {widths[-1]}], got "
                         f"{tuple(g.shape)}")
    if relu[-1] and (y is None or y.shape != g.shape
                     or y.dtype != torch.float32):
        raise ValueError("a last relu needs the saved output y, shaped "
                         "like g")
    _check_csr(g, t_row_ptr, t_col_idx)
    if t_row_ptr.numel() - 1 != n:
        raise ValueError("the transposed CSR must have the region's rows")
    _cuda_inputs("xlayer_bwd", x, ws, scale, row_ptr, col_idx, g,
                 t_row_ptr, t_col_idx, *((y,) if relu[-1] else ()))
    _csr_int64("xlayer_bwd", t_row_ptr)
    return _bwd_launch(g, y, x, ws, scale, row_ptr, col_idx, t_row_ptr,
                       t_col_idx, precision, relu, need_dx, stamps, widths)


def _bwd_launch(g, y, x, ws, scale, row_ptr, col_idx, t_row_ptr, t_col_idx,
                precision, relu, need_dx, stamps, widths):
    n, depth, dev = row_ptr.numel() - 1, len(ws), x.device
    fast = precision == "fast"
    f32 = dict(dtype=torch.float32, device=dev)
    low = dict(dtype=torch.bfloat16 if fast else torch.float32, device=dev)
    dws = [torch.empty(tuple(w.shape), **f32) for w in ws]
    dx = torch.empty((n, widths[0]), **f32) if need_dx else None
    # the replayed planes P_0 .. P_{D-2}, fp32 (dW and the masks read them)
    rplanes = [torch.empty((n, _ld(h, "exact")), **f32)
               for h in widths[1:-1]]
    # fast: the bf16 shadow of each replayed plane the next replay gathers
    shadow = ([torch.empty(n * _ld(max(widths[1:-2]), "fast"), **low)
               for _ in range(1 if depth == 3 else 2)]
              if fast and depth > 2 else [])
    # the staged cotangents, as the transposed sweeps gather them
    stg = [torch.empty(n * _ld(max(widths[1:]), precision), **low)
           for _ in range(2)]
    u = torch.empty(n * _ld(max(widths[1:]), "exact"), **f32)
    partial = torch.empty(LIBRARY.load().roc_xlayer_partial_floats(
        n, _longs(widths), depth), **f32)
    xs = _staged_x(x, precision)
    wp = [_padded(w) for w in ws]       # alive until the launch is queued
    wtp = [_padded(w.t()) for w in ws]
    counter = torch.zeros(2 * depth - 1, dtype=torch.int32, device=dev)
    grid = ctypes.c_int(0)
    LIBRARY.launch(
        xlayer_bwd, "roc_xlayer_bwd", dev, row_ptr.data_ptr(),
        col_idx.data_ptr(), t_row_ptr.data_ptr(), t_col_idx.data_ptr(),
        x.data_ptr(), None if xs is None else xs.data_ptr(), _ptrs(wp),
        _ptrs(wtp), None if scale is None else scale.data_ptr(),
        _ints(relu), _longs(widths), depth, n, g.data_ptr(),
        y.data_ptr() if relu[-1] else None, _ptrs(rplanes),
        _ptrs(shadow + shadow[:1]) if shadow else None, _ptrs(stg),
        u.data_ptr(), partial.data_ptr(), _ptrs(dws),
        None if dx is None else dx.data_ptr(), counter.data_ptr(),
        _stamps_ptr(stamps, depth, True, precision), int(fast),
        tail=(ctypes.byref(grid),))
    xlayer_bwd.grid = grid.value
    return dx, tuple(dws)


xlayer_fwd.launches = 0
xlayer_fwd.grid = 0
xlayer_bwd.launches = 0
xlayer_bwd.grid = 0
