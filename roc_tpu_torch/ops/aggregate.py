"""Sparse neighborhood aggregation (roc_tpu/ops/aggregate.py).

``out[v] = aggr over in-edges (u -> v) of x[u]``, over an in-edge CSR held
on the device with its transpose (:class:`DeviceCsr`).

``sum`` and ``avg`` (sum / in-degree) go through an autograd Function whose
forward is :func:`roc_tpu_torch.ops.kernels.aggregate_sum.aggregate_sum`
(the CUDA kernel for a CUDA tensor, its plain version for a CPU tensor)
and whose backward is the same function over the transposed CSR at the same
precision, as ``_bn_bwd`` runs ``run_binned`` on the transposed plan
(aggregate.py:492-504).  So gradients flow, and take the same path, on
every device.  ``max`` and ``min`` are plain PyTorch only; they are not on
the GCN path.

:func:`scatter_gather_linear` is the whole-layer megakernel
``act((A x) W)`` with its fused backward, the counterpart of
``scatter_gather_linear_binned`` (aggregate.py:522-582).
:func:`region_linear` runs a whole cross-layer fusion region through one
kernel forward and one backward, the counterpart of
``region_linear_binned`` (aggregate.py:611-667), and
:func:`_unfused_region` is its per-layer oracle (aggregate.py:591-608).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from roc_tpu_torch.ops.kernels.aggregate_linear import (
    aggregate_linear, aggregate_linear_bwd, stage_cotangent_plain)
from roc_tpu_torch.ops.kernels.aggregate_sum import (DEFAULT_LAUNCH,
                                                     aggregate_sum,
                                                     aggregate_sum_plain,
                                                     check_precision)
from roc_tpu_torch.ops.kernels.xlayer import xlayer_bwd, xlayer_fwd
from roc_tpu_torch.ops.linear import linear
from roc_tpu_torch.ops.norm import indegree_norm
from roc_tpu_torch.ops.switches import mega_bwd_killed


_CSR_BUILDS = [0]


def note_csr_build() -> None:
    """Count one full placement of a CSR on a device."""
    _CSR_BUILDS[0] += 1


def csr_build_count() -> int:
    """Full CSR placements in this process (``DeviceCsr.from_csr`` and the
    delta manager's buffer fills): a serving engine's cold start places
    one, a delta patch none."""
    return _CSR_BUILDS[0]


def sum_key(h: int) -> str:
    """A launch table's key for the sum kernel at width ``h``."""
    return f"sum/{int(h)}"


def gat_key(k: int, f: int) -> str:
    """A launch table's key for the GAT forward at K heads of F."""
    return f"gat/{int(k)}x{int(f)}"


class LaunchTable(NamedTuple):
    """The autotuner's launch choices for one placed CSR
    (``roc_tpu_torch/tune/``), made once when the CSR is placed.
    ``precision`` is the one they were tuned at; ``fwd`` holds the choices
    over the CSR, ``bwd`` over its transpose, each a dict from
    :func:`sum_key` to the sum kernel's (lanes a row, edges in flight) and
    from :func:`gat_key` to the GAT forward's (lanes, packs).  A kernel,
    width or precision it does not name takes the kernel's own rule."""
    precision: str
    fwd: dict
    bwd: dict


class DeviceCsr(NamedTuple):
    """An in-edge CSR on a device, ``col_idx[row_ptr[v]:row_ptr[v+1]]``
    being v's sources, and its transpose (``t_col_idx[t_row_ptr[u]:
    t_row_ptr[u+1]]`` are u's destinations): aggregating over the
    transpose is the backward of aggregating over the CSR.  A
    forward-only user (serving) places no transpose.  ``t_pos`` maps each
    edge of the CSR to its position in the transpose (edge e, u -> v, is
    transposed edge ``t_pos[e]`` of row u); only the GAT backward reads
    it, so only a user that trains attention places it.  ``launch`` is
    the kernels' launch configuration over this CSR (a
    :class:`LaunchTable`, the tuned store's entry for this graph), None
    for the kernels' own rule: per-part CSRs (``-parts``, ``-stream``)
    have their own content and keep the rule."""
    row_ptr: torch.Tensor                       # [N+1] int64
    col_idx: torch.Tensor                       # [E] int32
    t_row_ptr: Optional[torch.Tensor] = None    # [T+1] int64
    t_col_idx: Optional[torch.Tensor] = None    # [E] int32
    t_pos: Optional[torch.Tensor] = None        # [E] int32
    launch: Optional[LaunchTable] = None

    @classmethod
    def from_csr(cls, csr, device, transpose: bool = True,
                 edge_map: bool = False,
                 launch: Optional[LaunchTable] = None) -> "DeviceCsr":
        """A host ``Csr`` on ``device``, with its transpose (built once,
        by ``Csr.transpose()``) unless ``transpose`` is False, and with the
        edge map ``t_pos`` (the inverse of the stable argsort of
        ``col_idx``, which ``Csr.transpose_with_order()`` computes with the
        transpose: one native counting sort on a big graph) when
        ``edge_map`` is True, carrying ``launch``."""
        if edge_map and not transpose:
            raise ValueError("the edge map belongs to the transpose: "
                             "edge_map=True needs transpose=True")
        arrays = [(csr.row_ptr, np.int64), (csr.col_idx, np.int32)]
        if transpose:
            if edge_map:
                t, order = csr.transpose_with_order()
            else:
                t = csr.transpose()
            arrays += [(t.row_ptr, np.int64), (t.col_idx, np.int32)]
            if edge_map:
                t_pos = np.empty(order.size, np.int32)
                t_pos[order] = np.arange(order.size, dtype=np.int32)
                arrays.append((t_pos, np.int32))
        note_csr_build()
        return cls(*(torch.as_tensor(np.asarray(a, dt), device=device)
                     for a, dt in arrays), launch=launch)

    @property
    def num_rows(self) -> int:
        return self.row_ptr.numel() - 1

    def tensors(self) -> list:
        """The placed tensors (the fields that are not None or the launch
        table)."""
        return [t for t in self[:5] if t is not None]

    def sum_launch(self, transposed: bool, h: int, precision: str,
                   dtype: torch.dtype = torch.float32) -> tuple:
        """The sum kernel's (lanes a row, edges in flight) at width ``h``
        over this CSR (or, ``transposed``, its transpose): the launch
        table's, or ``DEFAULT_LAUNCH`` (a bf16 x is summed by its own
        kernel, which takes none)."""
        t = self.launch
        if t is None or dtype != torch.float32 or precision != t.precision:
            return DEFAULT_LAUNCH
        return tuple((t.bwd if transposed else t.fwd).get(
            sum_key(h), DEFAULT_LAUNCH))

    def gat_groups(self, k: int, f: int, precision: str):
        """The GAT forward's lane-group table at K heads of F (one tuned
        pair), or None for ``ops.kernels.gat.FWD_GROUPS``."""
        t = self.launch
        if t is None or precision != t.precision:
            return None
        pair = t.fwd.get(gat_key(k, f))
        return None if pair is None else (tuple(pair),)

    def transposed(self):
        """``(t_row_ptr, t_col_idx)``; raises for a forward-only CSR."""
        if self.t_row_ptr is None:
            raise RuntimeError("this CSR was placed without its transpose "
                               "(forward only): a backward needs "
                               "DeviceCsr.from_csr(..., transpose=True)")
        return self.t_row_ptr, self.t_col_idx

    def edge_map(self) -> torch.Tensor:
        """``t_pos``; raises for a CSR placed without it."""
        if self.t_pos is None:
            raise RuntimeError("this CSR was placed without its edge map "
                               "into the transpose: the GAT backward needs "
                               "DeviceCsr.from_csr(..., edge_map=True)")
        return self.t_pos


class _AggregateSum(torch.autograd.Function):
    """Sum over in-edges; the backward sums the cotangent over the
    transposed CSR with the same function and precision (so in "fast" the
    cotangent takes one bf16 rounding, as in the JAX package)."""

    @staticmethod
    def forward(ctx, x, csr, precision, sum_fn):
        ctx.csr, ctx.precision, ctx.sum_fn = csr, precision, sum_fn
        return sum_fn(x, csr.row_ptr, csr.col_idx, precision,
                      csr.sum_launch(False, x.shape[1], precision, x.dtype))

    @staticmethod
    def backward(ctx, g):
        csr = ctx.csr
        gx = ctx.sum_fn(g.contiguous(), *csr.transposed(), ctx.precision,
                        csr.sum_launch(True, g.shape[1], ctx.precision,
                                       g.dtype))
        return gx, None, None, None


class _AggregateLinear(torch.autograd.Function):
    """``act((A x) W)`` through the forward megakernel; the backward runs
    the backward megakernel (``u = A^T (g * [out > 0])``, ``dx = u W^T``)
    and ``dW = x^T u`` as one fp32 GEMM, as aggregate.py:560-574 does.
    Under ``ROC_MEGA_BWD=0`` (``ops.switches.mega_bwd_killed``) the
    backward replays the composition instead: the staged cotangent
    (``stage_cotangent_plain``), its sum over the transpose in fp32
    (``aggregate_sum``) and ``dx = u W^T``, the same bits."""

    @staticmethod
    def forward(ctx, x, w, csr, precision, activation):
        out = aggregate_linear(x, w, csr.row_ptr, csr.col_idx, precision,
                               activation)
        ctx.save_for_backward(x, w, out)
        ctx.csr, ctx.precision, ctx.relu = csr, precision, \
            activation == "relu"
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        if mega_bwd_killed():
            s = stage_cotangent_plain(g.contiguous(), out, ctx.precision,
                                      ctx.relu)
            u = aggregate_sum(s, *ctx.csr.transposed(), "exact",
                              ctx.csr.sum_launch(True, s.shape[1], "exact"))
            dx = linear(u, w.t()) if ctx.needs_input_grad[0] else None
        else:
            u, dx = aggregate_linear_bwd(
                g.contiguous(), out, w, *ctx.csr.transposed(),
                ctx.precision, ctx.relu, need_dx=ctx.needs_input_grad[0])
        dw = linear(x.t(), u) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None


def divide_by_degree(out: torch.Tensor,
                     in_degree: torch.Tensor) -> torch.Tensor:
    """avg from a sum: out / max(in_degree, 1), divided in fp32 and cast
    back (a bf16 degree would round counts above 256)."""
    deg = torch.clamp_min(in_degree.to(torch.float32), 1.0)
    return (out.to(torch.float32) / deg[:, None]).to(out.dtype)


def _segment_extreme(x: torch.Tensor, csr: DeviceCsr, aggr: str,
                     zero_empty: bool = True) -> torch.Tensor:
    """Segment max/min; rows with no in-edges are 0, not the ±inf identity,
    which would poison a later linear layer (aggregate.py:110-116).
    ``zero_empty`` False keeps the identity (the ring folds several owner
    groups before it zeroes the rows no group reached).

    The destination starts at the identity, not at 0: torch's backward of
    ``scatter_reduce_`` counts the destination's starting value among the
    ties even with ``include_self=False``, so a zero fill would take a
    share of the gradient wherever a row's extreme is exactly 0.  The rows
    that kept the identity are zeroed after the reduction (genuine NaNs
    stay visible), as roc_tpu zeroes ``jnp.isneginf``/``isposinf``."""
    n = csr.num_rows
    dst = torch.repeat_interleave(
        torch.arange(n, device=x.device), torch.diff(csr.row_ptr))
    ident = float("-inf") if aggr == "max" else float("inf")
    out = torch.full((n, x.shape[1]), ident, dtype=x.dtype, device=x.device)
    src = x.index_select(0, csr.col_idx)
    out = out.scatter_reduce(0, dst[:, None].expand_as(src), src,
                             "amax" if aggr == "max" else "amin",
                             include_self=False)
    if not zero_empty:
        return out
    empty = torch.isneginf(out) if aggr == "max" else torch.isposinf(out)
    return torch.where(empty, torch.zeros_like(out), out)


def _aggregate(sum_fn, x, csr, aggr, precision):
    check_precision(precision, x.dtype)
    if aggr in ("sum", "avg"):
        out = _AggregateSum.apply(x, csr, precision, sum_fn)
        if aggr == "avg":
            out = divide_by_degree(out, torch.diff(csr.row_ptr))
        return out
    if aggr in ("max", "min"):
        return _segment_extreme(x, csr, aggr)
    raise ValueError(f"unknown aggr {aggr!r}")


def scatter_gather(x: torch.Tensor, csr: DeviceCsr, aggr: str = "sum",
                   precision: str = "fast") -> torch.Tensor:
    """out[v] = aggr over in-edges of x[src]; x is [table_rows, H].

    ``precision`` applies to sum and avg ("fast": one bf16 rounding of
    features with fp32 accumulation; "exact": fp32); unknown strings raise.
    """
    return _aggregate(aggregate_sum, x, csr, aggr, precision)


def scatter_gather_plain(x: torch.Tensor, csr: DeviceCsr, aggr: str = "sum",
                         precision: str = "exact") -> torch.Tensor:
    """The plain version of :func:`scatter_gather` on any device (the
    ``xla`` backend's counterpart: fp32 unless asked otherwise)."""
    return _aggregate(aggregate_sum_plain, x, csr, aggr, precision)


def scatter_gather_linear(x: torch.Tensor, w: torch.Tensor, csr: DeviceCsr,
                          precision: str = "fast",
                          activation: str = "none") -> torch.Tensor:
    """``act(sum-aggregate(x) @ w)`` for act in {none, relu}, through the
    megakernel on CUDA (its plain version on the CPU); differentiable in x
    and w.  The ``[rows, H_in]`` aggregate never reaches device memory."""
    return _AggregateLinear.apply(x, w, csr, precision, activation)


class _RegionLinear(torch.autograd.Function):
    """A fusion region through the region forward kernel; the backward is
    one launch of the region backward kernel, which replays the interior
    planes and returns dx and every dW.  Saves the region's input, its
    weights and its output only: the interior boundaries are never kept.
    ``in_degree`` is graph structure and takes no gradient."""

    @staticmethod
    def forward(ctx, x, in_degree, csr, precision, activations, fold, *ws):
        scale = torch.rsqrt(in_degree) if fold else None
        out = xlayer_fwd(x, ws, scale, csr.row_ptr, csr.col_idx, precision,
                         activations)
        ctx.save_for_backward(x, out, *ws)
        ctx.csr, ctx.in_degree, ctx.precision, ctx.activations, ctx.fold = \
            csr, in_degree, precision, activations, fold
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, *ws = ctx.saved_tensors
        scale = torch.rsqrt(ctx.in_degree) if ctx.fold else None
        dx, dws = xlayer_bwd(
            g.contiguous(), out, x, ws, scale, ctx.csr.row_ptr,
            ctx.csr.col_idx, *ctx.csr.transposed(), ctx.precision,
            ctx.activations, need_dx=ctx.needs_input_grad[0])
        return (dx, None, None, None, None, None, *dws)


def region_linear(x: torch.Tensor, ws: Sequence[torch.Tensor],
                  in_degree: torch.Tensor, csr: DeviceCsr,
                  precision: str = "fast", activations: Sequence[str] = (),
                  fold: bool = False) -> torch.Tensor:
    """A whole fusion region, ``act_D(A ... act_1((A x) W_1) ... W_D)``,
    through the region kernels on CUDA (their plain versions on the CPU);
    differentiable in x and every w.  ``fold`` applies GCN's norm pair
    (D^-1/2 twice) at each interior boundary; the caller owns the head's
    pre-scale and the tail's post-scale, as for the per-layer hook."""
    return _RegionLinear.apply(x, in_degree, csr, precision,
                               tuple(activations), fold, *ws)


def _unfused_region(x: torch.Tensor, ws: Sequence[torch.Tensor],
                    in_degree: torch.Tensor, csr: DeviceCsr,
                    precision: str = "fast", activations: Sequence[str] = (),
                    fold: bool = False) -> torch.Tensor:
    """The per-layer composition the region kernels must match: the
    megakernel per member, with GCN's folded norm pair (layer l's post-scale
    and layer l+1's pre-scale) between members."""
    h = x
    for d, (w, act) in enumerate(zip(ws, activations)):
        h = scatter_gather_linear(h, w, csr, precision, act)
        if fold and d + 1 < len(ws):
            h = indegree_norm(indegree_norm(h, in_degree), in_degree)
    return h
