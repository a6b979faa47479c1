"""Edge softmax and graph attention (roc_tpu/ops/edge.py).

``h`` is [N, K, F] (the W-projected destination features), ``table`` the
[T, K, F] source table (``h`` itself on one device), ``a_src``/``a_dst``
[K, F].  Per edge (u -> v): ``s = lrelu(a_dst . h[v] + a_src . table[u])``;
``alpha = edge_softmax(s)`` over v's in-edges; ``out[v] = sum alpha
table[u]``.  Returns [N, K, F].

Two implementations, selected by the graph data's backend:

  gat_attend         the plain fp32 composition (gathers, a segment max,
                     ``index_add_``), differentiated by autograd: the
                     counterpart of the JAX package's ``xla`` attention.
                     It materializes [E, K, F]: small graphs only.
  gat_attend_kernel  an autograd Function, the counterpart of
                     ``gat_attend_binned`` / ``gat_attend_plan``: its forward
                     runs ``ops.kernels.gat``'s score and forward kernels and
                     saves m and z; its backward runs ``gat_bwd_src``
                     (dtable, dast and the per-edge score gradient dq),
                     then ``gat_bwd_dst`` (dq's sum per destination), and
                     the oracle's epilogue (edge.py:636-639).  On the CPU
                     the same Function runs the kernels' plain twins in the
                     same order.  The forward takes the CSR's tuned lane
                     group (``DeviceCsr.gat_groups``).  ``ROC_NO_GATFUSE=1``
                     sends it to ``gat_attend``; under ``ROC_GAT_BWD=0``
                     its backward runs the plain twins on every device
                     (``ops/switches.py``).  Its forward runs in a
                     ``gat_attend`` span, its backward in ``gat_attend_bwd``
                     (arguments heads, head_dim, rows, edges, precision;
                     the backward's also ``src_lanes``, the src kernel's
                     lane group, where the kernels' backward runs).

The JAX package's ``GatPlans``, ``build_gat_plans``, ``_plan_sum``,
``_plan_max`` and ``_edge_contract`` are TPU schedules (host-built chunk
plans that keep every segment reduction off the TPU's scatter path).  They
are not ported: the CSR and its transpose take their place.
"""

from __future__ import annotations

import torch

from roc_tpu_torch.obs.tracer import span
from roc_tpu_torch.ops.aggregate import DeviceCsr
from roc_tpu_torch.ops.kernels.aggregate_sum import check_precision
from roc_tpu_torch.ops.kernels.gat import Z_GUARD as _Z_GUARD
from roc_tpu_torch.ops.kernels.gat import (_lrelu, gat_bwd_dst, gat_bwd_src,
                                           gat_bwd_src_dq_plain,
                                           gat_dadl_plain, gat_forward,
                                           gat_score, src_geometry)
from roc_tpu_torch.ops.switches import gat_bwd_killed, gat_fuse_killed

# The gathered [E, K, F] bound above which the JAX package chunks its
# composition (aggregate.py:43); the port's plain composition refuses it.
_PLAIN_MAX_ELEMS = 1 << 28


def edge_softmax(scores: torch.Tensor, edge_dst: torch.Tensor,
                 num_nodes: int) -> torch.Tensor:
    """Per-destination softmax over in-edges: scores [E, ...], edge_dst [E]
    sorted ascending; the alphas of each destination with in-edges sum to 1.
    The max shift carries no gradient (softmax is shift-invariant)."""
    trail = scores.shape[1:]
    idx = edge_dst.long().view(-1, *([1] * len(trail))).expand_as(scores)
    m = torch.full((num_nodes, *trail), float("-inf"), dtype=scores.dtype,
                   device=scores.device)
    m = m.scatter_reduce(0, idx, scores.detach(), "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m[edge_dst.long()])
    s = torch.zeros_like(m).index_add(0, edge_dst.long(), e)
    return e / torch.clamp_min(s[edge_dst.long()], _Z_GUARD)


def gat_attend(h, table, edge_src, edge_dst, num_nodes: int, a_src, a_dst,
               slope: float) -> torch.Tensor:
    """Multi-head GAT aggregation, the plain fp32 composition (autograd
    differentiates it; lrelu's derivative at 0 is 1, as in JAX)."""
    e_count, (k, f) = edge_src.shape[0], h.shape[1:]
    if e_count * k * f > _PLAIN_MAX_ELEMS:
        raise ValueError(f"gat_attend gathers [E, K, F] = [{e_count}, {k}, "
                         f"{f}]: too large for the plain composition; use "
                         f"the kernel backend")
    src, dst = edge_src.long(), edge_dst.long()
    as_t = torch.einsum("tkf,kf->tk", table, a_src)
    ad_l = torch.einsum("nkf,kf->nk", h, a_dst)
    alpha = edge_softmax(_lrelu(ad_l[dst] + as_t[src], slope), dst,
                         num_nodes)
    out = torch.zeros((num_nodes, k, f), dtype=h.dtype, device=h.device)
    return out.index_add(0, dst, table[src] * alpha[:, :, None])


def _span_args(h: torch.Tensor, csr: DeviceCsr, precision: str) -> dict:
    """The attention spans' arguments: the layer's shape and precision."""
    n, k, f = h.shape
    return {"heads": k, "head_dim": f, "rows": n,
            "edges": csr.col_idx.numel(), "precision": precision}


class _GatAttend(torch.autograd.Function):
    """The attention layer through the GAT kernels, with the oracle's
    hand-derived backward (edge.py:471-494)."""

    @staticmethod
    def forward(ctx, h, table, a_src, a_dst, csr, slope, precision):
        n, k, f = h.shape
        with span("gat_attend", **_span_args(h, csr, precision)):
            x = table.reshape(table.shape[0], k * f).contiguous()
            as_t = gat_score(x, a_src.contiguous())
            ad_l = torch.einsum("nkf,kf->nk", h, a_dst).contiguous()
            out, m, z = gat_forward(x, as_t, ad_l, csr.row_ptr, csr.col_idx,
                                    slope, precision,
                                    csr.gat_groups(k, f, precision))
            out = out.view(n, k, f)
        ctx.save_for_backward(h, x, a_src, a_dst, as_t, ad_l, m, z, out)
        ctx.csr, ctx.slope, ctx.precision = csr, slope, precision
        return out

    @staticmethod
    def backward(ctx, g):
        h, x, a_src, a_dst, as_t, ad_l, m, z, out = ctx.saved_tensors
        csr, slope, precision = ctx.csr, ctx.slope, ctx.precision
        n, k, f = h.shape
        with span("gat_attend_bwd", **_span_args(h, csr, precision)) as sp:
            torch.backends.cuda.matmul.allow_tf32 = False
            zc = torch.clamp_min(z, _Z_GUARD)
            du = (g / zc[:, :, None]).reshape(n, k * f).contiguous()
            dz = (-(g * out).sum(-1) / zc).contiguous()
            # dq once per edge (src kernel, transposed order), then its
            # sum over each destination's in-edges (dst kernel), as
            # edge.py:478-482
            src_fn, dst_fn = ((gat_bwd_src_dq_plain, gat_dadl_plain)
                              if gat_bwd_killed()
                              else (gat_bwd_src, gat_bwd_dst))
            if src_fn is gat_bwd_src:
                sp.args["src_lanes"] = src_geometry(k, f, x, du).lanes
            dtable, dast, dq = src_fn(x, as_t, ad_l, m, du, dz,
                                      *csr.transposed(), slope, precision)
            dadl = dst_fn(dq, csr.edge_map(), csr.row_ptr, csr.col_idx)
            del dq
            table = x.view(-1, k, f)
            dtable = dtable.view(-1, k, f) + dast[:, :, None] * a_src
            dh = dadl[:, :, None] * a_dst
            da_src = torch.einsum("tk,tkf->kf", dast, table)
            da_dst = torch.einsum("nk,nkf->kf", dadl, h)
        return dh, dtable, da_src, da_dst, None, None, None


def gat_attend_kernel(h, table, a_src, a_dst, csr: DeviceCsr, slope: float,
                      precision: str = "exact") -> torch.Tensor:
    """Multi-head GAT aggregation through the GAT kernels (their plain
    versions on the CPU), differentiable in h, table, a_src and a_dst; the
    backward needs the CSR's transpose and its edge map
    (``DeviceCsr.from_csr(..., edge_map=True)``).  ``precision`` applies to the two
    weighted feature sums only (out forward, dtable backward)."""
    check_precision(precision, h.dtype)
    if gat_fuse_killed():
        n = csr.num_rows
        dst = torch.repeat_interleave(
            torch.arange(n, device=h.device), torch.diff(csr.row_ptr))
        return gat_attend(h, table, csr.col_idx, dst, n, a_src, a_dst,
                          slope)
    return _GatAttend.apply(h, table, a_src, a_dst, csr, float(slope),
                            precision)
