"""GAT (Velickovic et al., Graph Attention Networks, ICLR 2018, arXiv
1710.10903) as its Section 3.3 trains it on a transductive task, in plain
fp32 PyTorch.  Per layer i: dropout (slot i-1) on the layer's input; h = t W
viewed as K heads of F features; per in-edge u -> v and head k the score
s = LeakyReLU_0.2(a_dst . h[v] + a_src . h[u]) (a_src, a_dst [K, F]);
alpha the softmax of s over v's in-edges, shifted by the row's maximum, its
normaliser guarded as max(z, 1e-15); out[v] = sum of alpha h[u], the heads
concatenated; ELU on every layer but the last, which is one head of the
classes.

The one departure from the paper: its dropout (p = 0.6) on the normalised
attention coefficients is left out, as roc_tpu's GAT leaves it out.  The
eval forward (``key`` None) is the paper's.

In "fast" precision each product e * h[u] of the weighted sum is rounded
once to bfloat16 before its float32 sum, and in the backward each product
e * du[v] of the source table's gradient; the scores, maxima, normalisers
and score gradients stay float32 (the contract of the port's GAT kernels).
The weighted sum gathers [edges, K, F] in chunks of edges in CSR order, so
in blocks of destination rows: at once it would be 6 GB at Reddit's first
layer.

It is the port's ``gat`` (heads concatenated) at any depth."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.counts import (_widths, gat_bwd_call, gat_fwd_call,
                              gat_score_call, gemm_flops, least_s,
                              step_totals)
from perfbench.reference import prng

SLOPE = 0.2
Z_GUARD = 1e-15
_CHUNK = 1 << 26   # gathered elements a chunk of edges (256 MB of fp32)


def leaves(cfg):
    """(name, shape, Glorot fan-in, fan-out) of each leaf in draw order:
    ``gat_i_w`` [in, K*F], ``gat_i_asrc`` and ``gat_i_adst`` [K, F] a
    layer (the attention vectors drawn as [K*F, 1] Glorot matrices, as
    roc_tpu draws them)."""
    out = []
    widths = _widths(cfg, int(cfg["heads"]))
    for i, (din, dout, k, f) in enumerate(widths):
        p = f"gat_{i}"
        out.append((p + "_w", (din, dout), din, dout))
        out.append((p + "_asrc", (k, f), dout, 1))
        out.append((p + "_adst", (k, f), dout, 1))
    return out


def counts(cfg, n: int, e: int, train: bool) -> dict:
    """One GEMM a layer; per layer and head the source score, the
    attention forward and, in training, its backward (GAT kernels), and
    the destination score (an einsum: model work, no GAT kernel)."""
    widths = _widths(cfg, int(cfg["heads"]))
    gat = gat_least = 0.0
    for _, _, k, f in widths:
        calls = [gat_score_call(n, k, f), gat_fwd_call(n, e, k, f)]
        if train:
            calls.append(gat_bwd_call(n, e, k, f))
        gat += 2 * n * k * f
        for ops, nbytes in calls:
            gat += ops
            gat_least += least_s(ops, nbytes)
    return step_totals(gemm_flops(widths, n, train), gat_flops=gat,
                       gat_least_s=gat_least)


def _round(t: torch.Tensor, stage: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32) if stage else t


def _spans(num_edges: int, width: int):
    step = max(_CHUNK // max(width, 1), 1)
    for lo in range(0, num_edges, step):
        yield lo, min(lo + step, num_edges)


class _WeightedSum(torch.autograd.Function):
    """u[v, k] = sum over v's in-edges (u -> v) of e[edge, k] h[u, k], each
    product rounded as ``stage`` says; e [E, K] in CSR order, h [N, K, F].
    The backward's de is float32 (the score gradient), dh's products
    e * gu[v] are rounded as the forward's."""

    @staticmethod
    def forward(ctx, e, h, src, dst, stage):
        ctx.save_for_backward(e, h)
        ctx.src, ctx.dst, ctx.stage = src, dst, stage
        out = torch.zeros_like(h)
        for lo, hi in _spans(src.numel(), h[0].numel()):
            prod = e[lo:hi, :, None] * h[src[lo:hi]]
            out.index_add_(0, dst[lo:hi], _round(prod, stage))
        return out

    @staticmethod
    def backward(ctx, gu):
        e, h = ctx.saved_tensors
        src, dst, stage = ctx.src, ctx.dst, ctx.stage
        de = torch.empty_like(e)
        dh = torch.zeros_like(h)
        for lo, hi in _spans(src.numel(), h[0].numel()):
            s = src[lo:hi]
            g = gu[dst[lo:hi]]
            de[lo:hi] = (g * h[s]).sum(-1)
            dh.index_add_(0, s, _round(e[lo:hi, :, None] * g, stage))
        return de, dh, None, None, None


def attend(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
           graph, stage: bool) -> torch.Tensor:
    """One attention layer's output [N, K, F] from h [N, K, F]."""
    n, k = h.shape[:2]
    src, dst = graph.src, graph.dst
    as_ = torch.einsum("nkf,kf->nk", h, a_src)
    ad = torch.einsum("nkf,kf->nk", h, a_dst)
    q = ad[dst] + as_[src]
    s = torch.where(q >= 0, q, q * SLOPE)
    # the shift carries no gradient: the softmax does not depend on it
    m = torch.full((n, k), float("-inf"), device=h.device).scatter_reduce(
        0, dst[:, None].expand(-1, k), s.detach(), "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m[dst])
    z = torch.zeros((n, k), device=h.device).index_add(0, dst, e)
    u = _WeightedSum.apply(e, h, src, dst, stage)
    return u / torch.clamp_min(z, Z_GUARD)[:, :, None]


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, graph, cfg,
            key: Optional[prng.Key] = None) -> torch.Tensor:
    """Logits [N, C].  ``key`` is the step's key (training, with
    dropout); None runs the eval forward."""
    layers = cfg["layers"]
    rate = float(cfg["dropout"])
    stage = cfg["precision"] == "fast"
    t = x
    for i in range(1, len(layers)):
        last = i == len(layers) - 1
        if key is not None and rate > 0:
            t = prng.dropout(t, rate, prng.fold_in(key, i - 1))
        k, f = (1 if last else int(cfg["heads"])), int(layers[i])
        p = f"gat_{i - 1}"
        h = (t @ params[p + "_w"]).view(-1, k, f)
        t = attend(h, params[p + "_asrc"], params[p + "_adst"], graph,
                   stage).reshape(-1, k * f)
        if not last:
            t = torch.nn.functional.elu(t)
    return t
