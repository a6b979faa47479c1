"""Per-layer activation bytes and recompute times, the planner's inputs
(roc_tpu/memory/estimator.py).

  * **Bytes** are roc_tpu's accounting, unchanged: the op IR carries every
    intermediate's width, so a layer's activation bytes are ``rows *
    width * itemsize`` sums.  ``bytes_full`` counts every op output (an
    unplanned layer), ``bytes_saved`` only the outputs a kept layer saves
    under an active plan (``models.model.CKPT_SAVE_KINDS`` and the layer
    boundary); the megakernel's and the fusion regions' ``gone`` tensors
    count zero (a region's interior boundaries at ``halo_rows``, 0 on one
    device).  ``fixed_bytes_for`` is roc_tpu's plan-independent set.
  * **Recompute time** is priced for the card.  A linear on the H100
    roofline (``obs/roofline.py``).  An aggregation, which roc_tpu prices
    with the TPU's calibrated chunk cost (``balance.cost_model.
    prior_times``), from the port's own sum kernel:
    ``AGG_S_PER_EDGE_COLUMN`` seconds per edge and column, or the card's
    refit rate where the autotuner measured one
    (:func:`agg_s_per_edge_column`).  Only the ratio of recompute to step
    time enters the planner's choice.

The port's own device residents, which roc_tpu's accounting does not
know, are reported apart by :func:`port_resident_bytes` and added to the
trainer's fixed set by :func:`estimate_for_trainer`: the CSR and its
transpose in place of roc_tpu's two int32 edge arrays, GAT's edge map
``t_pos``, and the bf16 plane that "fast" stages before each sum.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from roc_tpu_torch.obs.roofline import PEAK_BW, PEAK_FLOPS

# Seconds per edge and feature column of one fast sum aggregation on the
# card, staging included: the sum kernel's 3.30 ms at H = 256 over the
# synthetic Reddit graph's 23,526,073 in-edges (chip_smoke.py kernel
# phase, PERF.md §6 row 1; NVIDIA H100 80GB HBM3, 700.00 W).
AGG_S_PER_EDGE_COLUMN = 3.30e-3 / (23_526_073 * 256)


def agg_s_per_edge_column() -> float:
    """Seconds per edge and column of one fast sum: the card's refit rate
    when the port's measured table exists and came from the card
    (``tune/refit.py:load_measured``; the staged plane's 2 bytes a column
    at its ``byte_s``), else ``AGG_S_PER_EDGE_COLUMN``."""
    from roc_tpu_torch.tune.refit import load_measured
    table = load_measured()
    if table is None:
        return AGG_S_PER_EDGE_COLUMN
    return 2.0 * table["rates"]["byte_s"]

# Op kinds whose outputs a kept layer saves under an active plan
# (estimator.py:45); the elementwise rest is recomputed.
SAVED_KINDS = frozenset({"linear", "aggregate", "gat"})


@dataclasses.dataclass(frozen=True)
class LayerEstimate:
    """One layer's planning inputs (bytes per device)."""

    index: int
    name: str                 # "L<i>", the checkpoint-name prefix
    bytes_full: int           # every op output (all-KEEP)
    bytes_saved: int          # the saved outputs only (KEEP under a plan)
    bytes_boundary: int       # the layer-boundary tensor alone
    recompute_full_s: float   # forward recompute of the whole layer
    recompute_cheap_s: float  # its elementwise ops only


@dataclasses.dataclass(frozen=True)
class ModelEstimate:
    """Planner inputs for one (model, shard shape) pair."""

    layers: Tuple[LayerEstimate, ...]
    fixed_bytes: int     # params, Adam state, grads, placed node tensors
    base_step_s: float   # predicted all-KEEP step time (fwd + ~2x bwd)
    rows: int
    edges: int

    def total_full_bytes(self) -> int:
        return sum(l.bytes_full for l in self.layers)


def _op_out_dims(model) -> Dict[int, int]:
    """Output width per tensor id, walked from the op IR."""
    dims: Dict[int, int] = {0: model.input.dim}
    for op in model.ops:
        a = dims[op.inputs[0]]
        if op.kind == "linear":
            dims[op.out] = op.attrs["out_dim"]
        elif op.kind == "gat":
            dims[op.out] = op.attrs["head_dim"] * op.attrs["heads"]
        else:
            dims[op.out] = a
    return dims


def _op_forward_s(op, in_dim: int, out_dim: int, rows: int,
                  edges: int) -> float:
    """Forward seconds of one op at the given shard shape on the card."""
    if op.kind == "linear":
        flops = 2.0 * rows * in_dim * out_dim
        bytes_moved = 4.0 * rows * (in_dim + out_dim)
        return max(flops / PEAK_FLOPS, bytes_moved / PEAK_BW)
    if op.kind in ("aggregate", "gat"):
        t = edges * max(out_dim, 1) * agg_s_per_edge_column()
        if op.kind == "gat":
            # the projection GEMM and the per-edge score and softmax
            # passes on top of the weighted sum
            flops = 2.0 * rows * in_dim * out_dim
            t = 2.0 * t + flops / PEAK_FLOPS
        return t
    # elementwise: read the input, write the output
    return 4.0 * rows * (in_dim + 2 * out_dim) / PEAK_BW


def estimate_model(model, rows: int, edges: int, itemsize: int = 4,
                   fixed_bytes: int = 0, megafuse: bool = False,
                   fusion_depth: int = 1,
                   halo_rows: int = 0) -> ModelEstimate:
    """Per-layer byte and recompute estimates for ``model`` at a shard of
    ``rows`` node rows and ``edges`` edges (estimator.py:89-176)."""
    fused_gone: set = set()
    frontier_gone: set = set()
    if megafuse:
        from roc_tpu_torch.models.model import mega_matches, mega_regions
        for rec in mega_matches(model).values():
            fused_gone.update(rec["gone"])
        if fusion_depth != 1:
            # the inter-layer boundaries a region also drops: priced at the
            # halo frontier's rows (0 on one device)
            for reg in mega_regions(model, fusion_depth).values():
                frontier_gone.update(
                    t for t in reg["gone"] if t not in fused_gone)
    dims = _op_out_dims(model)
    per_layer: Dict[int, List] = {}
    for op in model.ops:
        per_layer.setdefault(op.attrs.get("layer", 0), []).append(op)
    layers = []
    total_fwd = 0.0
    for idx in sorted(per_layer):
        full = saved = boundary = 0
        fwd = cheap = 0.0
        saw_boundary = False
        for op in per_layer[idx]:
            in_dim = dims[op.inputs[0]]
            out_dim = dims[op.out]
            if op.out in fused_gone:
                out_bytes = 0
            elif op.out in frontier_gone:
                out_bytes = halo_rows * out_dim * itemsize
            else:
                out_bytes = rows * out_dim * itemsize
            t = _op_forward_s(op, in_dim, out_dim, rows, edges)
            full += out_bytes
            fwd += t
            if op.kind in SAVED_KINDS or op.attrs.get("ckpt_boundary"):
                saved += out_bytes
            else:
                cheap += t
            if op.attrs.get("ckpt_boundary"):
                boundary = out_bytes
                saw_boundary = True
        if not saw_boundary and per_layer[idx]:
            last = per_layer[idx][-1]
            boundary = rows * dims[last.out] * itemsize
        layers.append(LayerEstimate(
            index=idx, name=f"L{idx}", bytes_full=int(full),
            bytes_saved=int(saved), bytes_boundary=int(boundary),
            recompute_full_s=fwd, recompute_cheap_s=cheap))
        total_fwd += fwd
    return ModelEstimate(layers=tuple(layers), fixed_bytes=int(fixed_bytes),
                         base_step_s=3.0 * total_fwd, rows=rows, edges=edges)


def mega_bwd_cotangent_drop(model, rows: int, itemsize: int = 4) -> int:
    """Bytes the megakernel backward keeps out of device memory: per
    ``mega_matches`` layer one write and one read of the ``[rows, H_in]``
    aggregation cotangent (estimator.py:179-192)."""
    from roc_tpu_torch.models.model import mega_matches
    total = 0
    for rec in mega_matches(model).values():
        total += 2 * rows * rec["linear"].attrs["in_dim"] * itemsize
    return total


def gat_residual_drop(model, rows: int, edges: int,
                      itemsize: int = 4) -> int:
    """Residual bytes the attention kernels drop against the plain
    composition: per gat layer the per-edge ``e [E, K]`` and sign ``[E,
    K]`` residuals, against two ``[rows, K]`` fp32 planes (m, z) kept
    instead (estimator.py:195-213)."""
    total = 0
    for op in model.ops:
        if op.kind == "gat":
            k = int(op.attrs["heads"])
            total += edges * k * (itemsize + 1) - 2 * rows * k * 4
    return max(total, 0)


def fixed_bytes_for(model, rows: int, in_dim: int, num_classes: int,
                    edges: int, itemsize: int = 4) -> int:
    """roc_tpu's plan-independent residents (estimator.py:216-230): params
    with Adam's m and v and one gradient copy (4x the params), the placed
    node tensors (x, one-hot labels, mask) and two int32 edge arrays."""
    params = 0
    for op in model.ops:
        if op.kind == "linear":
            params += op.attrs["in_dim"] * op.attrs["out_dim"]
        elif op.kind == "gat":
            kf = op.attrs["heads"] * op.attrs["head_dim"]
            params += op.attrs["in_dim"] * kf + 2 * kf
    node = rows * (in_dim * itemsize + num_classes * 4 + 4 + 4)
    edge = edges * 2 * 4
    return int(4 * params * 4 + node + edge)


def port_resident_bytes(model, rows: int, edges: int,
                        precision: str = "fast",
                        gat_edge_map: bool = False) -> Dict[str, int]:
    """The port's own device residents of a trainer, beside roc_tpu's
    accounting: ``csr`` (int64 row pointer, int32 sources) and ``csr_t``
    (its transpose), ``t_pos`` (GAT's [E] int32 edge map on the kernel
    backend), ``stage_plane`` (the widest bf16 plane "fast" stages before
    a sum: transient, one at a time) and ``edge_arrays``, roc_tpu's two
    int32 edge arrays, which the CSR replaces (a negative entry)."""
    csr = (rows + 1) * 8 + edges * 4
    widths = [0]
    dims = _op_out_dims(model)
    for op in model.ops:
        if op.kind == "aggregate" and op.attrs.get("aggr") in ("sum", "avg"):
            widths.append(dims[op.inputs[0]])
    return {"csr": csr, "csr_t": csr,
            "t_pos": edges * 4 if gat_edge_map else 0,
            "stage_plane": rows * max(widths) * 2
            if precision == "fast" else 0,
            "edge_arrays": -edges * 2 * 4}


def estimate_for_trainer(trainer) -> ModelEstimate:
    """Estimates at the trainer's shard shape, its fixed set roc_tpu's plus
    :func:`port_resident_bytes` (kept on the trainer as
    ``mem_port_bytes``)."""
    ds = trainer.dataset
    cfg = trainer.config
    part = getattr(trainer, "part", None)
    if part is not None:
        rows = int(part.shard_nodes)
        edges = int(part.shard_edges)
    else:
        rows = ds.graph.num_nodes
        edges = ds.graph.num_edges
    itemsize = torch.finfo(trainer.dtype).bits // 8
    fixed = fixed_bytes_for(trainer.model, rows, ds.features.shape[1],
                            ds.num_classes, edges, itemsize)
    gdata = getattr(trainer, "gdata", None)
    csrs = [] if gdata is None else (
        [gdata.csr] if hasattr(gdata, "csr") else
        [pg.csr for pg in gdata.parts if pg.csr is not None])
    edge_map = any(c.t_pos is not None for c in csrs)
    port = port_resident_bytes(trainer.model, rows, edges,
                               cfg.aggregate_precision, edge_map)
    trainer.mem_port_bytes = port
    return estimate_model(trainer.model, rows, edges, itemsize=itemsize,
                          fixed_bytes=fixed + sum(port.values()),
                          megafuse=cfg.megafuse,
                          fusion_depth=cfg.fusion_depth)


def step_arg_bytes(trainer) -> int:
    """Bytes of the tensors the trainer holds placed for its step: the
    params, Adam's state, x, labels, mask and the graph data (the
    counterpart of estimator.py:step_arg_bytes, which sums the jitted
    step's arguments)."""
    st = trainer.opt_state
    tensors = [*trainer.params.values(), *st.m.values(), *st.v.values()]
    tensors += [trainer.x, trainer.labels, trainer.mask]
    gdata = trainer.gdata
    if not hasattr(gdata, "csr"):       # the SPMD trainer's parts
        return int(sum(t.numel() * t.element_size() for t in tensors)
                   + gdata.nbytes())
    tensors += [gdata.in_degree] + gdata.csr.tensors()
    return int(sum(t.numel() * t.element_size() for t in tensors))
