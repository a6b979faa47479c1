"""Graph data on the device and the aggregation backend (the parts of
roc_tpu/train/driver.py that the trainer and the frozen loader call:
``effective_backend``, ``dense_graph_data``, ``make_gctx``,
``model_has_gat``, ``model_gat_dims``, and ``host_to_device`` for a
dataset's per-vertex arrays).

Backends:
  kernel  sum/avg through ops.scatter_gather at the configured precision,
          and graph attention through ops.gat_attend_kernel: the CUDA
          kernels on a CUDA device, their plain versions on the CPU (the
          counterpart of the JAX package's binned and plan backends)
  xla     the plain versions in fp32 on any device (the counterpart of the
          JAX package's xla backend, which ignores the precision)

The sums differentiate through one autograd Function on both backends,
whose backward aggregates over the transposed CSR.  One backend choice
covers aggregation and attention: the JAX package resolves attention
separately (``effective_gat_backend``) only because its plans are built
per operation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from roc_tpu_torch import ops
from roc_tpu_torch.models.model import GraphCtx, Model, mega_matches
from roc_tpu_torch.ops.kernels.gat import forward_geometry
from roc_tpu_torch.train.config import Config


@dataclasses.dataclass
class DenseGraphData:
    """The in-edge CSR (with its transpose when the user differentiates)
    and the in-degrees, resident on one device."""
    csr: ops.DeviceCsr
    in_degree: torch.Tensor     # [N] float32
    backend: str = "xla"
    precision: str = "exact"


_COPY_BLOCK_BYTES = 64 << 20


def host_to_device(a: np.ndarray, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A dataset's host array on ``device`` in ``dtype``: the same bits, or
    under ``-bf16`` each value rounded to nearest even, as
    ``jnp.asarray(..., bfloat16)`` rounds.  A read-only array (a lazy
    dataset's memmap) is copied and cast in blocks of rows: no whole host
    copy, and no warning from torch about a non-writable array."""
    if a.flags.writeable:
        return torch.as_tensor(a, dtype=dtype, device=device)
    out = torch.empty(a.shape, dtype=dtype, device=device)
    row_bytes = a.dtype.itemsize * max(1, int(np.prod(a.shape[1:])))
    step = max(1, _COPY_BLOCK_BYTES // row_bytes)
    for i in range(0, a.shape[0], step):
        out[i:i + step] = torch.from_numpy(np.array(a[i:i + step]))
    return out


def model_has_gat(model: Model) -> bool:
    return any(op.kind == "gat" for op in model.ops)


def model_gat_dims(model: Model) -> tuple:
    """(heads, head_dim) of the model's first gat op; (0, 0) when the model
    has no attention."""
    for op in model.ops:
        if op.kind == "gat":
            return int(op.attrs["heads"]), int(op.attrs["head_dim"])
    return 0, 0


def forward_launches(model: Model, megafuse: bool = False,
                     precision: str = "fast") -> dict:
    """Kernel launches of one forward of ``model`` on the kernel backend
    at ``precision`` (the config's default, "fast"): one megakernel per
    ``mega_matches`` layer chain (with ``megafuse``), one sum aggregation
    per other sum/avg aggregate op, one score and one attention forward per
    gat op, and the stagings: in "fast" each sum aggregation and
    megakernel first stages its fp32 input once as a bf16 plane
    (``stage_plane``), in "exact" none does; an attention forward whose
    single head's rows are not 16-byte aligned stages them as an fp32
    plane (``gat_stage``) in both."""
    matches = mega_matches(model) if megafuse else {}
    fused = {j for i, m in matches.items() for j in (i, *m["skip"])}
    kinds = [op.attrs.get("aggr") if op.kind == "aggregate" else op.kind
             for i, op in enumerate(model.ops) if i not in fused]
    gats = kinds.count("gat")
    dims = [(int(op.attrs["heads"]), int(op.attrs["head_dim"]))
            for op in model.ops if op.kind == "gat"]
    staged = sum(forward_geometry(k, f, k * f, 0).staged for k, f in dims)
    out = {"aggregate_sum": kinds.count("sum") + kinds.count("avg"),
           "gat_score": gats, "gat_stage": staged, "gat_forward": gats}
    if megafuse:
        out["aggregate_linear"] = len(matches)
    out["stage_plane"] = (out["aggregate_sum"] + len(matches)
                          if precision == "fast" else 0)
    return out


def effective_backend(config: Config, model: Model,
                      device: torch.device) -> str:
    """The run's backend, ``"kernel"`` or ``"xla"``.

    ``xla`` is the explicit way to ask for the plain versions.  On CUDA,
    every other choice (auto, binned, pallas, matmul) resolves to the
    kernels.  On the CPU, ``auto`` resolves to ``xla`` as it does in the
    JAX package off the TPU, and the others to the kernel backend (whose
    wrappers run the plain versions at the configured precision).  A model
    with neither sum/avg aggregation nor attention has nothing for the
    kernels to do."""
    b = config.aggregate_backend
    aggrs = {op.attrs["aggr"] for op in model.ops if op.kind == "aggregate"}
    if b == "xla" or not ({"sum", "avg"} & aggrs or model_has_gat(model)):
        return "xla"
    if device.type == "cpu" and b == "auto":
        return "xla"
    return "kernel"


def tune_targets(model: Model, megafuse: bool = False) -> tuple:
    """(sum widths, GAT (K, F)s) of the kernels ``model``'s step launches
    over the whole graph's CSR: the width of each sum/avg aggregation that
    no megakernel takes over (a region's layers are megakernel chains
    too), and each attention's heads and head width.  The autotuner tunes
    these (``-autotune``)."""
    from roc_tpu_torch.memory.estimator import _op_out_dims
    dims = _op_out_dims(model)
    matches = mega_matches(model) if megafuse else {}
    fused = {j for i, m in matches.items() for j in (i, *m["skip"])}
    widths = sorted({int(dims[op.inputs[0]])
                     for i, op in enumerate(model.ops)
                     if op.kind == "aggregate" and i not in fused
                     and op.attrs.get("aggr") in ("sum", "avg")},
                    reverse=True)
    gats = sorted({(int(op.attrs["heads"]), int(op.attrs["head_dim"]))
                   for op in model.ops if op.kind == "gat"}, reverse=True)
    return tuple(widths), tuple(gats)


def tuned_launch(graph, precision: str, megafuse: bool = False):
    """The tuned store's ``ops.aggregate.LaunchTable`` for ``graph`` (a
    host Csr) at ``precision``, or None (no store, no entry for this
    graph and variant, or ``ROC_NO_TUNED``): the kernels' own rule."""
    from roc_tpu_torch.tune import store
    if store.load_store() is None:
        return None
    return store.launch_table(graph.col_idx, graph.dst_idx, graph.num_nodes,
                              graph.num_nodes, store.storage_of(precision),
                              megafuse)


def dense_graph_data(graph, backend: str, precision: str,
                     device: torch.device, transpose: bool = True,
                     edge_map: bool = False,
                     megafuse: bool = False) -> DenseGraphData:
    """Validate ``graph`` (a host Csr) once and put it on ``device``, with
    its transpose unless ``transpose`` is False (forward-only users: the
    host transpose of a Reddit-size graph takes seconds), and with the
    transpose's edge map when ``edge_map`` is True (a GAT model trained on
    the kernel backend: [E] int32, 94 MB at Reddit).  On the kernel
    backend the CSR carries the tuned store's launches for this graph and
    variant (``tuned_launch``; ``megafuse`` picks the ``+fuse`` variant),
    read once here.

    roc_tpu threads ``-bf16-storage`` here, into its binned plans' staging
    unit; a CSR has none, and the kernels already stage bf16 once in fast,
    so on one device the flag changes no bit in either package."""
    if backend not in ("kernel", "xla"):
        raise ValueError(f"backend={backend!r}: kernel|xla")
    if precision not in ("fast", "exact"):
        raise ValueError(f"precision={precision!r}: fast|exact")
    graph.validate()
    launch = tuned_launch(graph, precision, megafuse) \
        if backend == "kernel" else None
    return DenseGraphData(
        csr=ops.DeviceCsr.from_csr(graph, device, transpose, edge_map,
                                   launch),
        in_degree=torch.as_tensor(graph.in_degrees, dtype=torch.float32,
                                  device=device),
        backend=backend, precision=precision)


def make_gctx(g: DenseGraphData, megafuse: bool = False,
              fusion_depth: int = 1) -> GraphCtx:
    """The op graph's view of ``g``.  With ``megafuse`` on the kernel
    backend, each ``mega_matches`` chain runs through the whole-layer
    megakernel (driver.py:368-414), and with a ``fusion_depth`` other than
    1 each ``mega_regions`` chain of such layers through the region kernels
    (driver.py:416-444).  The JAX hooks' TPU gates (VMEM budgets, flat
    geometry, bf16 staging unit, kill switches, hybrid plans, region
    admission) have no counterpart here: the hooks always run the kernels.

    Attention (driver.py:348-366) on the kernel backend always runs
    ``gat_attend_kernel``, with or without ``megafuse``: the JAX package
    gates its fused attention on ``-megafuse`` only for the VMEM admission
    and binned schedule that the CSR kernels do not have."""
    def aggregate(x, aggr):
        if g.backend == "xla":
            return ops.scatter_gather_plain(x, g.csr, aggr, "exact")
        return ops.scatter_gather(x, g.csr, aggr, g.precision)

    def attend(h, a_src, a_dst, slope):
        # one device: the source table is the layer's own h.  A bf16 h
        # (-bf16's first layer) is upcast here: roc_tpu's kernels upcast
        # their table (pallas/gat.py:769) and its xla composition promotes
        # against the fp32 attention vectors, so the output is fp32 on
        # every backend, and an exact upcast changes no value
        h = h.to(torch.float32)
        if g.backend == "xla":
            n = g.csr.num_rows
            dst = torch.repeat_interleave(
                torch.arange(n, device=h.device), torch.diff(g.csr.row_ptr))
            return ops.gat_attend(h, h, g.csr.col_idx, dst, n, a_src, a_dst,
                                  slope)
        return ops.gat_attend_kernel(h, h, a_src, a_dst, g.csr, slope,
                                     g.precision)

    def fuse_linear(x, w, activation, aggr, fold=False):
        # fold: the norm-folded GCN chain, D^-1/2 A D^-1/2 (x W) =
        # D^-1/2 (A ((D^-1/2 x) W)); relu commutes with the positive
        # post-scale, so it stays in the kernel.  avg: (D^-1 A) W =
        # D^-1 (A W); the activation moves out with the division, which
        # it must follow.
        # The kernels take fp32: a bf16 x (-bf16's SAGE or GIN first layer;
        # the fold's norm promotes GCN's to fp32 first) is upcast exactly,
        # and the output takes x's dtype, as roc_tpu's hook returns it.
        if fold:
            x = ops.indegree_norm(x, g.in_degree)
        dtype = x.dtype
        out = ops.scatter_gather_linear(
            x.to(torch.float32), w, g.csr, g.precision,
            "none" if aggr == "avg" else activation)
        if aggr == "avg":
            out = ops.divide_by_degree(out, g.in_degree)
        if fold:
            out = ops.indegree_norm(out, g.in_degree)
        if aggr == "avg":
            out = ops.apply_activation(out, activation)
        return out.to(dtype)

    def fuse_region(x, ws, activations, fold=False):
        # the region kernels own the interior norm pairs; the head's
        # pre-scale and the tail's post-scale stay outside, as in the
        # per-layer hook
        if fold:
            x = ops.indegree_norm(x, g.in_degree)
        dtype = x.dtype
        out = ops.region_linear(x.to(torch.float32), ws, g.in_degree, g.csr,
                                g.precision, activations, fold)
        if fold:
            out = ops.indegree_norm(out, g.in_degree)
        return out.to(dtype)

    fused = megafuse and g.backend == "kernel"
    regions = fused and fusion_depth != 1
    return GraphCtx(aggregate=aggregate, in_degree=g.in_degree,
                    fuse_linear=fuse_linear if fused else None,
                    attend=attend,
                    fuse_region=fuse_region if regions else None,
                    fusion_depth=fusion_depth)
