"""Graph data on the device and the aggregation backend (the parts of
roc_tpu/train/driver.py that the trainer and the frozen loader call:
``effective_backend``, ``dense_graph_data``, ``make_gctx``).

Backends:
  kernel  sum/avg through ops.scatter_gather at the configured precision:
          the CUDA kernel on a CUDA device, its plain version on the CPU
          (the counterpart of the JAX package's binned Pallas backend)
  xla     the plain version in fp32 on any device (the counterpart of the
          JAX package's xla backend, which ignores the precision)

Both differentiate through the same autograd Function, whose backward
aggregates over the transposed CSR.
"""

from __future__ import annotations

import dataclasses

import torch

from roc_tpu_torch import ops
from roc_tpu_torch.models.model import GraphCtx, Model
from roc_tpu_torch.train.config import Config


@dataclasses.dataclass
class DenseGraphData:
    """The in-edge CSR (with its transpose when the user differentiates)
    and the in-degrees, resident on one device."""
    csr: ops.DeviceCsr
    in_degree: torch.Tensor     # [N] float32
    backend: str = "xla"
    precision: str = "exact"


def effective_backend(config: Config, model: Model,
                      device: torch.device) -> str:
    """The run's aggregation backend, ``"kernel"`` or ``"xla"``.

    ``xla`` is the explicit way to ask for the plain version.  On CUDA,
    every other choice (auto, binned, pallas, matmul) resolves to the
    kernel.  On the CPU, ``auto`` resolves to ``xla`` as it does in the
    JAX package off the TPU, and the others to the kernel backend (whose
    wrapper runs the plain version at the configured precision).  A model
    without sum/avg aggregation has nothing for the kernel to do."""
    b = config.aggregate_backend
    aggrs = {op.attrs["aggr"] for op in model.ops if op.kind == "aggregate"}
    if b == "xla" or not ({"sum", "avg"} & aggrs):
        return "xla"
    if device.type == "cpu" and b == "auto":
        return "xla"
    return "kernel"


def dense_graph_data(graph, backend: str, precision: str,
                     device: torch.device,
                     transpose: bool = True) -> DenseGraphData:
    """Validate ``graph`` (a host Csr) once and put it on ``device``, with
    its transpose unless ``transpose`` is False (forward-only users: the
    host transpose of a Reddit-size graph takes seconds)."""
    if backend not in ("kernel", "xla"):
        raise ValueError(f"backend={backend!r}: kernel|xla")
    if precision not in ("fast", "exact"):
        raise ValueError(f"precision={precision!r}: fast|exact")
    graph.validate()
    return DenseGraphData(
        csr=ops.DeviceCsr.from_csr(graph, device, transpose),
        in_degree=torch.as_tensor(graph.in_degrees, dtype=torch.float32,
                                  device=device),
        backend=backend, precision=precision)


def make_gctx(g: DenseGraphData, megafuse: bool = False) -> GraphCtx:
    """The op graph's view of ``g``.  With ``megafuse`` on the kernel
    backend, each ``mega_matches`` chain runs through the whole-layer
    megakernel (driver.py:368-414).  The JAX hook's TPU gates (VMEM budget,
    flat geometry, bf16 staging unit, kill switches, hybrid plans) have no
    counterpart here: the hook always runs the kernel."""
    def aggregate(x, aggr):
        if g.backend == "xla":
            return ops.scatter_gather_plain(x, g.csr, aggr, "exact")
        return ops.scatter_gather(x, g.csr, aggr, g.precision)

    def fuse_linear(x, w, activation, aggr, fold=False):
        # fold: the norm-folded GCN chain, D^-1/2 A D^-1/2 (x W) =
        # D^-1/2 (A ((D^-1/2 x) W)); relu commutes with the positive
        # post-scale, so it stays in the kernel.  avg: (D^-1 A) W =
        # D^-1 (A W); the activation moves out with the division, which
        # it must follow.
        if fold:
            x = ops.indegree_norm(x, g.in_degree)
        out = ops.scatter_gather_linear(
            x, w, g.csr, g.precision, "none" if aggr == "avg" else activation)
        if aggr == "avg":
            out = ops.divide_by_degree(out, g.in_degree)
        if fold:
            out = ops.indegree_norm(out, g.in_degree)
        if aggr == "avg":
            out = ops.apply_activation(out, activation)
        return out

    fused = megafuse and g.backend == "kernel"
    return GraphCtx(aggregate=aggregate, in_degree=g.in_degree,
                    fuse_linear=fuse_linear if fused else None)
