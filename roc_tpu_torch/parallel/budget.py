"""Per-device memory estimate (roc_tpu/parallel/budget.py); allocates
nothing.

Answers "does this graph geometry fit the card?" before an expensive
build, and helps pick ``-parts`` for a new graph.  The terms are roc_tpu's
documented approximations of the dominant allocations, for
order-of-magnitude checks, not byte-exact accounting.  roc_tpu's binned
and matmul plan terms become the port's CSR: a part's CSR and its
transpose over the table, and in fast the sum kernel's bf16 staging plane
of the table at the widest layer.
"""

from __future__ import annotations

import dataclasses

import torch

# The card's memory, bytes: NVIDIA H100 SXM, 80 GB HBM3 (data sheet).
H100_SXM_BYTES = 80e9


def device_capacity_bytes(device=None) -> float:
    """The device's memory: what torch reports on a CUDA device, the H100
    SXM's 80 GB otherwise (the card this port targets)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and torch.cuda.is_available():
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        return float(torch.cuda.get_device_properties(idx).total_memory)
    return H100_SXM_BYTES


@dataclasses.dataclass(frozen=True)
class DeviceBudget:
    """Bytes per device, by component, for one training configuration."""
    features: float         # input feature part
    activations: float      # live fwd+bwd activations across the layers
    labels_mask: float      # one-hot labels + mask part
    params: float           # replicated params + Adam moments (x3)
    edges: float            # per-part edge arrays (src/dst int32)
    halo_table: float       # received halo rows at the widest layer
    plans: float            # the part's CSR and its transpose
    staging: float          # the sum kernel's bf16 plane (fast)

    @property
    def total(self) -> float:
        return sum(getattr(self, f.name) for f in dataclasses.fields(self))


def estimate_device_bytes(num_nodes: int, num_edges: int, in_dim: int,
                          hidden: int, num_classes: int, parts: int,
                          *, layers: int = 2, dtype_bytes: int = 4,
                          halo_fraction: float = 0.5,
                          backend: str = "kernel",
                          precision: str = "fast") -> DeviceBudget:
    """Per-device bytes for full-graph GCN-family training of one part.

    halo_fraction: the fraction of a part's rows also needed remotely (the
    widest layer's halo table is ``halo_fraction * (P-1) * S`` rows in the
    worst documented case; locality-heavy partitions measure far lower).
    backend "kernel" adds the CSR and, in fast, the staging plane; "xla"
    has neither.
    """
    S = -(-num_nodes // parts)              # padded part rows
    E_shard = -(-num_edges // parts)
    widest = max(in_dim, hidden)

    features = S * in_dim * dtype_bytes
    # fwd activations live across the backward: ~one [S, width] per layer
    # boundary x2 (fwd value + grad in flight)
    activations = 2 * (layers + 1) * S * widest * dtype_bytes
    labels_mask = S * (num_classes * 4 + 8)
    # params replicated + Adam m/v
    p = in_dim * hidden + (layers - 2) * hidden * hidden \
        + hidden * num_classes
    params = 3 * p * 4
    edges = E_shard * 2 * 4
    halo_rows = halo_fraction * (parts - 1) * S
    halo_table = halo_rows * widest * dtype_bytes
    if backend == "kernel":
        table = S + halo_rows
        # row_ptr [S+1] and t_row_ptr [table+1] int64, col and t_col int32
        plans = 8.0 * (S + 1) + 8.0 * (table + 1) + 2 * 4.0 * E_shard
        staging = table * widest * 2.0 if precision == "fast" else 0.0
    else:
        plans = staging = 0.0
    return DeviceBudget(features=features, activations=activations,
                        labels_mask=labels_mask, params=params, edges=edges,
                        halo_table=halo_table, plans=plans, staging=staging)
