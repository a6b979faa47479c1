"""The ring exchange (roc_tpu/parallel/ring.py): ``-exchange ring``.

Parts rotate around the mesh and every part aggregates the in-edges
sourced at the visiting part before passing it on:

    step k: position p holds the rows of owner q = (p - k) mod P
            acc <- combine(acc, aggregate(p's edges whose source q owns))
            buf <- the block of position p - 1

The bytes on the wire equal the allgather's (each part's rows travel the
whole ring), but a position holds two [S, H] buffers instead of the
[P*S, H] table.

Each part's in-edge list is grouped by source owner (stable, so the
destinations stay ascending within a group), and ``RingMaps`` pads the
groups to the largest group size; pad slots carry dst = S.  These arrays
are roc_tpu's, element for element.  roc_tpu's ``RingPlans`` (one-hot
chunk schedules for its matmul backend) are a TPU schedule and are not
ported: each (part, owner) group gets a :class:`~roc_tpu_torch.ops.
DeviceCsr` of S rows over the owner's S rows instead, built from the
group's live edges only (the pad slots, and the partition's pad edges
whose source is a pad row, are dropped), with its transpose for the
backward.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from roc_tpu_torch.graph.partition import Partition
from roc_tpu_torch.graph.shard_load import allgather_floors
from roc_tpu_torch.ops.aggregate import DeviceCsr, note_csr_build
from roc_tpu_torch.parallel.halo import part_csr


class RingMaps(NamedTuple):
    """Per-(part, source owner) edge groups, padded to a common size.

    ring_src [L, P, Eo] int32: source row local to its owner (pad: 0)
    ring_dst [L, P, Eo] int32: destination row local to the part,
                               ascending within each group (pad: S)
    """
    ring_src: np.ndarray
    ring_dst: np.ndarray


def build_ring_groups_arrays(edge_src: np.ndarray, edge_dst: np.ndarray,
                             P: int, S: int, allgather=None) -> RingMaps:
    """Group the parts' edges by source owner.

    ``edge_src`` [L, E] padded-global ids, ``edge_dst`` [L, E] part-local,
    L the parts held here (all P on one process, this process's under
    -perhost).  ``allgather`` raises the group width Eo to the global
    maximum so that every process builds the same shapes (None: the local
    maximum)."""
    L, E = edge_src.shape
    owner = (edge_src // S).astype(np.int64)                 # [L, E]
    counts = np.zeros((L, P), np.int64)
    rows = np.repeat(np.arange(L), E)
    np.add.at(counts, (rows, owner.reshape(-1)), 1)
    Eo = max(allgather_floors([[int(counts.max(initial=0))]],
                              allgather)[0], 1)

    ring_src = np.zeros((L, P, Eo), np.int32)
    ring_dst = np.full((L, P, Eo), S, np.int32)
    # stable grouping: the position of each edge within its (p, owner) group
    order = np.argsort(owner, axis=1, kind="stable")          # [L, E]
    for p in range(L):
        o = owner[p, order[p]]
        starts = np.searchsorted(o, np.arange(P))
        pos = np.arange(E) - starts[o]
        ring_src[p, o, pos] = (edge_src[p, order[p]] % S).astype(np.int32)
        ring_dst[p, o, pos] = edge_dst[p, order[p]].astype(np.int32)
    return RingMaps(ring_src=ring_src, ring_dst=ring_dst)


def build_ring_groups(part: Partition) -> RingMaps:
    """Every part's groups from the whole partition."""
    return build_ring_groups_arrays(part.edge_src, part.edge_dst,
                                    part.num_parts, part.shard_nodes)


def ring_device_groups(rm: RingMaps, num_valid: np.ndarray, S: int,
                       device) -> List[List[Optional[DeviceCsr]]]:
    """``[L][P]`` group CSRs (None where a group has no live edge).  A
    slot is live when its destination is not the pad slot S and its
    source is a live row of its owner (``num_valid``): the partition's pad
    edges read the part's first pad row."""
    L, P, _ = rm.ring_src.shape
    out = []
    for p in range(L):
        row = []
        for q in range(P):
            src, dst = rm.ring_src[p, q], rm.ring_dst[p, q]
            live = (dst != S) & (src < int(num_valid[q]))
            if not live.any():
                row.append(None)
                continue
            note_csr_build()
            rp, col, trp, tcol, _ = part_csr(src[live], dst[live], S, S,
                                             False, device)
            row.append(DeviceCsr(rp, col, trp, tcol))
        out.append(row)
    return out
