"""Halo index maps: which rows each part must receive from each other part
(roc_tpu/parallel/halo.py, NumPy, element for element), and each part's
CSR over its source table.

The reference sidesteps the problem by having every partition read the
entire node tensor through Legion zero-copy coherence
(scattergather.cc:69-73).  Here, once at partition time, the builder finds
exactly which remote rows each part's in-edges touch; each aggregation
then exchanges only those.

Layout (P parts, K = max rows any ordered pair exchanges, padded):
  send_idx[q, p, :]   local row indices in part q that part p needs
                      (sorted, padded with S-1 — a guaranteed pad row whose
                      features are zero)
  edge_src_local[p,:] per-edge source index into part p's *combined table*
                      [own part (S rows) ++ recv buffer (P*K rows)]:
                      own sources stay in [0, S); a remote source owned by q
                      at send position j maps to S + q*K + j.

The builder runs in C++ (``roc_tpu_torch.native``, as roc_tpu's does)
unless ``ROC_TPU_NO_NATIVE=1``; its NumPy twin and the per-pair reference
builder are the oracles it is checked against.

The streaming executor's frozen-shape tables (stream/executor.py
``_stream_maps``) differ in layout: K carries slack for a reshard and the
unfilled entries index each owner's own pad row in the padded store.  The
two share :func:`part_csrs`, each part's CSR and its transpose over a
table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from roc_tpu_torch import native
from roc_tpu_torch.graph.partition import Partition


@dataclasses.dataclass(frozen=True)
class HaloMaps:
    K: int
    send_idx: np.ndarray        # [P, P, K] int32
    edge_src_local: np.ndarray  # [P, E] int32 into the combined table
    halo_rows_total: int        # live (unpadded) remote rows exchanged


def build_halo_maps(part: Partition) -> HaloMaps:
    """The halo maps of ``part``: the C++ builder (``native.halo_maps``),
    or under ``ROC_TPU_NO_NATIVE=1`` the NumPy one, which is its oracle
    (the same sort-free algorithm, bit for bit)."""
    if native.enabled():
        K, sizes, send_idx, edge_src_local = native.halo_maps(
            part.edge_src, part.shard_nodes)
        return HaloMaps(K=K, send_idx=send_idx,
                        edge_src_local=edge_src_local,
                        halo_rows_total=int(sizes.sum()))
    return _build_halo_maps_numpy(part)


def _build_halo_maps_numpy(part: Partition) -> HaloMaps:
    """Sort-free: a boolean mark over the padded id space [0, P*S) yields
    the sorted-unique remote sources as a flatnonzero scan (padded ids are
    already (owner, local)-ordered), and a dense lookup table makes the
    per-edge remap a single fancy-index — O(E + P*S) per part."""
    P, S, E = part.num_parts, part.shard_nodes, part.shard_edges
    src_all = part.edge_src
    uniqs = []
    sizes = np.zeros((P, P), np.int64)
    for p in range(P):
        mark = np.zeros(P * S, dtype=bool)
        mark[src_all[p]] = True
        mark[p * S:(p + 1) * S] = False     # own rows are not remote
        u = np.flatnonzero(mark)            # sorted unique remote ids
        uniqs.append(u)
        sizes[p] = np.bincount(u // S, minlength=P)
    K = max(int(sizes.max()), 1)
    # start of owner q's group within part p's sorted uniq list
    starts = np.concatenate(
        [np.zeros((P, 1), np.int64), np.cumsum(sizes, axis=1)], axis=1)

    send_idx = np.full((P, P, K), S - 1, dtype=np.int32)
    edge_src_local = np.empty((P, E), dtype=np.int32)
    lut = np.empty(P * S, dtype=np.int32)   # padded id -> combined index
    for p in range(P):
        u = uniqs[p]
        uo = u // S
        pos = np.arange(len(u), dtype=np.int64) - starts[p, uo]
        send_idx[uo, p, pos] = u % S
        lut[u] = (S + uo * K + pos).astype(np.int32)
        src = src_all[p]
        own = (src // S) == p
        edge_src_local[p] = np.where(own, src - p * S, lut[src])
    return HaloMaps(K=K, send_idx=send_idx, edge_src_local=edge_src_local,
                    halo_rows_total=int(sizes.sum()))


def _build_halo_maps_reference(part: Partition) -> HaloMaps:
    """The per-pair builder — O(P^2) Python loops with per-pair
    unique/searchsorted.  The correctness oracle of the builder above (and
    a readable spec of the layout)."""
    P, S, E = part.num_parts, part.shard_nodes, part.shard_edges
    send_lists = [[np.empty(0, np.int64) for _ in range(P)] for _ in range(P)]
    # Pass 1: per (dest p, owner q) unique remote locals.
    uniq_cache = []
    for p in range(P):
        src = part.edge_src[p]
        owner = src // S
        remote = owner != p
        per_owner = {}
        for q in np.unique(owner[remote]):
            locals_q = np.unique(src[remote & (owner == q)] - q * S)
            per_owner[int(q)] = locals_q
            send_lists[int(q)][p] = locals_q
        uniq_cache.append(per_owner)
    halo_total = sum(len(v) for per in uniq_cache for v in per.values())
    K = max([len(v) for per in uniq_cache for v in per.values()] + [1])

    send_idx = np.full((P, P, K), S - 1, dtype=np.int32)
    for q in range(P):
        for p in range(P):
            rows = send_lists[q][p]
            send_idx[q, p, : len(rows)] = rows

    # Pass 2: remap edge sources into the combined table.
    edge_src_local = np.empty((P, E), dtype=np.int32)
    for p in range(P):
        src = part.edge_src[p]
        owner = (src // S).astype(np.int64)
        local = (src - owner * S).astype(np.int64)
        out = np.empty(E, dtype=np.int64)
        own = owner == p
        out[own] = local[own]
        for q, rows in uniq_cache[p].items():
            sel = owner == q
            # position of each remote local within q's (sorted) send list
            pos = np.searchsorted(rows, local[sel])
            out[sel] = S + q * K + pos
        edge_src_local[p] = out
    return HaloMaps(K=K, send_idx=send_idx, edge_src_local=edge_src_local,
                    halo_rows_total=halo_total)


def part_csr(esrc, edst, S: int, T: int, edge_map: bool, device="cpu"):
    """One part's CSR (S rows over T table rows) and its transpose (T rows
    over S), as tensors on ``device``: ``(row_ptr [S+1] int64, col [E]
    int32, t_row_ptr [T+1] int64, t_col [E] int32, t_pos [E] int32 or
    None)``.  A part's edges are already in destination order, so the
    CSR's sources are ``esrc`` as it is; the transpose is its stable sort
    by source, as ``Csr.transpose`` builds it (a stable order is unique,
    so the card's sort gives the host's arrays)."""
    es = torch.as_tensor(np.asarray(esrc), dtype=torch.int64, device=device)
    ed = torch.as_tensor(np.asarray(edst), dtype=torch.int64, device=device)
    row_ptr = torch.zeros(S + 1, dtype=torch.int64, device=device)
    row_ptr[1:] = torch.cumsum(torch.bincount(ed, minlength=S), 0)
    order = torch.sort(es, stable=True).indices
    t_row_ptr = torch.zeros(T + 1, dtype=torch.int64, device=device)
    t_row_ptr[1:] = torch.cumsum(torch.bincount(es, minlength=T), 0)
    t_pos = None
    if edge_map:
        t_pos = torch.empty(es.numel(), dtype=torch.int32, device=device)
        t_pos[order] = torch.arange(es.numel(), dtype=torch.int32,
                                    device=device)
    return (row_ptr, es.to(torch.int32), t_row_ptr,
            ed[order].to(torch.int32), t_pos)


def part_csrs(esrc_local, edge_dst, S: int, T: int, edge_map: bool):
    """:func:`part_csr` of every part of equal-length [P, E] edge arrays,
    on the host, stacked: ``(row_ptr [P, S+1], col [P, E], t_row_ptr
    [P, T+1], t_col [P, E], t_pos [P, E] or None)``."""
    parts = [[None if a is None else a.numpy() for a in
              part_csr(esrc_local[i], edge_dst[i], S, T, edge_map)]
             for i in range(esrc_local.shape[0])]
    row_ptr, _, t_row_ptr, t_col, t_pos = (
        None if parts[0][j] is None else np.stack([q[j] for q in parts])
        for j in range(5))
    return row_ptr, esrc_local, t_row_ptr, t_col, t_pos
