"""Locality-preserving vertex reordering (roc_tpu/graph/reorder.py).

The order is a degree-sorted level-synchronous BFS from minimum-degree
seeds, reversed at the end: reverse Cuthill-McKee, vectorized per level so
the whole pass is O(E) NumPy (Reddit scale: seconds).  Ties break on
vertex id everywhere, so the permutation is reproducible and element for
element roc_tpu's (its NumPy path); big graphs take the C++ BFS of
``roc_tpu_torch.native``, held to that path.

``-reorder auto`` keeps the order only where it concentrates the edge set
by roc_tpu's own statistic: the slot-padded rows of the touched (512-row
source block x 512-row destination bin) cells, each rounded up to 32 rows
(roc_tpu/ops/pallas/binned.py ``padded_rows_for`` at ``GEOM_MID``).  That
is a TPU tiling count, kept here unchanged so ``auto`` decides as roc_tpu
does; whether it predicts the CUDA gather's time is measured, not assumed
(PERF.md).
"""

from __future__ import annotations

import numpy as np

from roc_tpu_torch import native
from roc_tpu_torch.graph.csr import Csr, E_DTYPE, NATIVE_MIN_EDGES, V_DTYPE

# binned.py GEOM_MID: source rows per block, destination rows per bin, and
# the slot every touched cell rounds up to
_CELL_ROWS = 512
_SLOT = 32


def _cell_counts(edge_src: np.ndarray, edge_dst: np.ndarray,
                 sb: int, rb: int) -> np.ndarray:
    """Edge counts of the nonzero (source-block x destination-bin) cells
    (binned.py ``_cell_stats``)."""
    blk = np.asarray(edge_src, np.int64) // sb
    bn = np.asarray(edge_dst, np.int64) // rb
    nbins = int(bn.max(initial=0)) + 1
    keys = blk * nbins + bn
    nkeys = int(blk.max(initial=0) + 1) * nbins
    if nkeys <= max(4 * len(keys), 1 << 20):
        # dense O(E + cells) bincount while the cell table is small
        cnt = np.bincount(keys, minlength=0)
        cnt = cnt[np.flatnonzero(cnt)]
    else:
        # sparse O(E log E) time, O(E) memory: a dense bincount is
        # O(blocks * bins) memory whatever the occupancy, which at
        # papers100M scale would not fit
        _, cnt = np.unique(keys, return_counts=True)
    return cnt.astype(np.int64)


def padded_rows(g: Csr) -> int:
    """Slot-padded rows of ``g``'s touched cells: the statistic ``auto``
    compares before and after the order."""
    cnt = _cell_counts(g.col_idx, g.dst_idx, _CELL_ROWS, _CELL_ROWS)
    return int((-(-cnt // _SLOT)).sum() * _SLOT)


def _union_neighbors(g: Csr, gt: Csr, frontier: np.ndarray) -> np.ndarray:
    """Concatenated in- and out-neighbors of ``frontier`` (with repeats)."""
    outs = []
    for c in (g, gt):
        lens = np.diff(c.row_ptr)[frontier]
        total = int(lens.sum())
        if total == 0:
            continue
        starts = c.row_ptr[:-1][frontier]
        # gather-runs: positions of every neighbor of every frontier node
        base = np.repeat(starts - np.concatenate(
            ([0], np.cumsum(lens)[:-1])), lens)
        outs.append(c.col_idx[base + np.arange(total)])
    if not outs:
        return np.zeros(0, V_DTYPE)
    return np.concatenate(outs)


def rcm_order(g: Csr) -> np.ndarray:
    """Reverse-Cuthill-McKee-style order: ``order[new_id] = old_id``.

    BFS treats the graph as undirected (in- plus out-neighbors); levels are
    visited in increasing total-degree order (ids break ties).  Isolated
    vertices (self-loop only) go to the end in id order: they touch no
    off-diagonal cells, so their position is irrelevant to locality.

    At >= 2^20 edges (roc_tpu's threshold), unless ``ROC_TPU_NO_NATIVE=1``,
    the C++ BFS runs (``native.rcm_order``): the (degree, id) level order is
    total, so it matches the NumPy path below, its oracle, element for
    element."""
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, np.int64)
    gt = g.transpose()
    if g.num_edges >= NATIVE_MIN_EDGES and native.enabled():
        return native.rcm_order(g.row_ptr, g.col_idx, gt.row_ptr, gt.col_idx)
    deg_in = np.diff(g.row_ptr)
    deg_out = np.diff(gt.row_ptr)
    # self-loops count toward both; subtract them from the "connects me to
    # someone" degree used for the isolated-vertex fast path
    self_cnt = np.zeros(n, np.int64)
    sl = g.col_idx == g.dst_idx
    np.add.at(self_cnt, g.col_idx[sl], 1)
    conn_deg = deg_in + deg_out - 2 * self_cnt
    deg = deg_in + deg_out

    visited = np.zeros(n, bool)
    isolated = conn_deg == 0
    visited[isolated] = True
    chunks = []
    # seed scan in (degree, id) order, skipping visited: each outer
    # iteration consumes a whole connected component
    seed_order = np.lexsort((np.arange(n), deg))
    seed_pos = 0
    while True:
        while seed_pos < n and visited[seed_order[seed_pos]]:
            seed_pos += 1
        if seed_pos >= n:
            break
        frontier = np.array([seed_order[seed_pos]], np.int64)
        visited[frontier] = True
        while frontier.size:
            chunks.append(frontier)
            neigh = np.unique(_union_neighbors(g, gt, frontier))
            neigh = neigh[~visited[neigh]]
            visited[neigh] = True
            # degree-sorted next level (unique already id-sorts; the stable
            # sort keeps the id tiebreak)
            frontier = neigh[np.argsort(deg[neigh], kind="stable")]
    chunks.append(np.flatnonzero(isolated))
    order = np.concatenate(chunks)
    return order[::-1].astype(np.int64).copy()   # the "reverse" in RCM


def permute_csr(g: Csr, order: np.ndarray) -> Csr:
    """Relabel vertices: new id i is old vertex ``order[i]``.  O(E); each
    row keeps its edge order, mapped through the new ids (so rows are not
    sorted)."""
    n = g.num_nodes
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    lens = np.diff(g.row_ptr)[order]
    row_ptr = np.zeros(n + 1, E_DTYPE)
    np.cumsum(lens, out=row_ptr[1:])
    starts_old = g.row_ptr[:-1][order]
    E = g.num_edges
    base = np.repeat(starts_old - row_ptr[:-1], lens)
    col_idx = rank[g.col_idx[base + np.arange(E)]].astype(V_DTYPE)
    return Csr(n, E, row_ptr, col_idx)


def maybe_reorder_dataset(ds, mode):
    """Apply the RCM pass per ``mode``: "on"/True always, "auto" only when
    it cuts the padded rows (:func:`padded_rows`) by at least 10%.
    Returns (dataset, applied: bool, note: str)."""
    if mode in (False, None, "off"):
        return ds, False, ""
    order = rcm_order(ds.graph)
    if mode in (True, "on"):
        ds2, _ = reorder_dataset(ds, order)
        return ds2, True, "RCM locality reorder applied"
    if mode != "auto":
        raise ValueError(f"reorder mode {mode!r}: on|off|auto")
    before = padded_rows(ds.graph)
    gp = permute_csr(ds.graph, order)
    after = padded_rows(gp)
    if after <= 0.9 * before:
        ds2, _ = reorder_dataset(ds, order, graph=gp)
        return ds2, True, (f"RCM locality reorder kept: padded rows "
                           f"{before} -> {after} "
                           f"({after / max(before, 1):.2f}x)")
    return ds, False, (f"RCM locality reorder skipped: padded rows "
                       f"{before} -> {after} (< 10% gain)")


def reorder_dataset(ds, order: np.ndarray = None, graph: Csr = None):
    """Apply a locality order to a whole dataset (graph and every
    per-vertex array).  Training on the result is isomorphic to the
    original (the same losses up to fp32 reassociation), because features,
    labels and masks move with their vertices.  Returns (new_dataset,
    order).  ``graph`` may pass the already-permuted CSR."""
    from roc_tpu_torch.graph.datasets import Dataset
    if order is None:
        order = rcm_order(ds.graph)
    g = graph if graph is not None else permute_csr(ds.graph, order)
    return Dataset(
        name=ds.name, graph=g,
        features=ds.features[order],
        labels=None if ds.labels is None else ds.labels[order],
        label_ids=ds.label_ids[order],
        mask=ds.mask[order],
        in_dim=ds.in_dim, num_classes=ds.num_classes), order
