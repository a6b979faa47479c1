"""Host-side in-edge CSR (NumPy), as in roc_tpu/graph/csr.py.

``col_idx[row_ptr[v]:row_ptr[v+1]]`` are the sources of v's in-edges (the
reference's orientation); ``row_ptr`` is the exclusive prefix of length N+1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

V_DTYPE = np.int32
E_DTYPE = np.int64


@dataclasses.dataclass(frozen=True)
class Csr:
    """In-edge CSR: col_idx[row_ptr[v]:row_ptr[v+1]] = sources of v's in-edges."""

    num_nodes: int
    num_edges: int
    row_ptr: np.ndarray  # [N+1] E_DTYPE, exclusive prefix, row_ptr[0]==0
    col_idx: np.ndarray  # [E]   V_DTYPE, source vertex per edge

    def __post_init__(self):
        if self.row_ptr.shape != (self.num_nodes + 1,):
            raise ValueError("row_ptr must have num_nodes + 1 entries")
        if self.col_idx.shape != (self.num_edges,):
            raise ValueError("col_idx must have num_edges entries")
        if self.row_ptr[0] != 0 or self.row_ptr[-1] != self.num_edges:
            raise ValueError("row_ptr must run from 0 to num_edges")

    def validate(self) -> None:
        """Row offsets monotone, sources in range (raises ValueError)."""
        if np.any(np.diff(self.row_ptr) < 0):
            raise ValueError("row_ptr not monotone")
        if self.num_edges and (self.col_idx.min() < 0
                               or self.col_idx.max() >= self.num_nodes):
            raise ValueError("col_idx out of range [0, num_nodes)")

    @property
    def in_degrees(self) -> np.ndarray:
        """Per-vertex in-degree (row_ptr diffs)."""
        return np.diff(self.row_ptr).astype(E_DTYPE)

    @property
    def dst_idx(self) -> np.ndarray:
        """Per-edge destination vertex, sorted ascending."""
        return np.repeat(np.arange(self.num_nodes, dtype=V_DTYPE),
                         np.diff(self.row_ptr))

    def transpose_order(self) -> np.ndarray:
        """The edge map of the transpose: its edge e' is this CSR's edge
        ``order[e']`` (the stable argsort of ``col_idx``)."""
        return np.argsort(self.col_idx, kind="stable")

    def transpose(self, order: np.ndarray = None) -> "Csr":
        """Out-edge view as a CSR over sources: aggregating over it is the
        backward of aggregating over this one (stable, so equal element by
        element to roc_tpu's transpose).  ``order`` is
        :meth:`transpose_order`'s map, when the caller has it."""
        if order is None:
            order = self.transpose_order()
        new_col = self.dst_idx[order].astype(V_DTYPE)
        counts = np.bincount(self.col_idx, minlength=self.num_nodes)
        new_row = np.zeros(self.num_nodes + 1, dtype=E_DTYPE)
        np.cumsum(counts, out=new_row[1:])
        return Csr(self.num_nodes, self.num_edges, new_row, new_col)


def from_edges(num_nodes: int, src: np.ndarray, dst: np.ndarray) -> Csr:
    """Build an in-edge CSR from an edge list (dedup is the caller's job)."""
    src = np.asarray(src, dtype=V_DTYPE)
    dst = np.asarray(dst, dtype=V_DTYPE)
    if src.shape != dst.shape:
        raise ValueError("src and dst must have the same shape")
    order = np.argsort(dst, kind="stable")
    col_idx = src[order]
    counts = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=E_DTYPE)
    np.cumsum(counts, out=row_ptr[1:])
    return Csr(num_nodes, int(src.shape[0]), row_ptr, col_idx)


def with_edge_delta(g: Csr, add: np.ndarray = None,
                    retire: np.ndarray = None) -> Csr:
    """The rebuild-from-scratch oracle of dynamic deltas (serve/delta.py):
    apply an [n, 2] (src, dst) add list, then a retire list, to ``g`` and
    rebuild through :func:`from_edges`.  A retire removes the *last* live
    instance of its (src, dst), the most recently added one, as the
    incremental patch does; retiring a pair with no live instance raises
    KeyError (the caller classifies no-ops)."""
    src = g.col_idx.astype(np.int64).tolist()
    dst = g.dst_idx.astype(np.int64).tolist()
    alive = [True] * len(src)
    refs: dict = {}
    for gi, sd in enumerate(zip(src, dst)):
        refs.setdefault(sd, []).append(gi)
    if add is not None:
        for s, d in np.asarray(add, np.int64).reshape(-1, 2).tolist():
            refs.setdefault((s, d), []).append(len(src))
            src.append(s)
            dst.append(d)
            alive.append(True)
    if retire is not None:
        for s, d in np.asarray(retire, np.int64).reshape(-1, 2).tolist():
            stack = refs.get((s, d))
            if not stack:
                raise KeyError(f"retire of dead edge ({s}, {d})")
            alive[stack.pop()] = False
    live_s = np.asarray([s for s, a in zip(src, alive) if a], V_DTYPE)
    live_d = np.asarray([d for d, a in zip(dst, alive) if a], V_DTYPE)
    return from_edges(g.num_nodes, live_s, live_d)


def add_self_edges(g: Csr) -> Csr:
    """Add one self-edge per vertex if not already present (idempotent)."""
    src = g.col_idx
    dst = g.dst_idx
    has_self = np.zeros(g.num_nodes, dtype=bool)
    has_self[src[src == dst]] = True
    missing = np.nonzero(~has_self)[0].astype(V_DTYPE)
    if missing.size == 0:
        return g
    return from_edges(g.num_nodes, np.concatenate([src, missing]),
                      np.concatenate([dst, missing]))
