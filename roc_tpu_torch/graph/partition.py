"""Edge-balanced contiguous vertex partitioning and the padded shard
layout (roc_tpu/graph/partition.py, NumPy, bit for bit).

The reference cuts contiguous vertex ranges whose in-edge counts stay
under ``ceil(E/P)`` (gnn.cc:806-829); each part is padded to a common
shard size S (nodes) and E (edges) with inert padding: pad nodes carry
zero features, in-degree 1 and mask NONE; pad edges source at a pad node
(+0 to any sum) and end at the shard's last pad row (which keeps each
shard's destinations ascending).  The streaming executor rotates these
shards through its device slots.  The cut runs in C++
(``roc_tpu_torch.native``, as roc_tpu's does) unless
``ROC_TPU_NO_NATIVE=1``; its Python scan is the oracle it is held to.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from roc_tpu_torch import native
from roc_tpu_torch.graph.csr import Csr, E_DTYPE, V_DTYPE

# roc_tpu's alignment of the padded shapes (its TPU tiles), kept so the
# shards are roc_tpu's element for element.
_NODE_ALIGN = 8
_EDGE_ALIGN = 8


def edge_balanced_bounds(g: Csr, num_parts: int) -> List[Tuple[int, int]]:
    """Greedy cut over a CSR graph (see :func:`bounds_from_row_ptr`)."""
    return bounds_from_row_ptr(g.row_ptr, num_parts)


def bounds_from_row_ptr(row_ptr: np.ndarray,
                        num_parts: int) -> List[Tuple[int, int]]:
    """The reference's greedy cut (gnn.cc:806-829): accumulate in-degrees,
    cut when the running count *exceeds* ceil(E/P).  Returns inclusive
    (lo, hi) vertex bounds per part.  Needs only the exclusive-prefix row
    pointer — the per-host loader calls this without ever reading edge
    columns.

    The reference simply asserts it got exactly P parts (gnn.cc:829); that
    can fail for skewed graphs (a huge-degree vertex early eats several
    caps).  We keep the identical cut rule but repair the result when it
    yields != P parts by splitting the largest parts / merging empties, so
    the partitioner totals P for any graph.
    """
    assert num_parts >= 1
    num_nodes = len(row_ptr) - 1
    num_edges = int(row_ptr[-1])
    if num_nodes == 0:
        return [(0, -1)] * num_parts
    if native.enabled():
        _, nb = native.partition(row_ptr[1:], num_edges, num_parts)
        bounds = [tuple(int(v) for v in b) for b in nb]
    else:
        bounds = _python_bounds(row_ptr, num_parts)
    # Repair (reference would assert instead):
    while len(bounds) > num_parts:  # merge the two lightest neighbors
        w = [int(row_ptr[hi + 1] - row_ptr[lo]) for lo, hi in bounds]
        i = int(np.argmin([w[j] + w[j + 1] for j in range(len(bounds) - 1)]))
        bounds[i] = (bounds[i][0], bounds[i + 1][1])
        del bounds[i + 1]
    while len(bounds) < num_parts:  # split the part with the most vertices
        sizes = [hi - lo + 1 for lo, hi in bounds]
        i = int(np.argmax(sizes))
        lo, hi = bounds[i]
        if hi <= lo:  # cannot split single-vertex parts further: emit empties
            bounds.append((num_nodes, num_nodes - 1))
            continue
        mid = (lo + hi) // 2
        bounds[i] = (lo, mid)
        bounds.insert(i + 1, (mid + 1, hi))
    return bounds


def _python_bounds(row_ptr: np.ndarray,
                   num_parts: int) -> List[Tuple[int, int]]:
    """The greedy cut as a NumPy scan (the oracle of the native C++
    cut)."""
    deg = np.diff(row_ptr)
    num_nodes = len(row_ptr) - 1
    num_edges = int(row_ptr[-1])
    edge_cap = (num_edges + num_parts - 1) // num_parts
    bounds: List[Tuple[int, int]] = []
    left, cnt = 0, 0
    for v in range(num_nodes):
        cnt += int(deg[v])
        if cnt > edge_cap:
            bounds.append((left, v))
            cnt = 0
            left = v + 1
    if cnt > 0 or left < num_nodes:
        bounds.append((left, num_nodes - 1))
    return bounds


def _round_up(x: int, align: int) -> int:
    return (x + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class PartitionMeta:
    """Partition geometry: everything global about the shard layout that is
    O(P) to store — vertex bounds, padded shapes, live counts — plus the
    global↔padded vertex-id mapping; :class:`Partition` extends it with
    the full per-part arrays.

      bounds          [P, 2]  inclusive global vertex range per part
      num_valid       [P]     live nodes per shard
      num_edges_valid [P]     live edges per shard
      edge_starts     [P]     global edge offset of each part's first edge
    """

    num_parts: int
    shard_nodes: int
    shard_edges: int
    num_nodes: int
    num_edges: int
    bounds: np.ndarray
    num_valid: np.ndarray
    num_edges_valid: np.ndarray
    edge_starts: np.ndarray

    # -- vertex id mapping ------------------------------------------------
    def to_padded(self, v: np.ndarray) -> np.ndarray:
        """Map global vertex ids to padded ids p*S + (v - lo_p)."""
        part = np.searchsorted(self.bounds[:, 1], v, side="left")
        return (part * self.shard_nodes + v - self.bounds[part, 0]).astype(E_DTYPE)

    def pad_nodes(self, x: np.ndarray, fill=0) -> np.ndarray:
        """[N, ...] node array -> [P*S, ...] padded (shard-major) array."""
        return np.concatenate(
            [self.pad_part(x, p, fill) for p in range(self.num_parts)],
            axis=0)

    def pad_part(self, x: np.ndarray, p: int, fill=0,
                 dtype=None) -> np.ndarray:
        """One part's padded [S, ...] block, touching only rows
        [lo_p, hi_p] of ``x`` — with a memmapped ``x`` this reads just this
        part's bytes from disk (sharded host loading; the analog of the
        reference's per-partition `.lux` seeking, load_task.cu:231-243)."""
        lo, hi = self.bounds[p]
        n = max(int(hi - lo + 1), 0)
        out = np.full((self.shard_nodes,) + x.shape[1:], fill,
                      dtype=dtype or x.dtype)
        if n > 0:
            out[:n] = x[lo: hi + 1]
        return out

    def unpad_nodes(self, x: np.ndarray) -> np.ndarray:
        """Inverse of pad_nodes (drops pad rows)."""
        parts = []
        for p in range(self.num_parts):
            n = int(self.num_valid[p])
            parts.append(x[p * self.shard_nodes: p * self.shard_nodes + n])
        return np.concatenate(parts, axis=0)


@dataclasses.dataclass(frozen=True)
class Partition(PartitionMeta):
    """Device-ready padded shard layout for a partitioned graph: the meta
    geometry plus full per-part arrays.

    Array shapes (P parts, S padded nodes/shard, E padded edges/shard):
      edge_src        [P, E]  per-edge source as *padded global* id in [0, P*S)
      edge_dst        [P, E]  per-edge dest as *local* row in [0, S), ascending
      in_degree       [P, S]  float32 in-degrees, 1.0 on pad rows
      node_mask       [P, S]  bool, True on live rows
    """

    edge_src: np.ndarray
    edge_dst: np.ndarray
    in_degree: np.ndarray
    node_mask: np.ndarray

    @property
    def meta(self) -> PartitionMeta:
        return PartitionMeta(
            num_parts=self.num_parts, shard_nodes=self.shard_nodes,
            shard_edges=self.shard_edges, num_nodes=self.num_nodes,
            num_edges=self.num_edges, bounds=self.bounds,
            num_valid=self.num_valid, num_edges_valid=self.num_edges_valid,
            edge_starts=self.edge_starts)


def validate_bounds(bounds: np.ndarray, num_nodes: int) -> None:
    """Check that inclusive (lo, hi) bounds contiguously cover [0, num_nodes).

    Empty parts are encoded hi < lo (the repair loops emit
    ``(num_nodes, num_nodes - 1)``); non-empty parts must tile the vertex
    range in ascending order with no gaps — the contract every consumer of
    ``PartitionMeta.bounds`` (to_padded's searchsorted, the per-host byte
    ranges, the balancer's proposals) relies on.
    """
    bounds = np.asarray(bounds, dtype=np.int64)
    nxt = 0
    for lo, hi in bounds:
        if hi < lo:  # empty part
            continue
        if lo != nxt:
            raise ValueError(
                f"bounds not contiguous: part starts at {lo}, expected {nxt}")
        nxt = int(hi) + 1
    if nxt != num_nodes:
        raise ValueError(
            f"bounds cover [0, {nxt}) but graph has {num_nodes} nodes")


def compute_meta(row_ptr: np.ndarray, num_parts: int,
                 bounds: np.ndarray | None = None,
                 shard_nodes: int | None = None,
                 shard_edges: int | None = None) -> PartitionMeta:
    """Partition geometry from the row pointer alone (no edge columns).

    ``bounds`` overrides the greedy cut with an externally proposed cut (the
    online balancer's path); ``shard_nodes``/``shard_edges`` force the padded
    shard shape so a reshard keeps the same S/E (and every buffer sized
    from them).  Forced shapes must still fit the cut.
    """
    if bounds is None:
        bounds = np.asarray(bounds_from_row_ptr(row_ptr, num_parts),
                            dtype=np.int64)
    else:
        bounds = np.asarray(bounds, dtype=np.int64)
        if bounds.shape != (num_parts, 2):
            raise ValueError(f"bounds shape {bounds.shape} != ({num_parts}, 2)")
        validate_bounds(bounds, len(row_ptr) - 1)
    num_valid = np.maximum(bounds[:, 1] - bounds[:, 0] + 1, 0)
    # Always leave >=1 pad row per shard so pad edges have a zero source row
    # to point at even in the fullest shard.
    need_nodes = _round_up(int(num_valid.max()) + 1, _NODE_ALIGN)
    if shard_nodes is None:
        shard_nodes = need_nodes
    elif shard_nodes < need_nodes:
        raise ValueError(
            f"shard_nodes={shard_nodes} cannot hold {int(num_valid.max())} "
            f"nodes + 1 pad row (need >= {need_nodes})")
    edge_lo = row_ptr[np.maximum(bounds[:, 0], 0)]
    edge_hi = row_ptr[bounds[:, 1] + 1]
    num_edges_valid = np.where(num_valid > 0, edge_hi - edge_lo, 0)
    need_edges = max(_round_up(int(num_edges_valid.max()), _EDGE_ALIGN),
                     _EDGE_ALIGN)
    if shard_edges is None:
        shard_edges = need_edges
    elif shard_edges < need_edges:
        raise ValueError(
            f"shard_edges={shard_edges} cannot hold "
            f"{int(num_edges_valid.max())} edges (need >= {need_edges})")
    return PartitionMeta(
        num_parts=num_parts, shard_nodes=shard_nodes,
        shard_edges=shard_edges, num_nodes=len(row_ptr) - 1,
        num_edges=int(row_ptr[-1]), bounds=bounds,
        num_valid=num_valid.astype(np.int64),
        num_edges_valid=np.asarray(num_edges_valid, np.int64),
        edge_starts=np.asarray(edge_lo, np.int64))


def edge_block_arrays(g: Csr, part: PartitionMeta):
    """Exactly-edge-balanced blocks for the edge-sharded aggregation mode
    (roc_tpu/parallel/spmd.py, `-edge-shard`).

    The vertex partitioner cannot split a vertex's in-edges, so a hub
    vertex overruns the edge cap and every other shard pays the padded-max
    tax (see SpmdTrainer._log_shard_stats).  Here the dst-sorted edge list
    is cut into P blocks of exactly ceil(E/P) edges — mid-vertex cuts
    allowed, padding tax ~0 regardless of skew.  Both endpoints are padded
    global ids; dst stays nondecreasing (padded ids are monotone in global
    vertex id), so each block's segment-sum is still a sorted reduction.

    Returns (edge_src [P, Eb], edge_dst [P, Eb]), both padded-global.
    """
    P, S = part.num_parts, part.shard_nodes
    Eb = _round_up(-(-g.num_edges // P), _EDGE_ALIGN)
    src = part.to_padded(g.col_idx)
    dst = part.to_padded(g.dst_idx)
    pad = P * Eb - g.num_edges
    # pad edges: src = a guaranteed zero-feature pad row (part 0's first pad
    # row), dst = the global last pad row (keeps dst ascending; its sums are
    # dropped with the padding)
    src = np.concatenate([src, np.full(pad, int(part.num_valid[0]), E_DTYPE)])
    dst = np.concatenate([dst, np.full(pad, P * S - 1, E_DTYPE)])
    return src.reshape(P, Eb), dst.reshape(P, Eb)


def edge_block_arrays_t(g: Csr, part: PartitionMeta):
    """Transposed edge blocks for the backward of edge-sharded aggregation:
    the gradient flow dx[u] = Σ_{e: src(e)=u} g[dst(e)] is itself an edge
    aggregation with roles swapped, so the same exactly-equal cuts apply to
    the *src*-sorted edge list.  Sorting by src makes each block's scatter
    targets a contiguous padded-id range — the property the windowed chunk
    plans need (mirrors the reference re-launching its forward kernel with
    roles swapped, scattergather_kernel.cu:160-170, at block granularity).

    Returns (gather [P, Eb], scatter [P, Eb]): gather = padded dst ids
    (rows of the all-gathered gradient), scatter = padded src ids,
    nondecreasing within each block.  Implemented as edge_block_arrays of
    the transposed CSR so the pad-edge recipe lives in exactly one place
    (Csr.transpose's stable sort makes this element-identical to sorting
    the in-edge list by src)."""
    return edge_block_arrays(g.transpose(), part)


def partition_graph(g: Csr, num_parts: int,
                    bounds: np.ndarray | None = None,
                    shard_nodes: int | None = None,
                    shard_edges: int | None = None) -> Partition:
    """Partition + pad a CSR into the static shard layout described above.

    The optional overrides (see :func:`compute_meta`) are the epoch-boundary
    resharding path: a new cut under the old padded S/E.
    """
    g.validate()
    meta = compute_meta(g.row_ptr, num_parts, bounds=bounds,
                        shard_nodes=shard_nodes, shard_edges=shard_edges)
    bounds = meta.bounds
    num_valid = meta.num_valid
    num_edges_valid = meta.num_edges_valid
    P, S, E = num_parts, meta.shard_nodes, meta.shard_edges
    # Precompute the global->padded permutation for edge source remapping.
    part_of = np.zeros(g.num_nodes, dtype=np.int64)
    local_of = np.zeros(g.num_nodes, dtype=np.int64)
    for p in range(P):
        lo, hi = bounds[p]
        if hi >= lo:
            part_of[lo: hi + 1] = p
            local_of[lo: hi + 1] = np.arange(hi - lo + 1)
    padded_id = part_of * S + local_of

    edge_src = np.zeros((P, E), dtype=E_DTYPE)
    edge_dst = np.zeros((P, E), dtype=V_DTYPE)
    dst_all = g.dst_idx
    for p in range(P):
        lo, hi = bounds[p]
        ne = int(num_edges_valid[p])
        if ne == 0:
            # whole row is padding: src = this shard's first pad row
            edge_src[p, :] = p * S + int(num_valid[p])
            edge_dst[p, :] = S - 1
            continue
        e0 = int(g.row_ptr[lo])
        edge_src[p, :ne] = padded_id[g.col_idx[e0: e0 + ne]]
        edge_dst[p, :ne] = (dst_all[e0: e0 + ne] - lo).astype(V_DTYPE)
        # pad edges: source = this shard's first pad row (zero features),
        # dst = last pad row (S-1 is always padding since num_valid < S) so
        # edge_dst stays ascending — segment_sum is told indices_are_sorted
        edge_src[p, ne:] = p * S + int(num_valid[p])
        edge_dst[p, ne:] = S - 1

    deg = np.diff(g.row_ptr).astype(np.float32)
    in_degree = np.ones((P, S), dtype=np.float32)
    node_mask = np.zeros((P, S), dtype=bool)
    for p in range(P):
        lo, hi = bounds[p]
        n = int(num_valid[p])
        if n > 0:
            in_degree[p, :n] = deg[lo: hi + 1]
            node_mask[p, :n] = True

    return Partition(
        **{f.name: getattr(meta, f.name)
           for f in dataclasses.fields(PartitionMeta)},
        edge_src=edge_src, edge_dst=edge_dst,
        in_degree=in_degree, node_mask=node_mask,
    )
