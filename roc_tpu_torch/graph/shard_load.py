"""Per-host partition loading (roc_tpu/graph/shard_load.py, NumPy,
element for element): ``-perhost``.

Reference analog: each Legion point task seeks only its partition's byte
ranges of the ``.lux`` file (load_task.cu:201-245): no node ever holds the
whole topology.

  * process 0 reads only the row-offset section (8 bytes a vertex), runs
    the greedy edge-balanced cut and shares the packed O(P) geometry
    (:class:`roc_tpu_torch.graph.partition.PartitionMeta`);
  * every process then reads only its local parts' row and column slices
    and builds only their padded edge arrays;
  * the halo maps need what each *other* part's edges reference of ours,
    so the row-index lists are exchanged host-side: one allgather of the
    O(P^2) size matrix, one of the padded [L, P, K] need lists.

Edge sharding reads its blocks the same way (:func:`load_edge_blocks`):
the dst-sorted edge list is the ``.lux`` column section, so block b is a
byte range of it plus the covering row offsets, found by binary search;
the transposed sidecar (``lux.TLUX_SUFFIX``) gives the backward's
src-sorted blocks.

The exchange is injected: ``allgather(x) -> [num_processes, *x.shape]``,
process-major.  :func:`single_process_allgather` serves one process;
:func:`torch_allgather` the ranks of ``-multihost`` (over
``torch.distributed``, int64 intact); :class:`ThreadAllGather` N threads
of one process (the tests' stand-in for N processes).  The outputs equal
the single-host ``partition_graph``, ``build_halo_maps`` and
``edge_block_arrays`` arrays, bit for bit.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Sequence

import numpy as np

from roc_tpu_torch.graph.csr import E_DTYPE, V_DTYPE
from roc_tpu_torch.graph.lux import read_cols_slice, read_header, \
    read_rows_slice
from roc_tpu_torch.graph.partition import (_EDGE_ALIGN, PartitionMeta,
                                          _round_up, compute_meta)

AllGather = Callable[[np.ndarray], np.ndarray]


def allgather_floors(counts, allgather) -> "list[int]":
    """Cross-process shape floors: local per-side maxima, allgathered, the
    global maxima.  ``counts``: [n_sides][n_local_shards] ints;
    ``allgather`` None (single-process) returns the local maxima."""
    local = np.asarray(counts, np.int64).max(axis=1)
    if allgather is None:
        return [int(v) for v in local]
    g = np.asarray(allgather(local)).max(axis=0)
    return [int(v) for v in np.reshape(g, -1)]


def single_process_allgather(x: np.ndarray) -> np.ndarray:
    return np.asarray(x)[None]


def torch_allgather() -> AllGather:
    """The allgather of the running ``-multihost`` process group
    (roc_tpu's ``jax_allgather``): host arrays cross as themselves, so an
    int64 count past 2^31 arrives whole."""
    from roc_tpu_torch.parallel import collectives
    if collectives.group() is None:
        raise RuntimeError("torch_allgather needs the -multihost process "
                           "group (collectives.init_process_group)")
    return collectives.allgather_np


class ThreadAllGather:
    """The allgather of N threads in one process, each thread standing for
    a process: ``for_process(i)`` is thread i's exchange."""

    def __init__(self, nproc: int):
        self.nproc = nproc
        self.barrier = threading.Barrier(nproc)
        self.slots = [None] * nproc

    def for_process(self, i: int) -> AllGather:
        def allgather(x):
            self.slots[i] = np.asarray(x).copy()
            self.barrier.wait()           # all slots filled
            out = np.stack(self.slots)
            self.barrier.wait()           # all readers done before reuse
            return out
        return allgather


def _pack_meta(meta: PartitionMeta) -> np.ndarray:
    return np.concatenate([
        np.asarray([meta.num_parts, meta.shard_nodes, meta.shard_edges,
                    meta.num_nodes, meta.num_edges], np.int64),
        meta.bounds.reshape(-1).astype(np.int64),
        meta.num_edges_valid.astype(np.int64),
        meta.edge_starts.astype(np.int64),
    ])


def _unpack_meta(buf: np.ndarray) -> PartitionMeta:
    P = int(buf[0])
    bounds = buf[5:5 + 2 * P].reshape(P, 2).copy()
    return PartitionMeta(
        num_parts=P, shard_nodes=int(buf[1]), shard_edges=int(buf[2]),
        num_nodes=int(buf[3]), num_edges=int(buf[4]), bounds=bounds,
        num_valid=np.maximum(bounds[:, 1] - bounds[:, 0] + 1, 0),
        num_edges_valid=buf[5 + 2 * P:5 + 3 * P].copy(),
        edge_starts=buf[5 + 3 * P:5 + 4 * P].copy())


def meta_from_lux(path: str, num_parts: int, process_index: int = 0,
                  allgather: AllGather = single_process_allgather,
                  bounds=None, shard_nodes: int = 0,
                  shard_edges: int = 0) -> PartitionMeta:
    """Compute (on process 0) and share the partition geometry.  Only
    process 0 reads the O(N) row offsets and runs the cut; every process
    receives the packed O(P) result through the allgather (a broadcast is
    an allgather read at row 0).  ``bounds`` / ``shard_nodes`` /
    ``shard_edges`` pass through to ``compute_meta`` (an external cut under
    a frozen padded shape), validated before any byte range is derived
    from them."""
    if process_index == 0:
        num_nodes, num_edges = read_header(path)
        raw_rows = read_rows_slice(path, 0, num_nodes)
        row_ptr = np.zeros(num_nodes + 1, dtype=E_DTYPE)
        row_ptr[1:] = raw_rows.astype(E_DTYPE)
        if not np.all(np.diff(row_ptr) >= 0):
            raise ValueError(f"non-monotone .lux row offsets in {path}: "
                             "edge ranges would overlap or run backwards")
        meta = compute_meta(row_ptr, num_parts, bounds=bounds,
                            shard_nodes=shard_nodes or None,
                            shard_edges=shard_edges or None)
        packed = _pack_meta(meta)
    else:
        packed = np.zeros(5 + 4 * num_parts, np.int64)
    shared = allgather(packed)[0]
    return _unpack_meta(shared)


@dataclasses.dataclass(frozen=True)
class LocalShards:
    """Edge arrays for this process's parts only (L = len(part_ids) rows,
    each laid out and padded as :class:`Partition`'s are)."""
    part_ids: tuple
    edge_src: np.ndarray   # [L, E] padded-global source ids
    edge_dst: np.ndarray   # [L, E] local dest rows, ascending
    in_degree: np.ndarray  # [L, S] float32, 1.0 on pad rows
    node_mask: np.ndarray  # [L, S] bool

    def nbytes(self) -> int:
        return (self.edge_src.nbytes + self.edge_dst.nbytes
                + self.in_degree.nbytes + self.node_mask.nbytes)


def load_local_shards(path: str, meta: PartitionMeta,
                      part_ids: Sequence[int]) -> LocalShards:
    """The padded edge arrays of ``part_ids``, reading only those parts'
    ``.lux`` byte ranges (the reference's per-partition seek,
    load_task.cu:231-243)."""
    L = len(part_ids)
    S, E = meta.shard_nodes, meta.shard_edges
    edge_src = np.zeros((L, E), dtype=E_DTYPE)
    edge_dst = np.zeros((L, E), dtype=V_DTYPE)
    in_degree = np.ones((L, S), dtype=np.float32)
    node_mask = np.zeros((L, S), dtype=bool)
    uppers = meta.bounds[:, 1]
    for i, p in enumerate(part_ids):
        lo, hi = meta.bounds[p]
        n = int(meta.num_valid[p])
        ne = int(meta.num_edges_valid[p])
        if n > 0:
            e0 = int(meta.edge_starts[p])
            # local row offsets -> per-vertex degrees for vertices lo..hi
            ends = read_rows_slice(path, lo, hi + 1).astype(np.int64)
            deg = np.diff(np.concatenate([[e0], ends]))
            in_degree[i, :n] = deg.astype(np.float32)
            node_mask[i, :n] = True
            if ne > 0:
                src_global = read_cols_slice(path, meta.num_nodes, e0,
                                             e0 + ne).astype(np.int64)
                owner = np.searchsorted(uppers, src_global, side="left")
                edge_src[i, :ne] = (owner * S + src_global
                                    - meta.bounds[owner, 0]).astype(E_DTYPE)
                # dst of edge e = vertex whose CSR range contains e
                edge_dst[i, :ne] = np.repeat(
                    np.arange(n, dtype=np.int64), deg).astype(V_DTYPE)
        # pad edges (and whole rows of empty parts): source = this part's
        # first pad row (zero features), dst = last pad row, keeping
        # edge_dst ascending — partition_graph's rules
        edge_src[i, ne:] = p * S + n
        edge_dst[i, ne:] = S - 1
    return LocalShards(part_ids=tuple(part_ids), edge_src=edge_src,
                       edge_dst=edge_dst, in_degree=in_degree,
                       node_mask=node_mask)


def load_local_degrees(path: str, meta: PartitionMeta,
                       part_ids: Sequence[int]) -> np.ndarray:
    """[L, S] in-degrees of this process's parts (1.0 on pad rows),
    without the column reads."""
    L, S = len(part_ids), meta.shard_nodes
    in_degree = np.ones((L, S), dtype=np.float32)
    for i, p in enumerate(part_ids):
        lo, hi = meta.bounds[p]
        n = int(meta.num_valid[p])
        if n > 0:
            e0 = int(meta.edge_starts[p])
            ends = read_rows_slice(path, lo, hi + 1).astype(np.int64)
            in_degree[i, :n] = np.diff(
                np.concatenate([[e0], ends])).astype(np.float32)
    return in_degree


def _bisect_rows(path: str, target: int, num_nodes: int) -> int:
    """The smallest vertex v whose inclusive end offset exceeds
    ``target``: the vertex whose CSR range holds edge ``target``, in
    O(log N) 8-byte reads (no O(N) array is ever resident)."""
    lo, hi = 0, num_nodes
    while lo < hi:
        mid = (lo + hi) // 2
        if int(read_rows_slice(path, mid, mid + 1)[0]) > target:
            hi = mid
        else:
            lo = mid + 1
    return lo


def load_edge_blocks(path: str, meta: PartitionMeta,
                     block_ids: Sequence[int]):
    """These blocks of the exactly-edge-balanced cut, equal to
    ``edge_block_arrays(g, meta)[block_ids]`` but reading only their byte
    ranges: block b is columns [b*Eb, (b+1)*Eb) plus the row offsets that
    cover them.  The ``TLUX_SUFFIX`` file gives the transposed
    (src-sorted) blocks of the backward, with the same ``meta`` (the
    vertex partition lives on the original orientation).

    Returns (gather [L, Eb], scatter [L, Eb]) padded-global int64."""
    P, S = meta.num_parts, meta.shard_nodes
    E = meta.num_edges
    num_nodes, num_edges_f = read_header(path)
    if num_nodes != meta.num_nodes or num_edges_f != E:
        raise ValueError(
            f"{path}: header ({num_nodes}, {num_edges_f}) != meta "
            f"({meta.num_nodes}, {E}): wrong or mismatched transpose "
            f"sidecar?")
    Eb = _round_up(-(-E // P), _EDGE_ALIGN)
    L = len(block_ids)
    gather = np.zeros((L, Eb), dtype=np.int64)
    scatter = np.zeros((L, Eb), dtype=np.int64)
    for i, b in enumerate(block_ids):
        # a late block can start past E (few edges, many parts): its row
        # is all pad edges, as edge_block_arrays' tail
        e0 = b * Eb
        ne = max(min((b + 1) * Eb, E) - e0, 0)
        e1 = e0 + ne
        if ne > 0:
            src_global = read_cols_slice(path, num_nodes, e0,
                                         e1).astype(np.int64)
            # the vertices whose ranges meet [e0, e1): v0 owns edge e0
            v0 = _bisect_rows(path, e0, num_nodes)
            v1 = _bisect_rows(path, e1 - 1, num_nodes)
            ends = read_rows_slice(path, v0, v1 + 1).astype(np.int64)
            starts = np.concatenate(
                [read_rows_slice(path, v0 - 1, v0).astype(np.int64)
                 if v0 else np.zeros(1, np.int64), ends[:-1]])
            deg_in_blk = (np.minimum(ends, e1)
                          - np.maximum(starts, e0)).clip(min=0)
            dst_global = np.repeat(np.arange(v0, v1 + 1), deg_in_blk)
            gather[i, :ne] = meta.to_padded(src_global)
            scatter[i, :ne] = meta.to_padded(dst_global)
        # pad edges, edge_block_arrays' recipe: src = part 0's first pad
        # row (zero features), dst = the global last pad row
        gather[i, ne:] = int(meta.num_valid[0])
        scatter[i, ne:] = P * S - 1
    return gather, scatter


@dataclasses.dataclass(frozen=True)
class LocalHalo:
    """This process's rows of the halo maps (parallel/halo.py's HaloMaps:
    the same K and contents, restricted to part_ids)."""
    K: int
    part_ids: tuple
    send_idx: np.ndarray        # [L, P, K] int32
    edge_src_local: np.ndarray  # [L, E] int32 into [S local ++ P*K recv]
    halo_rows_total: int


def build_halo_local(meta: PartitionMeta, local: LocalShards,
                     allgather: AllGather = single_process_allgather
                     ) -> LocalHalo:
    """Halo maps of the local parts by a host-side index exchange: the
    per-(dest, owner) sorted-unique row lists are allgathered, first the
    O(P^2) size matrix (it fixes the global pad width K), then the padded
    [L, P, K] need lists; send_idx is the transpose of the assembled need
    tensor, without any process reading another's edges."""
    part_ids = local.part_ids
    L, P, S = len(part_ids), meta.num_parts, meta.shard_nodes
    need: List[dict] = []   # per local part: {owner q: sorted unique locals}
    sizes = np.zeros((P, P), np.int64)   # [dest p, owner q]
    for i, p in enumerate(part_ids):
        src = local.edge_src[i]
        owner = src // S
        remote = owner != p
        per_owner = {}
        for q in np.unique(owner[remote]):
            locals_q = np.unique(src[remote & (owner == q)] - q * S)
            per_owner[int(q)] = locals_q
            sizes[p, int(q)] = len(locals_q)
        need.append(per_owner)

    all_sizes = allgather(sizes).sum(axis=0)   # disjoint rows: sum = union
    K = max(int(all_sizes.max()), 1)
    halo_total = int(all_sizes.sum())

    # Pad value S-1 is a guaranteed pad row (partition.py keeps >=1 pad row
    # per part) whose features are zero.
    my_need = np.full((L, P, K), S - 1, dtype=np.int32)
    for i in range(L):
        for q, rows in need[i].items():
            my_need[i, q, :len(rows)] = rows
    gathered = allgather(my_need)               # [nproc, L, P, K]
    assert gathered.shape[0] * L == P, (
        "uneven parts per process: per-host loading needs P divisible by "
        "process count")
    full_need = gathered.reshape(P, P, K)       # [dest p, owner q, K]
    send_full = full_need.transpose(1, 0, 2)    # [owner q, dest p, K]
    send_idx = np.ascontiguousarray(send_full[list(part_ids)])

    edge_src_local = np.empty((L, meta.shard_edges), dtype=np.int32)
    for i, p in enumerate(part_ids):
        src = local.edge_src[i]
        owner = (src // S).astype(np.int64)
        local_row = (src - owner * S).astype(np.int64)
        out = np.empty(meta.shard_edges, dtype=np.int64)
        own = owner == p
        out[own] = local_row[own]
        for q, rows in need[i].items():
            sel = owner == q
            pos = np.searchsorted(rows, local_row[sel])
            out[sel] = S + q * K + pos
        edge_src_local[i] = out
    return LocalHalo(K=K, part_ids=part_ids, send_idx=send_idx,
                     edge_src_local=edge_src_local,
                     halo_rows_total=halo_total)
