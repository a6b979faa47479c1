"""The SPMD trainer (roc_tpu/parallel/spmd.py): ``-parts N`` without
``-stream``, in three distribution modes and on one process or several.

Each part owns a contiguous vertex range padded to S rows
(graph/partition.py).  Node tensors (features, activations, labels, mask)
hold the parts' S rows stacked in part order; the parts of one mesh
position (parallel/mesh.py) are consecutive, so a position's block is its
k parts' rows, as roc_tpu stacks them inside its shard_map body.

Vertex mode builds every part's source table by one exchange and
aggregates each part over its own CSR:

  halo       (the default) table = the part's own S rows ++ P*K halo rows,
             the rows of the other parts that its in-edges read
             (parallel/halo.py): roc_tpu's one all_to_all, the send
             buffer laid out as ``_overcommit_tables`` lays it (sender
             position, receiver position, sender part, receiver part, K)
  allgather  (``-no-halo``, ``-exchange allgather``) table = all P*S rows

On one device the exchange is a gather: the send buffer is
``x.index_select`` of the send map, and the receiver's halo rows a gather
of that buffer.  With an fp32 wire both collapse into one gather per part.
Autograd transposes the exchange, as AD transposes roc_tpu's
``all_to_all``.  Under ``-bf16-storage`` each sender position's block of
the send buffer (or of the allgather table) goes through the wire codec
(parallel/wire.py).  Aggregation runs ``ops.scatter_gather`` over each
part's CSR: S rows over its table's rows, live edges only (roc_tpu pads
every part to a common edge count for its static TPU shapes).  Under halo
overlap (k = 1, halo, kernel backend, sum/avg; roc_tpu's plan backends)
the part's edges split into a local CSR over its own S rows and a remote
one over the P*K halo rows, and the two sums add.  Attention runs
``ops.gat_attend_kernel`` with the part's own rows and its table.

Ring mode (``-exchange ring``, parallel/ring.py) never builds a table:
at step k position p holds owner (p - k) mod P's rows in wire format,
decodes them, and adds the sum over its (p, owner) group's CSR,
``acc = acc + part`` in step order; max and min fold the port's extreme
path (identity fill, ``torch.maximum``/``minimum``) and zero the rows that
kept the identity.  Ring attention (``_ring_attend``) is roc_tpu's online
softmax: running max m, normalizer z and output u, the finite sentinel
-1e30, each step under ``torch.utils.checkpoint`` (roc_tpu remats it).
On one process the rotation is a change of index and copies nothing;
across processes it is ``collectives.ring_hop``.

Edge mode (``-edge-shard on``, or ``auto`` where the padded-max tax
passes 30 % at k = 1, as roc_tpu decides) cuts the dst-sorted edge list
into P exactly-equal blocks (``graph/partition.py:edge_block_arrays``).
Block b sums over a window of ``span_fwd`` destination rows at
``fwd_base[b]`` from the [P*S, H] table of all rows (an all-gather); the
windows are added into a [P*S, H] accumulator in block order and each
owner takes its S rows (roc_tpu's ``psum_scatter``).  The backward is
not the forward's transpose: ``_EdgeSum`` runs the transposed cut's
blocks (src-sorted, ``edge_block_arrays_t``, their own windows at
``bwd_base``), as roc_tpu's ``_eb_bwd`` does.  roc_tpu's binned edge path
falls back to matmul plans where its occupancy bound fails; that gate is
a TPU artefact (VMEM), and the CUDA kernel has none, so there is no
fallback here.  Edge attention (``_EdgeAttend``) is roc_tpu's
``edge_gat_attend``: block-local maxima, one global max after a stop
gradient, the z and u sums added onto the owners, and its hand-derived
backward.

roc_tpu computes ring attention, edge attention and the collectives in
plain XLA, outside any Pallas kernel; the port writes them in plain
PyTorch (gathers, ``scatter_reduce``, ``index_add_``).  They are not a
port of a Pallas kernel and call no GAT kernel's plain version.  The sums
of every mode run through ``ops.scatter_gather`` (the ``aggregate_sum``
kernel on the card).

One step runs the model once over the parts this process holds: the loss
is the sum of the parts' masked sums (roc_tpu's ``psum(loss_l)``), its
gradients what ``psum(grads_l)`` gives, the ``step.nan`` scale applied
after the sum, and the update goes through ``fault.guarded_update``.
Dropout draws one mask per mesh position over the position's [k*S, d]
block from ``fold_in(fold_in(step_key, position), slot)``
(spmd.py:1833), the position counted globally: roc_tpu's masks, bit for
bit.  Eval metrics are sums over the parts.

``-multihost`` runs one process per device (parallel/collectives.py): a
process holds P / W consecutive positions (k = 1) on its device, its node
tensors hold only their rows, and the exchanges cross processes through
``collectives``: the halo's all-to-all, the allgather, the ring's hop and
edge mode's all-gather, max and reduce-scatter.  The loss, the gradients
and the eval counts are summed across processes, and the update then runs
identically on every process.  The collectives run at any world size,
one included.  ``-perhost`` builds the parts (vertex and ring) or blocks
(edge, with the ``.t.lux`` sidecar) from the ``.lux`` byte ranges
(graph/shard_load.py), the shapes agreed through the allgathered floors.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from roc_tpu_torch import obs, ops
from roc_tpu_torch.fault.guard import guarded_update
from roc_tpu_torch.graph.lux import MASK_NONE, one_hot
from roc_tpu_torch.graph.partition import (Partition, edge_block_arrays,
                                           edge_block_arrays_t,
                                           partition_graph)
from roc_tpu_torch.graph.shard_load import allgather_floors
from roc_tpu_torch.models.model import GraphCtx
from roc_tpu_torch.obs import channel
from roc_tpu_torch.obs.ledger import content_key, get_ledger
from roc_tpu_torch.ops import aggregate as agg_ops
from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.aggregate import _segment_extreme, note_csr_build
from roc_tpu_torch.ops.kernels.gat import Z_GUARD, _lrelu
from roc_tpu_torch.ops.softmax import PerfMetrics
from roc_tpu_torch.parallel import collectives, wire
from roc_tpu_torch.parallel.halo import build_halo_maps, part_csr
from roc_tpu_torch.parallel.mesh import make_mesh, make_process_mesh
from roc_tpu_torch.parallel.ring import (build_ring_groups,
                                         build_ring_groups_arrays,
                                         ring_device_groups)
from roc_tpu_torch.train.driver import Trainer, device_sync
from roc_tpu_torch.train.graph_data import effective_backend, model_has_gat

# The window alignment of roc_tpu's block windows (segment_sum.VB: the
# fp32 sublane tile); the port keeps its arithmetic so that the windows
# are roc_tpu's.
VB = 8
# The "no mass yet" sentinel of the attention recurrences: finite, so no
# exp(-inf - -inf) NaN reaches a gradient (spmd.py:950-955).
NEG = -1e30
# Edges a plain attention chunk gathers at once ([chunk, K, F] floats).
_ATTEND_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass
class PartGraph:
    """One part's graph data on the device (vertex mode)."""
    csr: Optional[ops.DeviceCsr]        # S rows over the part's table
    in_degree: torch.Tensor             # [S] float32, 1.0 on pad rows
    edges: int                          # live in-edges
    csr_local: Optional[ops.DeviceCsr] = None   # halo overlap: own rows
    csr_remote: Optional[ops.DeviceCsr] = None  # halo overlap: P*K rows


@dataclasses.dataclass
class EdgeBlocks:
    """This process's blocks of the edge cut on the device: each block's
    forward CSR (``span_fwd`` rows at ``fwd_base``) and backward CSR over
    the transposed cut (``span_bwd`` rows at ``bwd_base``), both over the
    [P*S] table, live edges only."""
    fwd: List[Optional[ops.DeviceCsr]]
    bwd: List[Optional[ops.DeviceCsr]]
    fwd_base: np.ndarray                # [L]
    bwd_base: np.ndarray                # [L]
    span_fwd: int
    span_bwd: int
    block_edges: int                    # Eb, the cut's block width

    def tensors(self):
        for c in self.fwd + self.bwd:
            if c is not None:
                yield from (t for t in c if t is not None)


@dataclasses.dataclass
class ShardedGraphData:
    """The graph data of the parts this process holds and the exchange's
    index maps."""
    parts: List[PartGraph]              # vertex mode
    in_degree: torch.Tensor             # [L*S], L the parts held here
    num_parts: int
    shard_nodes: int
    k: int                              # parts per mesh position
    exchange: str                       # halo | allgather | ring | edge
    backend: str                        # kernel | xla
    precision: str
    xch: tuple                          # the wire (parallel/wire.py)
    K: int = 0
    send_gidx: Optional[torch.Tensor] = None   # [P*P*K] rows of x
    recv_idx: Optional[torch.Tensor] = None    # [L, P*K] recv-buffer rows
    tbl_idx: Optional[torch.Tensor] = None     # [P, S+P*K] rows of x
    overlap: bool = False
    num_local: int = 0                  # L (P on one process)
    first: int = 0                      # the first part held here
    comm: Optional[collectives.Group] = None   # -multihost
    ring: Optional[list] = None         # [L][P] group CSRs (ring mode)
    edge: Optional[EdgeBlocks] = None   # edge mode

    def __post_init__(self):
        if not self.num_local:
            self.num_local = self.num_parts

    @property
    def positions(self) -> int:
        """Mesh positions held here."""
        return self.num_local // self.k

    @property
    def mode(self) -> str:
        return {"ring": "ring", "edge": "edge"}.get(self.exchange, "vertex")

    def table_rows(self) -> int:
        P, S = self.num_parts, self.shard_nodes
        if self.exchange == "halo":
            return S + P * self.K
        return S if self.exchange == "ring" else P * S

    def nbytes(self) -> int:
        ts = [self.in_degree, self.send_gidx, self.recv_idx, self.tbl_idx]
        for pg in self.parts:
            ts.append(pg.in_degree)
            for c in (pg.csr, pg.csr_local, pg.csr_remote):
                ts += list(c) if c is not None else []
        for row in self.ring or []:
            for c in row:
                ts += list(c) if c is not None else []
        if self.edge is not None:
            ts += list(self.edge.tensors())
        return int(sum(t.numel() * t.element_size() for t in ts
                       if t is not None))


def exchange_index(send_idx: np.ndarray, S: int, k: int):
    """(send_gidx [P*P*K], recv_idx [P, P*K]): the halo send buffer's rows
    of x, ordered (sender position d, receiver position d', sender part i,
    receiver part j, r) as ``_overcommit_tables`` builds each position's
    buffer, and each receiver part's P*K halo rows in that buffer, in
    global part order (the layout ``edge_src_local`` indexes)."""
    P, _, K = send_idx.shape
    D = P // k
    s5 = send_idx.reshape(D, k, D, k, K).transpose(0, 2, 1, 3, 4)
    q = np.arange(D)[:, None] * k + np.arange(k)[None, :]       # [d, i]
    send_gidx = (s5.astype(np.int64)
                 + (q * S)[:, None, :, None, None]).reshape(-1)
    d = np.arange(D)[:, None, None]
    i = np.arange(k)[None, :, None]
    r = np.arange(K)[None, None, :]
    recv_idx = np.empty((P, P * K), np.int64)
    for dt in range(D):
        for j in range(k):
            recv_idx[dt * k + j] = (((d * D + dt) * k + i) * k * K
                                    + j * K + r).reshape(-1)
    return send_gidx, recv_idx


def process_exchange_index(send_idx: np.ndarray, S: int):
    """The halo exchange across processes, L parts held here
    (``send_idx`` [L, P, K], this process's senders): (send [L*P*K] rows
    of the local x in (sender i, receiver part, r) order, recv [L, P*K]
    rows of the all-to-all's output).  Sender i's block is the [P, K, H]
    buffer roc_tpu encodes at that position; the all-to-all's output is
    [source process, sender i, receiver j, K], so receiver j's halo rows
    from part q = s*L + i sit at (q*L + j)*K + r, in global part order."""
    L, P, K = send_idx.shape
    send = (send_idx.astype(np.int64)
            + (np.arange(L) * S)[:, None, None]).reshape(-1)
    q = np.arange(P)[:, None]
    r = np.arange(K)[None, :]
    recv = np.stack([((q * L + j) * K + r).reshape(-1) for j in range(L)])
    return send, recv


def _device_csr(esrc, edst, S: int, T: int, edge_map: bool,
                device) -> ops.DeviceCsr:
    note_csr_build()
    return ops.DeviceCsr(*part_csr(esrc, edst, S, T, edge_map, device))


def shard_graph(edge_src, edge_dst, num_edges, in_degree, send_idx,
                shard_nodes: int, k: int, device, backend: str,
                precision: str, xch: tuple = wire.FP32_WIRE,
                overlap: bool = False, table_csr: bool = True,
                edge_map: bool = False, num_parts: int = 0,
                first: int = 0, comm=None) -> ShardedGraphData:
    """Place the vertex-mode graph data of the parts held here:
    ``edge_src`` [L, E] (table-local under halo, padded-global under
    allgather), ``edge_dst`` [L, E] local rows, ``num_edges`` [L] live
    edges (the rest are pad edges, dropped), ``in_degree`` [L, S],
    ``send_idx`` [L, P, K] or None for allgather.  ``num_parts`` is P (L
    by default: every part here), ``first`` the first part held here.
    ``table_csr`` False skips the combined-table CSR where the overlap
    split serves every aggregation of the model."""
    L = int(np.asarray(edge_src).shape[0])
    P = int(num_parts or L)
    S = int(shard_nodes)
    halo = send_idx is not None
    K = int(send_idx.shape[-1]) if halo else 0
    T = S + P * K if halo else P * S
    parts = []
    for p in range(L):
        ne = int(num_edges[p])
        es = np.asarray(edge_src[p][:ne], np.int64)
        ed = np.asarray(edge_dst[p][:ne], np.int64)
        pg = PartGraph(
            csr=(_device_csr(es, ed, S, T, edge_map, device)
                 if table_csr else None),
            in_degree=torch.as_tensor(np.asarray(in_degree[p], np.float32),
                                      device=device),
            edges=ne)
        if overlap:
            m = es < S
            pg.csr_local = _device_csr(es[m], ed[m], S, S, False, device)
            pg.csr_remote = _device_csr(es[~m] - S, ed[~m], S, P * K,
                                        False, device)
        parts.append(pg)
    gd = ShardedGraphData(
        parts=parts,
        in_degree=torch.as_tensor(np.asarray(in_degree, np.float32)
                                  .reshape(-1), device=device),
        num_parts=P, shard_nodes=S, k=int(k),
        exchange="halo" if halo else "allgather", backend=backend,
        precision=precision, xch=tuple(xch), K=K, overlap=bool(overlap),
        num_local=L, first=int(first), comm=comm)
    if halo and comm is not None:
        send, recv = process_exchange_index(np.asarray(send_idx), S)
        gd.send_gidx = torch.as_tensor(send, device=device)
        gd.recv_idx = torch.as_tensor(recv, device=device)
    elif halo:
        send_gidx, recv_idx = exchange_index(np.asarray(send_idx), S, k)
        gd.send_gidx = torch.as_tensor(send_gidx, device=device)
        gd.recv_idx = torch.as_tensor(recv_idx, device=device)
        # the composed gather of an identity wire (fp32, or a bf16
        # compute dtype under any wire)
        own = np.arange(P)[:, None] * S + np.arange(S)[None, :]
        gd.tbl_idx = torch.as_tensor(
            np.concatenate([own, send_gidx[recv_idx]], axis=1),
            device=device)
    return gd


def ring_graph(rm, num_valid, in_degree, shard_nodes: int, device,
               backend: str, precision: str, xch: tuple,
               num_parts: int, first: int = 0,
               comm=None) -> ShardedGraphData:
    """Place the ring-mode graph data of the parts held here: each
    (part, owner) group's CSR (``ring.ring_device_groups``)."""
    L = rm.ring_src.shape[0]
    return ShardedGraphData(
        parts=[], in_degree=torch.as_tensor(
            np.asarray(in_degree, np.float32).reshape(-1), device=device),
        num_parts=int(num_parts), shard_nodes=int(shard_nodes), k=1,
        exchange="ring", backend=backend, precision=precision,
        xch=tuple(xch), num_local=L, first=int(first), comm=comm,
        ring=ring_device_groups(rm, num_valid, int(shard_nodes), device))


def block_window(keys: np.ndarray, NS: int, allgather=None):
    """(base [L], span): each block's window over its key range, aligned
    to VB, the span raised to the (allgathered) maximum and clamped so that
    base + span <= NS (spmd.py:172-185, ``_block_window``)."""
    keys = np.asarray(keys, np.int64)
    base = (keys.min(axis=1) // VB) * VB
    span = int((keys.max(axis=1) + 1 - base).max())
    span = min(-(-allgather_floors([[span]], allgather)[0] // VB) * VB, NS)
    return np.minimum(base, NS - span), span


def _window_csr(gather, scatter, base: int, span: int, NS: int,
                device) -> Optional[ops.DeviceCsr]:
    """One block's CSR over its window: ``span`` rows (scatter - base)
    over the NS table rows (gather), live edges only (a pad edge scatters
    onto the global last pad row, NS - 1, which no live edge reaches)."""
    scatter = np.asarray(scatter, np.int64)
    live = scatter != NS - 1
    if not live.any():
        return None
    note_csr_build()
    ed = torch.as_tensor(scatter[live] - base, device=device)
    row_ptr = torch.zeros(span + 1, dtype=torch.int64, device=device)
    row_ptr[1:] = torch.cumsum(torch.bincount(ed, minlength=span), 0)
    col = torch.as_tensor(np.asarray(gather, np.int64)[live],
                          device=device).to(torch.int32)
    return ops.DeviceCsr(row_ptr, col)


def edge_graph(f_gat, f_sct, b_gat, b_sct, in_degree, shard_nodes: int,
               num_parts: int, device, backend: str, precision: str,
               first: int = 0, comm=None,
               allgather=None) -> ShardedGraphData:
    """Place the edge-mode graph data of the blocks held here: the forward
    blocks (``f_gat``/``f_sct`` [L, Eb], padded-global src and dst) and the
    transposed cut's (``b_gat`` dst, ``b_sct`` src), each block's CSR over
    its window."""
    S, P = int(shard_nodes), int(num_parts)
    NS = P * S
    L = int(np.asarray(f_sct).shape[0])
    fb, span_f = block_window(f_sct, NS, allgather)
    bb, span_b = block_window(b_sct, NS, allgather)
    blocks = EdgeBlocks(
        fwd=[_window_csr(f_gat[i], f_sct[i], int(fb[i]), span_f, NS, device)
             for i in range(L)],
        bwd=[_window_csr(b_gat[i], b_sct[i], int(bb[i]), span_b, NS, device)
             for i in range(L)],
        fwd_base=fb, bwd_base=bb, span_fwd=span_f, span_bwd=span_b,
        block_edges=int(np.asarray(f_sct).shape[1]))
    return ShardedGraphData(
        parts=[], in_degree=torch.as_tensor(
            np.asarray(in_degree, np.float32).reshape(-1), device=device),
        num_parts=P, shard_nodes=S, k=1, exchange="edge", backend=backend,
        precision=precision, xch=wire.FP32_WIRE, num_local=L,
        first=int(first), comm=comm, edge=blocks)


# -- the vertex exchange -------------------------------------------------------

def _positions(gd: ShardedGraphData, x: torch.Tensor):
    """x's mesh-position blocks of k*S rows."""
    return x.split(gd.k * gd.shard_nodes)


def _cat(ts):
    """Blocks back into one tensor (no copy for one block: k = P)."""
    return ts[0] if len(ts) == 1 else torch.cat(ts)


def _halo_recv(gd: ShardedGraphData, x: torch.Tensor) -> torch.Tensor:
    """The decoded halo receive buffer: each sender position's block
    encoded by the wire (its own stochastic bits); across processes one
    all-to-all moves the encoded blocks."""
    send = x.index_select(0, gd.send_gidx)
    blocks = send.split(send.shape[0] // gd.positions)
    enc = _cat([wire.wire_down(b, gd.xch, gd.first + d)
                for d, b in enumerate(blocks)])
    if gd.comm is not None:
        L, W = gd.num_local, gd.comm.world
        tail = enc.shape[1:]
        enc = collectives.all_to_all(
            enc.reshape(L, W, L * gd.K, *tail).transpose(0, 1)
            .reshape(-1, *tail))
    return wire.wire_up(enc, gd.xch, x.dtype, x.shape[-1])


def exchange_tables(gd: ShardedGraphData, x: torch.Tensor):
    """Each held part's source table in turn (a generator, so a table can
    go once its part has aggregated): own rows ++ halo rows, or the shared
    allgather table."""
    S, L = gd.shard_nodes, gd.num_local
    identity = wire.is_identity(gd.xch, x.dtype)
    if gd.exchange == "allgather":
        if identity:
            table = x if gd.comm is None else collectives.all_gather(x)
            for _ in range(L):
                yield table
            return
        enc = _cat([wire.wire_down(b, gd.xch, gd.first + d)
                    for d, b in enumerate(_positions(gd, x))])
        if gd.comm is not None:
            enc = collectives.all_gather(enc)
        # each receiving position decodes its own copy, so its cotangent
        # crosses the wire back in bf16 on its own, as the transpose of
        # roc_tpu's all_gather (a bf16 reduce-scatter) sends it
        for _ in range(gd.positions):
            table = wire.wire_up(enc, gd.xch, x.dtype, x.shape[-1])
            for _ in range(gd.k):
                yield table
        return
    if identity and gd.comm is None:
        for p in range(L):
            yield x.index_select(0, gd.tbl_idx[p])
        return
    recv = _halo_recv(gd, x)
    for p in range(L):
        yield torch.cat([x[p * S:(p + 1) * S],
                         recv.index_select(0, gd.recv_idx[p])])


def halo_pairs(gd: ShardedGraphData, x: torch.Tensor):
    """Each held part's (own rows, P*K halo rows) in turn, for the overlap
    split."""
    S = gd.shard_nodes
    if wire.is_identity(gd.xch, x.dtype) and gd.comm is None:
        halo_idx = gd.tbl_idx[:, S:]
        for p in range(gd.num_local):
            yield x[p * S:(p + 1) * S], x.index_select(0, halo_idx[p])
        return
    recv = _halo_recv(gd, x)
    for p in range(gd.num_local):
        yield x[p * S:(p + 1) * S], recv.index_select(0, gd.recv_idx[p])


# -- ring mode -----------------------------------------------------------------

def _ring_rotation(gd: ShardedGraphData, bufs: list):
    """Yield (step, the buffers the held positions hold at that step),
    rotating between steps: each position takes the block of the position
    before it (across processes, one ring hop of the last held block)."""
    P = gd.num_parts
    cur = list(bufs)
    for k in range(P):
        yield k, cur
        if k + 1 < P:
            head = (cur[-1] if gd.comm is None
                    else collectives.ring_hop(cur[-1]))
            cur = [head] + cur[:-1]


def _ring_aggregate(gd: ShardedGraphData, x: torch.Tensor, aggr: str,
                    agg) -> torch.Tensor:
    """Sum, avg, max or min over the rotating owner blocks (spmd.py:
    795-869): acc = acc + part (or the extreme) in step order."""
    if aggr not in ("sum", "avg", "max", "min"):
        raise ValueError(f"unknown aggr {aggr!r}")
    S, L, P = gd.shard_nodes, gd.num_local, gd.num_parts
    H = x.shape[-1]
    base = "sum" if aggr in ("sum", "avg") else aggr
    fill = {"sum": 0.0, "max": float("-inf"), "min": float("inf")}[base]
    accs = [torch.full((S, H), fill, dtype=x.dtype, device=x.device)
            for _ in range(L)]
    bufs = [wire.wire_down(b, gd.xch, gd.first + i)
            for i, b in enumerate(x.split(S))]
    for k, cur in _ring_rotation(gd, bufs):
        for i in range(L):
            csr = gd.ring[i][(gd.first + i - k) % P]
            if csr is None:
                continue
            xb = wire.wire_up(cur[i], gd.xch, x.dtype, H)
            if base == "sum":
                accs[i] = accs[i] + agg(xb, csr, "sum")
            else:
                part = _segment_extreme(xb, csr, base, zero_empty=False)
                accs[i] = (torch.maximum if base == "max"
                           else torch.minimum)(accs[i], part)
    out = torch.cat(accs)
    if aggr == "avg":
        out = ops.divide_by_degree(out, gd.in_degree)
    if base != "sum":
        # rows with no in-edge anywhere kept the identity: zero exactly
        # those (a genuine NaN still propagates)
        empty = torch.isneginf(out) if base == "max" else torch.isposinf(out)
        out = torch.where(empty, torch.zeros_like(out), out)
    return out


def _csr_dst(csr: ops.DeviceCsr) -> torch.Tensor:
    """Each edge's destination row of a CSR."""
    n = csr.row_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n, device=csr.row_ptr.device), torch.diff(csr.row_ptr))


def _ring_attend_step(hb, ad_l, m, z, u, a_src, src, dst, slope):
    """Fold one visiting owner's group into the online softmax."""
    as_t = torch.einsum("nkf,kf->nk", hb, a_src)
    s = _lrelu(ad_l[dst] + as_t[src], slope)                   # [e, K]
    m_step = torch.full_like(m, NEG).scatter_reduce(
        0, dst[:, None].expand_as(s), s.detach(), "amax")
    m_new = torch.maximum(m, m_step).detach()   # shift invariance
    e = torch.exp(s - m_new[dst])
    z_step = torch.zeros_like(z).index_add(0, dst, e)
    u_step = torch.zeros_like(u).index_add(0, dst, hb[src] * e[:, :, None])
    scale = torch.exp(m - m_new)
    return m_new, z * scale + z_step, u * scale[:, :, None] + u_step


def _ring_attend(gd: ShardedGraphData, h, a_src, a_dst, slope: float):
    """GAT attention in ring mode (spmd.py:932-1012): no table, each step
    folds the visiting owner's group into a running max, normalizer and
    output, rescaled as the max tightens; each step recomputed in the
    backward (``checkpoint``), the buffer rotating outside it."""
    S, L, P = gd.shard_nodes, gd.num_local, gd.num_parts
    _, K, F = h.shape
    state = []
    for i in range(L):
        hi = h[i * S:(i + 1) * S]
        state.append([torch.einsum("nkf,kf->nk", hi, a_dst),
                      h.new_full((S, K), NEG), h.new_zeros((S, K)),
                      h.new_zeros((S, K, F))])
    bufs = [wire.wire_down(h[i * S:(i + 1) * S], gd.xch, gd.first + i)
            for i in range(L)]
    for k, cur in _ring_rotation(gd, bufs):
        for i in range(L):
            csr = gd.ring[i][(gd.first + i - k) % P]
            if csr is None:
                continue
            hb = wire.wire_up(cur[i], gd.xch, h.dtype, F)
            ad_l, m, z, u = state[i]
            # roclint: allow(remat) ring-step recomputation keeps the rotating buffer out of the saved activations, as roc_tpu's scan-body remat does; no activation plan covers a ring step
            m, z, u = checkpoint(
                _ring_attend_step, hb, ad_l, m, z, u, a_src,
                csr.col_idx.long(), _csr_dst(csr), float(slope),
                use_reentrant=False)
            state[i][1:] = [m, z, u]
    return torch.cat([u / torch.clamp_min(z, Z_GUARD)[:, :, None]
                      for _, _, z, u in state])


# -- edge mode -----------------------------------------------------------------

def _to_owners(gd: ShardedGraphData, acc: torch.Tensor) -> torch.Tensor:
    """The [NS, ...] accumulator's rows of the parts held here: itself on
    one process, the reduce-scatter's sum across processes."""
    return acc if gd.comm is None else collectives.scatter_sum_raw(acc)


def _gather_all(gd: ShardedGraphData, t: torch.Tensor) -> torch.Tensor:
    """The [NS, ...] table of every part's rows."""
    return t if gd.comm is None else collectives.gather_raw(t.contiguous())


def _edge_half(gd, x, csrs, bases, span: int, sum_fn, precision):
    """One direction of the edge sum: the [NS, H] table, each block's
    window sum placed at its base and added in block order, the owners'
    rows of the sum (spmd.py:_eb_half)."""
    table = _gather_all(gd, x)
    acc = None
    for csr, base in zip(csrs, bases):
        if csr is None:
            continue
        part = sum_fn(table, csr.row_ptr, csr.col_idx, precision)
        if acc is None:
            acc = torch.zeros((table.shape[0], x.shape[1]), dtype=part.dtype,
                              device=x.device)
        acc[int(base):int(base) + span] += part
    if acc is None:
        acc = torch.zeros_like(table)
    return _to_owners(gd, acc)


class _EdgeSum(torch.autograd.Function):
    """Edge-mode sum: the forward over the forward blocks, the backward the
    same computation over the transposed cut's blocks (spmd.py:_eb_bwd)."""

    @staticmethod
    def forward(ctx, x, gd, sum_fn, precision):
        ctx.gd, ctx.sum_fn, ctx.precision = gd, sum_fn, precision
        eb = gd.edge
        return _edge_half(gd, x, eb.fwd, eb.fwd_base, eb.span_fwd, sum_fn,
                          precision)

    @staticmethod
    def backward(ctx, g):
        eb = ctx.gd.edge
        dx = _edge_half(ctx.gd, g.contiguous(), eb.bwd, eb.bwd_base,
                        eb.span_bwd, ctx.sum_fn, ctx.precision)
        return dx, None, None, None


def edge_sum(gd: ShardedGraphData, x: torch.Tensor) -> torch.Tensor:
    """The in-edge sum of the held parts' rows under edge sharding,
    through the ``aggregate_sum`` kernel (its plain version on the xla
    backend)."""
    if gd.backend == "xla":
        return _EdgeSum.apply(x, gd, agg_ops.aggregate_sum_plain, "exact")
    return _EdgeSum.apply(x, gd, agg_ops.aggregate_sum, gd.precision)


def _block_edges(gd: ShardedGraphData):
    """Each held block's live (src, dst) padded-global ids."""
    eb = gd.edge
    for csr, base in zip(eb.fwd, eb.fwd_base):
        if csr is None:
            continue
        yield csr.col_idx.long(), _csr_dst(csr) + int(base)


def _chunks(n: int, width: int):
    step = max(_ATTEND_CHUNK_ELEMS // max(width, 1), 1024)
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


class _EdgeAttend(torch.autograd.Function):
    """GAT attention under edge sharding (spmd.py:445-547,
    ``edge_gat_attend``) in plain PyTorch: each block scores its edges
    against the gathered table, the block-local maxima combine into one
    global max (no gradient), the exp sums and weighted sums add onto the
    owners, and the backward is the hand-derived ``_egat_bwd``."""

    @staticmethod
    def forward(ctx, h, a_src, a_dst, gd, slope):
        n, K, F = h.shape
        NS = gd.num_parts * gd.shard_nodes
        table = _gather_all(gd, h.reshape(n, K * F)).view(NS, K, F)
        as_t = _gather_all(gd, torch.einsum("nkf,kf->nk", h, a_src))
        ad_t = _gather_all(gd, torch.einsum("nkf,kf->nk", h, a_dst))
        edges = list(_block_edges(gd))
        m = torch.full((NS, K), NEG, dtype=h.dtype, device=h.device)
        for es, ed in edges:
            s = _lrelu(ad_t[ed] + as_t[es], slope)
            m.scatter_reduce_(0, ed[:, None].expand_as(s), s, "amax")
        if gd.comm is not None:
            m = collectives.all_reduce_max(m)
        z = torch.zeros((NS, K), dtype=h.dtype, device=h.device)
        u = torch.zeros((NS, K, F), dtype=h.dtype, device=h.device)
        for es, ed in edges:
            for lo, hi in _chunks(es.numel(), K * F):
                s_, d_ = es[lo:hi], ed[lo:hi]
                e = torch.exp(_lrelu(ad_t[d_] + as_t[s_], slope) - m[d_])
                z.index_add_(0, d_, e)
                u.index_add_(0, d_, table[s_] * e[:, :, None])
        zc = torch.clamp_min(_to_owners(gd, z), Z_GUARD)
        out = _to_owners(gd, u.view(NS, K * F)).view(n, K, F) / \
            zc[:, :, None]
        ctx.save_for_backward(h, a_src, a_dst, table, as_t, ad_t, m, zc,
                              out)
        ctx.gd, ctx.slope, ctx.edges = gd, slope, edges
        return out

    @staticmethod
    def backward(ctx, gout):
        h, a_src, a_dst, table, as_t, ad_t, m, zc, out = ctx.saved_tensors
        gd, slope = ctx.gd, ctx.slope
        n, K, F = h.shape
        NS = table.shape[0]
        du = gout / zc[:, :, None]
        dz = -(gout * out).sum(-1) / zc
        du_t = _gather_all(gd, du.reshape(n, K * F)).view(NS, K, F)
        dz_t = _gather_all(gd, dz)
        dadl = torch.zeros((NS, K), dtype=h.dtype, device=h.device)
        dast = torch.zeros_like(dadl)
        dtab = torch.zeros((NS, K, F), dtype=h.dtype, device=h.device)
        for es, ed in ctx.edges:
            for lo, hi in _chunks(es.numel(), K * F):
                s_, d_ = es[lo:hi], ed[lo:hi]
                q = ad_t[d_] + as_t[s_]
                e = torch.exp(_lrelu(q, slope) - m[d_])
                dut = du_t[d_]
                de = (dut * table[s_]).sum(-1) + dz_t[d_]
                dq = e * de * torch.where(q >= 0, 1.0, slope)
                dadl.index_add_(0, d_, dq)
                dast.index_add_(0, s_, dq)
                dtab.index_add_(0, s_, dut * e[:, :, None])
        dadl = _to_owners(gd, dadl)
        dast = _to_owners(gd, dast)
        dtab = _to_owners(gd, dtab.view(NS, K * F)).view(n, K, F)
        dh = dtab + dast[:, :, None] * a_src + dadl[:, :, None] * a_dst
        da_src = torch.einsum("sk,skf->kf", dast, h)
        da_dst = torch.einsum("sk,skf->kf", dadl, h)
        return dh, da_src, da_dst, None, None


# -- the graph context -----------------------------------------------------------

def make_sharded_gctx(gd: ShardedGraphData) -> GraphCtx:
    """The op graph's view of the held parts: every aggregation and
    attention layer exchanges and runs part by part (vertex), rotates
    (ring) or sums the blocks (edge); dropout draws per mesh position."""
    S, kS = gd.shard_nodes, gd.k * gd.shard_nodes

    def agg(x, csr, aggr):
        if gd.backend == "xla":
            return ops.scatter_gather_plain(x, csr, aggr, "exact")
        return ops.scatter_gather(x, csr, aggr, gd.precision)

    def aggregate(x, aggr):
        if gd.mode == "ring":
            return _ring_aggregate(gd, x, aggr, agg)
        if gd.mode == "edge":
            if aggr not in ("sum", "avg"):
                raise ValueError(
                    f"edge-sharded aggregation supports sum/avg, not {aggr}"
                    " (use vertex sharding for max/min models)")
            out = edge_sum(gd, x)
            if aggr == "avg":   # every in-edge of a vertex: count = degree
                out = ops.divide_by_degree(out, gd.in_degree)
            return out
        outs = []
        if gd.overlap and aggr in ("sum", "avg"):
            for pg, (own, halo) in zip(gd.parts, halo_pairs(gd, x)):
                out = agg(own, pg.csr_local, "sum") + \
                    agg(halo, pg.csr_remote, "sum")
                if aggr == "avg":
                    out = ops.divide_by_degree(out, pg.in_degree)
                outs.append(out)
        else:
            for pg, table in zip(gd.parts, exchange_tables(gd, x)):
                outs.append(agg(table, pg.csr, aggr))
                del table   # gone before the next part's is gathered
        return torch.cat(outs)

    def attend(h, a_src, a_dst, slope):
        # fp32 h, as the single-device context upcasts it
        h = h.to(torch.float32)
        if gd.mode == "ring":
            return _ring_attend(gd, h, a_src, a_dst, slope)
        if gd.mode == "edge":
            return _EdgeAttend.apply(h, a_src, a_dst, gd, float(slope))
        n, kk, f = h.shape
        outs = []
        for p, (pg, table) in enumerate(zip(
                gd.parts, exchange_tables(gd, h.reshape(n, kk * f)))):
            hp = h[p * S:(p + 1) * S]
            tab = table.view(-1, kk, f)
            if gd.backend == "xla":
                dst = torch.repeat_interleave(
                    torch.arange(S, device=h.device),
                    torch.diff(pg.csr.row_ptr))
                outs.append(ops.gat_attend(hp, tab, pg.csr.col_idx, dst, S,
                                           a_src, a_dst, slope))
            else:
                outs.append(ops.gat_attend_kernel(hp, tab, a_src, a_dst,
                                                  pg.csr, slope,
                                                  gd.precision))
        return torch.cat(outs)

    def dropout(x, rate, key, slot):
        return _cat([ops.dropout(b, rate, True, prng.fold_in(
            prng.fold_in(key, gd.first + d), slot))
            for d, b in enumerate(x.split(kS))])

    return GraphCtx(aggregate=aggregate, in_degree=gd.in_degree,
                    attend=attend, dropout=dropout)


def padded_max_tax(meta) -> float:
    """E_padded/E_live - 1: what every part overpays when all run the
    padded-max edge count (roc_tpu's skew cost of vertex partitioning;
    ``-edge-shard auto`` reads it)."""
    live = np.asarray(meta.num_edges_valid, np.float64)
    return meta.shard_edges * meta.num_parts / max(live.sum(), 1.0) - 1.0


class SpmdTrainer(Trainer):
    """The parts of ``-parts N`` on the mesh's devices: the Trainer
    interface, the exchange underneath.  ``devices`` is the mesh of one
    process (the run's device by default: k = N); ``bounds`` overrides the
    greedy cut (inclusive (lo, hi) per part)."""

    # Auto edge-shard threshold (spmd.py:1572-1575): above this padded-max
    # tax roc_tpu switches to edge sharding.
    EDGE_SHARD_TAX = 0.30

    def __init__(self, config, dataset, model, devices=None, bounds=None):
        self._mesh_devices = devices
        self._init_bounds = bounds
        super().__init__(config, dataset, model)

    def _lead(self) -> bool:
        """Whether this process prints the run's banners (process 0)."""
        return self.comm is None or self.comm.rank == 0

    # -- setup -------------------------------------------------------------
    def _setup_mesh(self, P: int):
        """The mesh of this process, k and the parts held here."""
        if self.comm is not None:
            self.mesh = make_process_mesh(P, self.device, self.comm.world)
            self.k = 1
            L = len(self.mesh)
            self._local_ids = list(range(self.comm.rank * L,
                                         (self.comm.rank + 1) * L))
            return
        devices = list(self._mesh_devices or [self.device])
        if P > len(devices) and P % len(devices):
            raise SystemExit(
                f"error: -parts {P} must be a multiple of the mesh's "
                f"{len(devices)} position(s) for parts-per-device overcommit")
        self.mesh = make_mesh(P, devices)
        self.device = self.mesh[0]
        self.k = P // len(self.mesh)
        self._local_ids = list(range(P))

    def _setup(self):
        cfg, ds, model = self.config, self.dataset, self.model
        P = int(cfg.num_parts)
        self._setup_mesh(P)
        dev = self.device
        self._exchange_mode = cfg.exchange_mode()
        if self.k > 1:
            if cfg.perhost_load:
                raise SystemExit(
                    "error: -perhost builds one part per mesh position "
                    "(k = 1), and parts-per-device overcommit is "
                    "single-process only; drop -perhost, or give the mesh "
                    "-parts positions")
            if self._exchange_mode == "ring" or cfg.edge_shard in (True,
                                                                   "on"):
                raise SystemExit(
                    f"error: num_parts={P} > {len(self.mesh)} devices "
                    f"(overcommit) supports the halo/allgather vertex "
                    f"exchanges only; use -parts {len(self.mesh)} for "
                    f"ring/edge-shard")
            if cfg.verbose:
                print(f"# overcommit: {P} parts on {len(self.mesh)} mesh "
                      f"position(s) of {dev}, k={self.k} parts per "
                      f"position (gnn.cc:61-63 numParts>numGPUs)",
                      file=sys.stderr)
        self.backend = effective_backend(cfg, model, dev)
        self.build_s = {}
        self.part = None
        if cfg.perhost_load:
            # explicit only: auto wants the partition's tax before any
            # loading, and the transposed sidecar may not exist
            self._use_edge_shard = cfg.edge_shard in (True, "on")
            if self._use_edge_shard and model_has_gat(model) \
                    and self.backend != "kernel":
                raise SystemExit(
                    "error: -edge-shard -perhost with a GAT model needs the "
                    "plan attention backend (-aggr-backend matmul/binned); "
                    "the xla path's _edge_attend serializes on TPU")
        else:
            with obs.span("partition", parts=P) as sp:
                self.part = partition_graph(
                    ds.graph, P, bounds=None if self._init_bounds is None
                    else np.asarray(self._init_bounds, np.int64))
            self.build_s["partition"] = sp.dur_s
            self._use_edge_shard = self._resolve_edge_shard()
        if self._use_edge_shard and self._exchange_mode == "ring":
            if self._lead():
                print("# -edge-shard on overrides -exchange ring (edge "
                      "blocks have their own psum_scatter exchange)",
                      file=sys.stderr)
            self._exchange_mode = "halo"   # ignored by the edge path
        self._edge_map = (self.backend == "kernel" and model_has_gat(model)
                          and not self._use_edge_shard
                          and self._exchange_mode != "ring")
        if cfg.perhost_load:
            self._build_perhost()
        else:
            self._build_graph_full()
        if cfg.verbose and self._lead():
            self._log_shard_stats()
        self._place_data()
        self.params = model.init_params(self.key, device=dev)
        self.opt_state = self.optimizer.init(self.params)
        self._resolve_mem_plan()
        self._loss = self._loss_fn()
        self._obs_setup()

    def _xch_meta(self) -> tuple:
        """The wire of the feature exchanges (spmd.py:1283-1291); edge mode
        keeps fp32: its reductions add partial sums on the wire, where a
        bf16 wire would round sums rather than inputs."""
        cfg = self.config
        if not cfg.bf16_storage or self._use_edge_shard:
            return wire.FP32_WIRE
        return ("bf16", cfg.bf16_rounding, cfg.bf16_exchange)

    def _halo_overlap(self) -> bool:
        """The local/remote split: on by default for the kernel backend in
        halo mode at k = 1 (roc_tpu's plan backends)."""
        return (bool(self.config.halo_overlap) and self.k == 1
                and self._exchange_mode == "halo"
                and self.backend == "kernel")

    def _needs_table_csr(self) -> bool:
        """Whether some aggregation reads the combined table: always but
        under the overlap split, where only max/min and attention do."""
        if not self._halo_overlap():
            return True
        aggrs = {op.attrs["aggr"] for op in self.model.ops
                 if op.kind == "aggregate"}
        return bool(aggrs - {"sum", "avg"}) or model_has_gat(self.model)

    def _resolve_edge_shard(self) -> bool:
        """``-edge-shard`` as roc_tpu resolves it (spmd.py:1577-1614): on
        when asked; auto where a sum/avg (or attention on the kernel
        backend, roc_tpu's plan backend) model's partition pays more than
        the tax threshold at k = 1, never over an explicit ring."""
        es = self.config.edge_shard
        if es in (True, "on"):
            return True
        if es in (False, None, "off"):
            return False
        if self._exchange_mode == "ring" or self.k > 1:
            return False
        aggrs = {op.attrs["aggr"] for op in self.model.ops
                 if op.kind == "aggregate"}
        has_gat = model_has_gat(self.model)
        if has_gat and self.backend != "kernel":
            return False
        if aggrs - {"sum", "avg"}:
            return False
        if not aggrs and not has_gat:
            return False
        tax = padded_max_tax(self.part)
        if tax > self.EDGE_SHARD_TAX:
            if self._lead():
                print(f"# padded-max tax {tax * 100:.0f}% > "
                      f"{self.EDGE_SHARD_TAX:.0%}: auto-enabling edge-"
                      f"sharded aggregation (-edge-shard off to override)",
                      file=sys.stderr)
            return True
        return False

    def _graph_kw(self) -> dict:
        return dict(backend=self.backend,
                    precision=self.config.aggregate_precision,
                    first=self._local_ids[0], comm=self.comm)

    def _build_graph_full(self):
        """The whole graph in memory, every part partitioned, the held
        parts (or blocks) built."""
        part, cfg, ids = self.part, self.config, self._local_ids
        P, S = part.num_parts, part.shard_nodes
        self.halo = None
        self.ring_maps = None
        if self._use_edge_shard:
            with obs.span("edge_blocks", parts=P) as sp:
                f_gat, f_sct = edge_block_arrays(self.dataset.graph, part)
                b_gat, b_sct = edge_block_arrays_t(self.dataset.graph, part)
            self.build_s["edge_blocks"] = sp.dur_s
            with obs.span("plan_build", parts=P) as sp:
                self.gdata = edge_graph(
                    f_gat[ids], f_sct[ids], b_gat[ids], b_sct[ids],
                    part.in_degree[ids], S, P, self.device,
                    **self._graph_kw())
                device_sync(self.device)
            self.build_s["csrs"] = sp.dur_s
            return
        if self._exchange_mode == "ring":
            with obs.span("ring_groups", parts=P) as sp:
                rm = build_ring_groups(part)
                self.ring_maps = type(rm)(rm.ring_src[ids], rm.ring_dst[ids])
            self.build_s["ring_groups"] = sp.dur_s
            with obs.span("plan_build", parts=P) as sp:
                self.gdata = ring_graph(
                    self.ring_maps, part.num_valid, part.in_degree[ids], S,
                    self.device, xch=self._xch_meta(), num_parts=P,
                    **self._graph_kw())
                device_sync(self.device)
            self.build_s["csrs"] = sp.dur_s
            return
        if self._exchange_mode == "halo":
            with obs.span("halo_build", parts=P) as sp:
                self.halo = build_halo_maps(part)
            self.build_s["halo_maps"] = sp.dur_s
            src, send_idx = self.halo.edge_src_local, self.halo.send_idx
        else:
            src, send_idx = part.edge_src, None
        with obs.span("plan_build", parts=P) as sp:
            self.gdata = shard_graph(
                src[ids], part.edge_dst[ids], part.num_edges_valid[ids],
                part.in_degree[ids],
                None if send_idx is None else send_idx[ids], S, self.k,
                self.device, xch=self._xch_meta(),
                overlap=self._halo_overlap(),
                table_csr=self._needs_table_csr(), edge_map=self._edge_map,
                num_parts=P, **self._graph_kw())
            device_sync(self.device)
        self.build_s["csrs"] = sp.dur_s

    def _build_perhost(self):
        """``-perhost``: the held parts, or blocks, from the ``.lux`` byte
        ranges (spmd.py:1383-1529), k = 1; the shapes every process must
        agree on come through the allgather."""
        from roc_tpu_torch.graph import lux, shard_load
        cfg, ids = self.config, self._local_ids
        if not cfg.filename:
            raise SystemExit("error: -perhost needs -file (an on-disk .lux "
                             "dataset)")
        path = cfg.filename + lux.LUX_SUFFIX
        ag = (shard_load.torch_allgather() if self.comm is not None
              else shard_load.single_process_allgather)
        P = int(cfg.num_parts)
        rank = 0 if self.comm is None else self.comm.rank
        with obs.span("partition", parts=P) as sp:
            meta = shard_load.meta_from_lux(path, P, rank, ag)
        self.build_s["partition"] = sp.dur_s
        self.part = meta
        self.local = None
        self.halo = None
        self.ring_maps = None
        S = meta.shard_nodes
        if self._use_edge_shard:
            tpath = cfg.filename + lux.TLUX_SUFFIX
            if not os.path.exists(tpath):
                raise SystemExit(
                    f"error: -edge-shard -perhost needs the transposed "
                    f"sidecar {tpath}; write it once with python -m "
                    f"roc_tpu_torch.graph ... --with-transpose (or "
                    f"graph.lux.write_transpose(prefix, graph))")
            if os.path.getmtime(tpath) < os.path.getmtime(path):
                raise SystemExit(
                    f"error: {tpath} is older than {path}: regenerate the "
                    f"transposed sidecar (--with-transpose or "
                    f"lux.write_transpose)")
            with obs.span("edge_blocks", parts=P) as sp:
                f_gat, f_sct = shard_load.load_edge_blocks(path, meta, ids)
                b_gat, b_sct = shard_load.load_edge_blocks(tpath, meta, ids)
                indeg = shard_load.load_local_degrees(path, meta, ids)
            self.build_s["edge_blocks"] = sp.dur_s
            with obs.span("plan_build", parts=P) as sp:
                self.gdata = edge_graph(
                    f_gat, f_sct, b_gat, b_sct, indeg, S, P, self.device,
                    allgather=ag, **self._graph_kw())
                device_sync(self.device)
            self.build_s["csrs"] = sp.dur_s
            return
        with obs.span("partition", parts=P) as sp:
            self.local = local = shard_load.load_local_shards(path, meta,
                                                              ids)
        self.build_s["partition"] += sp.dur_s
        if self._exchange_mode == "ring":
            with obs.span("ring_groups", parts=P) as sp:
                self.ring_maps = build_ring_groups_arrays(
                    local.edge_src, local.edge_dst, P, S, allgather=ag)
            self.build_s["ring_groups"] = sp.dur_s
            with obs.span("plan_build", parts=P) as sp:
                self.gdata = ring_graph(
                    self.ring_maps, meta.num_valid, local.in_degree, S,
                    self.device, xch=self._xch_meta(), num_parts=P,
                    **self._graph_kw())
                device_sync(self.device)
            self.build_s["csrs"] = sp.dur_s
            return
        if self._exchange_mode == "halo":
            with obs.span("halo_build", parts=P) as sp:
                self.halo = shard_load.build_halo_local(meta, local, ag)
            self.build_s["halo_maps"] = sp.dur_s
            src, send_idx = self.halo.edge_src_local, self.halo.send_idx
        else:
            src, send_idx = local.edge_src, None
        with obs.span("plan_build", parts=P) as sp:
            self.gdata = shard_graph(
                src, local.edge_dst, meta.num_edges_valid[ids],
                local.in_degree, send_idx, S, self.k, self.device,
                xch=self._xch_meta(), overlap=self._halo_overlap(),
                table_csr=self._needs_table_csr(), edge_map=self._edge_map,
                num_parts=P, **self._graph_kw())
            device_sync(self.device)
        self.build_s["csrs"] = sp.dur_s

    def _place_data(self):
        """The node tensors of the held parts, [L*S, ...] in part order,
        each part's block copied to the device on its own (a lazy
        dataset's memmap is read one part at a time), and the graph
        context (called from _setup and on every reshard)."""
        ds, part, dev = self.dataset, self.part, self.device
        S = part.shard_nodes
        L = len(self._local_ids)
        with obs.span("place", parts=L) as sp:
            self.x = torch.empty((L * S, ds.features.shape[1]),
                                 dtype=self.dtype, device=dev)
            self.labels = torch.empty((L * S, ds.num_classes),
                                      dtype=torch.float32, device=dev)
            self.mask = torch.empty(L * S, dtype=torch.int32, device=dev)
            for i, p in enumerate(self._local_ids):
                rows = slice(i * S, (i + 1) * S)
                self.x[rows] = torch.from_numpy(part.pad_part(
                    ds.features, p, dtype=np.float32))
                # pad rows carry label 0 and mask NONE: never in the loss
                self.labels[rows] = torch.from_numpy(one_hot(
                    part.pad_part(ds.label_ids, p, fill=0), ds.num_classes))
                self.mask[rows] = torch.from_numpy(part.pad_part(
                    ds.mask, p, fill=MASK_NONE, dtype=np.int32))
            device_sync(dev)
        self.build_s["place"] = sp.dur_s
        self.gctx = make_sharded_gctx(self.gdata)

    def _log_shard_stats(self):
        """The skew report (spmd.py:1556-1570) and the exchange's shape."""
        m, gd = self.part, self.gdata
        live = np.asarray(m.num_edges_valid, np.float64)
        print(f"# shards: P={m.num_parts} S={m.shard_nodes} "
              f"E={m.shard_edges} edges/shard min={int(live.min())} "
              f"mean={int(live.mean())} max={int(live.max())} "
              f"padded-max tax={padded_max_tax(m) * 100:.1f}%",
              file=sys.stderr)
        if self.halo is not None:
            print(f"# halo: K={self.halo.K} table rows="
                  f"{gd.table_rows()} halo rows="
                  f"{self.halo.halo_rows_total}", file=sys.stderr)
        if gd.mode == "ring":
            sizes = [int(c.col_idx.numel()) if c is not None else 0
                     for row in gd.ring for c in row]
            print(f"# ring: {m.num_parts} owner groups per part, "
                  f"Eo={self.ring_maps.ring_src.shape[-1]}, live group "
                  f"edges min={min(sizes)} mean={int(np.mean(sizes))} "
                  f"max={max(sizes)}", file=sys.stderr)
        if gd.mode == "edge":
            eb = gd.edge
            print(f"# edge blocks: P={m.num_parts} Eb={eb.block_edges} "
                  f"span fwd={eb.span_fwd} bwd={eb.span_bwd} edge tax="
                  f"{self.edge_tax() * 100:.1f}%", file=sys.stderr)

    def edge_tax(self) -> float:
        """P*Eb/E - 1: the pad edges of the edge cut (its skew cost)."""
        m = self.part
        return (m.num_parts * self.gdata.edge.block_edges
                / max(m.num_edges, 1) - 1.0)

    def _aggregate_widths(self) -> list:
        """Feature width at each aggregate/gat op, in op order: the widths
        a forward exchanges at (spmd.py:816-828)."""
        widths, width = [], self.dataset.in_dim
        for op in self.model.ops:
            if op.kind == "linear":
                width = op.attrs["out_dim"]
            elif op.kind in ("aggregate", "gat"):
                widths.append(width)
        return widths

    def _wire_mode(self) -> str:
        """The exchange the wire counts: edge mode moves the allgather's
        rows (spmd.py:1796)."""
        return "allgather" if self.gdata.mode == "edge" \
            else self._exchange_mode

    def wire_bytes(self) -> int:
        """Per-position wire bytes of one step's forward exchanges
        (roc_tpu's in-graph ``wire_bytes`` metric)."""
        xd, _, xc = self._xch_meta()
        return channel.wire_bytes_per_step(
            self._wire_mode(), self.part.num_parts, self.part.shard_nodes,
            self._aggregate_widths(), send_cols=self.gdata.K,
            xch_dtype=xd, xch_comp=xc)

    def _obs_setup(self):
        """The epoch record's ``wire_bytes`` and ``edges`` (one count per
        held mesh position: the sum of its block's in-degrees, pad rows'
        1.0 included, as roc_tpu's ``jnp.sum(gd.in_degree)``), and the
        ledger's wire prediction (spmd.py:1796-1817)."""
        if self._metrics is None:
            return
        self._obs_wire = self.wire_bytes()
        kS = self.k * self.part.shard_nodes
        deg = self.gdata.in_degree
        self._obs_edges = [int(b.sum()) for b in deg.split(kS)]
        led = get_ledger()
        if led.attached:
            self._wire_key = content_key(mode=self._wire_mode(),
                                         parts=self.part.num_parts,
                                         shard_nodes=self.part.shard_nodes)
            led.predict("wire_bytes", self._wire_key, self._obs_wire,
                        "bytes")

    def _obs_epoch_extra(self, epoch):
        del epoch
        return {"wire_bytes": self._obs_wire}

    # -- one step -----------------------------------------------------------
    def _train_step(self, key, alpha: float, scale: float):
        params = {k: p.detach().requires_grad_(True)
                  for k, p in self.params.items()}
        loss = self._loss(params, self.x, self.labels, self.mask,
                          self.gctx, key=key, train=True)
        keys = sorted(params)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [params[k] for k in keys])))
        loss = loss.detach()
        if self.comm is not None:
            loss, grads = self._sum_over_processes(loss, keys, grads)
        # applied after the sum over parts (spmd.py:1840-1846): 1.0 on a
        # healthy step (no multiply), NaN when step.nan fires
        if scale != 1.0:
            loss = loss * scale
            grads = {k: g * scale for k, g in grads.items()}
        (self.params, self.opt_state, self._last_nonfinite,
         self._last_gnorm) = guarded_update(
            self.optimizer, self.params, grads, self.opt_state, alpha,
            loss=loss)
        return loss

    @staticmethod
    def _sum_over_processes(loss, keys, grads):
        """``psum(loss_l)`` and ``psum(grads_l)``: one all-reduce of the
        loss and every gradient, in fp32."""
        flat = torch.cat([loss.reshape(1).to(torch.float32)]
                         + [grads[k].reshape(-1).to(torch.float32)
                            for k in keys])
        collectives.all_reduce_sum_(flat)
        out, lo = {}, 1
        for k in keys:
            g = grads[k]
            out[k] = flat[lo:lo + g.numel()].view(g.shape).to(g.dtype)
            lo += g.numel()
        return flat[0].to(loss.dtype), out

    def evaluate(self) -> PerfMetrics:
        """The metrics of the held parts, summed across processes."""
        m = super().evaluate()
        if self.comm is None:
            return m
        flat = torch.stack([v.to(torch.float64) for v in m])
        collectives.all_reduce_sum_(flat)
        return PerfMetrics(*(flat[i].to(v.dtype) for i, v in enumerate(m)))

    # -- checkpoints ----------------------------------------------------------
    def _resume_extra(self) -> dict:
        extra = super()._resume_extra()
        extra["balance_bounds"] = [int(b) for b in
                                   np.asarray(self.part.bounds).ravel()]
        return extra

    def _restore_extra(self, extra: dict) -> None:
        """The balancer's last committed cut, where the checkpoint carries
        one that differs from the current cut (driver.py:1086-1094)."""
        bounds = extra.get("balance_bounds")
        if bounds is None or not self._balance_supported():
            return
        bounds = np.asarray(bounds, np.int64).reshape(-1, 2)
        if not np.array_equal(bounds, np.asarray(self.part.bounds)):
            self.reshard(bounds)

    # -- online load balancing (balance/) -------------------------------------
    def _balance_supported(self) -> bool:
        """reshard() handles the single-process vertex modes at k = 1
        (spmd.py:1887-1897); edge blocks are balanced already, ring keeps
        its groups."""
        return (isinstance(self.part, Partition)
                and not self.config.perhost_load
                and self.gdata.mode == "vertex"
                and self._exchange_mode in ("halo", "allgather")
                and self.k == 1
                and (self.comm is None or self.comm.world == 1))

    def reshard(self, new_bounds: np.ndarray) -> float:
        """Apply a repartition at an epoch boundary under the old padded
        shard shape (S and E frozen); rebuilds the parts' CSRs, the halo
        maps and the node tensors, keeps params and Adam state (they are
        node-independent).  Returns the wall seconds."""
        assert self._balance_supported(), \
            "reshard: unsupported trainer mode (see _balance_supported)"
        with obs.span("reshard", parts=self.part.num_parts) as sp:
            old = self.part
            self.part = partition_graph(
                self.dataset.graph, old.num_parts,
                bounds=np.asarray(new_bounds, np.int64),
                shard_nodes=old.shard_nodes, shard_edges=old.shard_edges)
            self._build_graph_full()
            self._place_data()
            self._obs_setup()
        if self.config.verbose:
            self._log_shard_stats()
        return sp.dur_s
