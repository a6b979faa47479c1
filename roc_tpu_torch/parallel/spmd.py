"""The vertex-sharded SPMD trainer (roc_tpu/parallel/spmd.py, its vertex
half): ``-parts N`` without ``-stream``.

Each part owns a contiguous vertex range padded to S rows
(graph/partition.py).  Node tensors (features, activations, labels, mask)
hold every part's S rows stacked in part order, [P*S, ...]; the parts of
one mesh position (parallel/mesh.py) are consecutive, so a position's
block is its k parts' rows, as roc_tpu stacks them inside its shard_map
body.  Each aggregation builds every part's source table by one exchange
and aggregates each part over its own CSR:

  halo       (the default) table = the part's own S rows ++ P*K halo rows,
             the rows of the other parts that its in-edges read
             (parallel/halo.py): roc_tpu's one all_to_all, the send
             buffer laid out as ``_overcommit_tables`` lays it (sender
             position, receiver position, sender part, receiver part, K)
  allgather  (``-no-halo``, ``-exchange allgather``) table = all P*S rows

On one device the exchange is a gather: the send buffer is
``x.index_select`` of the send map, and the receiver's halo rows a gather
of that buffer (an all_to_all moves no bytes between parts that share a
device).  With an fp32 wire both collapse into one gather per part.
Autograd transposes the exchange, as AD transposes roc_tpu's
``all_to_all``: the halo rows' cotangents index-add back into their
owners' rows.  Under ``-bf16-storage`` each sender position's block of
the send buffer (or of the allgather table) goes through the wire codec
(parallel/wire.py).

Aggregation runs ``ops.scatter_gather`` over each part's CSR: S rows over
its table's T rows (S + P*K for halo, P*S for allgather), live edges only
(roc_tpu pads every part to a common edge count for its static TPU
shapes; a CSR needs no padding).  Under halo overlap (k = 1, halo, kernel
backend, sum/avg; roc_tpu's plan backends, spmd.py:1275-1281) the part's
edges split into a local CSR over its own S rows and a remote one over
the P*K halo rows, and the two sums add.  Attention runs
``ops.gat_attend_kernel`` with the part's own rows and its table; max and
min the extreme path.  The whole-layer megakernel and the region kernels
stay off this path, as in roc_tpu ("sharded steps currently never run the
fused kernel", spmd.py:92-124).

One step runs the model once over all parts: the loss is the sum of the
parts' masked sums (roc_tpu's ``psum(loss_l)``), its gradients what
``psum(grads_l)`` gives, the ``step.nan`` scale applied after the sum, and
the update goes through ``fault.guarded_update``.  Dropout draws one mask
per mesh position over the position's [k*S, d] block from
``fold_in(fold_in(step_key, position), slot)`` (spmd.py:1833): roc_tpu's
masks, bit for bit.  Eval metrics are sums over the parts.

``-perhost`` builds the parts from the ``.lux`` byte ranges
(graph/shard_load.py) at k = 1.  ``-exchange ring``, ``-edge-shard`` and
``-multihost`` wait for the multi-process slice and exit with a message.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

import numpy as np
import torch

from roc_tpu_torch import obs, ops
from roc_tpu_torch.fault.guard import guarded_update
from roc_tpu_torch.graph.lux import MASK_NONE, one_hot
from roc_tpu_torch.graph.partition import Partition, partition_graph
from roc_tpu_torch.models.model import GraphCtx
from roc_tpu_torch.obs import channel
from roc_tpu_torch.obs.ledger import content_key, get_ledger
from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.aggregate import note_csr_build
from roc_tpu_torch.parallel import wire
from roc_tpu_torch.parallel.halo import build_halo_maps, part_csr
from roc_tpu_torch.parallel.mesh import make_mesh
from roc_tpu_torch.train.driver import Trainer, device_sync
from roc_tpu_torch.train.graph_data import effective_backend, model_has_gat

_NEXT = "the multi-process slice of the port (ROADMAP queue A item 7)"


@dataclasses.dataclass
class PartGraph:
    """One part's graph data on the device."""
    csr: Optional[ops.DeviceCsr]        # S rows over the part's table
    in_degree: torch.Tensor             # [S] float32, 1.0 on pad rows
    edges: int                          # live in-edges
    csr_local: Optional[ops.DeviceCsr] = None   # halo overlap: own rows
    csr_remote: Optional[ops.DeviceCsr] = None  # halo overlap: P*K rows


@dataclasses.dataclass
class ShardedGraphData:
    """Every part's graph data and the exchange's index maps."""
    parts: List[PartGraph]
    in_degree: torch.Tensor             # [P*S]
    num_parts: int
    shard_nodes: int
    k: int                              # parts per mesh position
    exchange: str                       # halo | allgather
    backend: str                        # kernel | xla
    precision: str
    xch: tuple                          # the wire (parallel/wire.py)
    K: int = 0
    send_gidx: Optional[torch.Tensor] = None   # [P*P*K] rows of x
    recv_idx: Optional[torch.Tensor] = None    # [P, P*K] send-buffer rows
    tbl_idx: Optional[torch.Tensor] = None     # [P, S+P*K] rows of x
    overlap: bool = False

    @property
    def positions(self) -> int:
        return self.num_parts // self.k

    def table_rows(self) -> int:
        P, S = self.num_parts, self.shard_nodes
        return S + P * self.K if self.exchange == "halo" else P * S

    def nbytes(self) -> int:
        ts = [self.in_degree, self.send_gidx, self.recv_idx, self.tbl_idx]
        for pg in self.parts:
            ts.append(pg.in_degree)
            for c in (pg.csr, pg.csr_local, pg.csr_remote):
                ts += list(c) if c is not None else []
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


def _device_csr(esrc, edst, S: int, T: int, edge_map: bool,
                device) -> ops.DeviceCsr:
    note_csr_build()
    return ops.DeviceCsr(*part_csr(esrc, edst, S, T, edge_map, device))


def shard_graph(edge_src, edge_dst, num_edges, in_degree, send_idx,
                shard_nodes: int, k: int, device, backend: str,
                precision: str, xch: tuple = wire.FP32_WIRE,
                overlap: bool = False, table_csr: bool = True,
                edge_map: bool = False) -> ShardedGraphData:
    """Place every part's graph data: ``edge_src`` [P, E] (table-local
    under halo, padded-global under allgather), ``edge_dst`` [P, E] local
    rows, ``num_edges`` [P] live edges (the rest are pad edges, dropped),
    ``in_degree`` [P, S], ``send_idx`` [P, P, K] or None for allgather.
    ``table_csr`` False skips the combined-table CSR where the overlap
    split serves every aggregation of the model."""
    P = int(np.asarray(edge_src).shape[0])
    S = int(shard_nodes)
    halo = send_idx is not None
    K = int(send_idx.shape[-1]) if halo else 0
    T = S + P * K if halo else P * S
    parts = []
    for p in range(P):
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
        precision=precision, xch=tuple(xch), K=K, overlap=bool(overlap))
    if halo:
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


# -- the exchange -------------------------------------------------------------

def _positions(gd: ShardedGraphData, x: torch.Tensor):
    """x's mesh-position blocks of k*S rows."""
    return x.split(gd.k * gd.shard_nodes)


def _cat(ts):
    """Blocks back into one tensor (no copy for one block: k = P)."""
    return ts[0] if len(ts) == 1 else torch.cat(ts)


def _halo_recv(gd: ShardedGraphData, x: torch.Tensor) -> torch.Tensor:
    """The decoded halo send buffer [P*P*K, H]: each sender position's
    block encoded by the wire (its own stochastic bits)."""
    send = x.index_select(0, gd.send_gidx)
    blocks = send.split(send.shape[0] // gd.positions)
    return wire.wire_up(_cat([wire.wire_down(b, gd.xch, d)
                              for d, b in enumerate(blocks)]),
                        gd.xch, x.dtype, x.shape[-1])


def exchange_tables(gd: ShardedGraphData, x: torch.Tensor):
    """Each part's source table in turn (a generator, so a table can go
    once its part has aggregated): own rows ++ halo rows, or the shared
    allgather table."""
    P, S = gd.num_parts, gd.shard_nodes
    identity = wire.is_identity(gd.xch, x.dtype)
    if gd.exchange == "allgather":
        if identity:
            for _ in range(P):
                yield x
            return
        enc = _cat([wire.wire_down(b, gd.xch, d)
                    for d, b in enumerate(_positions(gd, x))])
        # each receiving position decodes its own copy, so its cotangent
        # crosses the wire back in bf16 on its own, as the transpose of
        # roc_tpu's all_gather (a bf16 reduce-scatter) sends it
        for _ in range(gd.positions):
            table = wire.wire_up(enc, gd.xch, x.dtype, x.shape[-1])
            for _ in range(gd.k):
                yield table
        return
    if identity:
        for p in range(P):
            yield x.index_select(0, gd.tbl_idx[p])
        return
    recv = _halo_recv(gd, x)
    for p in range(P):
        yield torch.cat([x[p * S:(p + 1) * S],
                         recv.index_select(0, gd.recv_idx[p])])


def halo_pairs(gd: ShardedGraphData, x: torch.Tensor):
    """Each part's (own rows, P*K halo rows) in turn, for the overlap
    split."""
    P, S = gd.num_parts, gd.shard_nodes
    if wire.is_identity(gd.xch, x.dtype):
        halo_idx = gd.tbl_idx[:, S:]
        for p in range(P):
            yield x[p * S:(p + 1) * S], x.index_select(0, halo_idx[p])
        return
    recv = _halo_recv(gd, x)
    for p in range(P):
        yield x[p * S:(p + 1) * S], recv.index_select(0, gd.recv_idx[p])


def make_sharded_gctx(gd: ShardedGraphData) -> GraphCtx:
    """The op graph's view of the parts: every aggregation and attention
    layer exchanges, then runs part by part; dropout draws per mesh
    position."""
    S, kS = gd.shard_nodes, gd.k * gd.shard_nodes

    def agg(x, csr, aggr):
        if gd.backend == "xla":
            return ops.scatter_gather_plain(x, csr, aggr, "exact")
        return ops.scatter_gather(x, csr, aggr, gd.precision)

    def aggregate(x, aggr):
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
        return _cat([ops.dropout(b, rate, True,
                                 prng.fold_in(prng.fold_in(key, d), slot))
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
    """The parts of ``-parts N`` on the mesh's device: the Trainer
    interface, the exchange underneath.  ``devices`` is the mesh (the
    run's device by default: k = N); ``bounds`` overrides the greedy cut
    (inclusive (lo, hi) per part)."""

    # Auto edge-shard threshold (spmd.py:1572-1575): above this padded-max
    # tax roc_tpu switches to edge sharding.
    EDGE_SHARD_TAX = 0.30

    def __init__(self, config, dataset, model, devices=None, bounds=None):
        self._mesh_devices = devices
        self._init_bounds = bounds
        super().__init__(config, dataset, model)

    # -- setup -------------------------------------------------------------
    def _refuse(self):
        """The modes that wait for the multi-process slice exit, each
        saying what to run instead; none falls back to another mode."""
        cfg = self.config
        if cfg.multihost:
            raise SystemExit(
                f"error: -multihost (torch.distributed across processes) "
                f"belongs to {_NEXT}; drop it to run the parts on this "
                f"process's device")
        if cfg.exchange_mode() == "ring":
            raise SystemExit(
                f"error: -exchange ring is not in the SPMD trainer yet: it "
                f"belongs to {_NEXT}; use -exchange halo (the default) or "
                f"-exchange allgather")
        if cfg.edge_shard in (True, "on"):
            raise SystemExit(
                f"error: -edge-shard on is not in the SPMD trainer yet: it "
                f"belongs to {_NEXT}; -edge-shard off runs the vertex path")

    def _setup(self):
        cfg, ds, model = self.config, self.dataset, self.model
        self._refuse()
        P = int(cfg.num_parts)
        devices = list(self._mesh_devices or [self.device])
        if P > len(devices) and P % len(devices):
            raise SystemExit(
                f"error: -parts {P} must be a multiple of the mesh's "
                f"{len(devices)} position(s) for parts-per-device overcommit")
        self.mesh = make_mesh(P, devices)
        self.device = dev = self.mesh[0]
        self.k = P // len(self.mesh)
        self._exchange_mode = cfg.exchange_mode()
        if self.k > 1 and cfg.perhost_load:
            raise SystemExit(
                "error: -perhost builds one part per mesh position (k = 1), "
                "and parts-per-device overcommit is single-process only; "
                "drop -perhost, or give the mesh -parts positions")
        if self.k > 1 and cfg.verbose:
            print(f"# overcommit: {P} parts on {len(self.mesh)} mesh "
                  f"position(s) of {dev}, k={self.k} parts per position "
                  f"(gnn.cc:61-63 numParts>numGPUs)", file=sys.stderr)
        self.backend = effective_backend(cfg, model, dev)
        self._edge_map = self.backend == "kernel" and model_has_gat(model)
        self.build_s = {}
        if cfg.perhost_load:
            self._build_perhost()
        else:
            with obs.span("partition", parts=P) as sp:
                self.part = partition_graph(
                    ds.graph, P, bounds=None if self._init_bounds is None
                    else np.asarray(self._init_bounds, np.int64))
            self.build_s["partition"] = sp.dur_s
            if self._resolve_edge_shard():
                raise SystemExit(
                    f"error: the padded-max tax "
                    f"{padded_max_tax(self.part) * 100:.0f}% exceeds "
                    f"{self.EDGE_SHARD_TAX:.0%}, where roc_tpu switches to "
                    f"edge sharding, which belongs to {_NEXT}; -edge-shard "
                    f"off runs the vertex path")
            self._build_graph_full()
        if cfg.verbose:
            self._log_shard_stats()
        self._place_data()
        self.params = model.init_params(self.key, device=dev)
        self.opt_state = self.optimizer.init(self.params)
        self._resolve_mem_plan()
        self._loss = self._loss_fn()
        self._obs_setup()

    def _xch_meta(self) -> tuple:
        """The wire of the feature exchanges (spmd.py:1283-1291)."""
        cfg = self.config
        if not cfg.bf16_storage:
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
        """``-edge-shard auto`` as roc_tpu resolves it
        (spmd.py:1577-1614): on where a sum/avg (or attention on the
        kernel backend, roc_tpu's plan backend) model's partition pays
        more than the tax threshold, at k = 1."""
        es = self.config.edge_shard
        if es in (False, None, "off"):
            return False
        if self.k > 1:
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
        return padded_max_tax(self.part) > self.EDGE_SHARD_TAX

    def _build_graph_full(self):
        """The whole graph in memory, all P parts built."""
        part, cfg = self.part, self.config
        if self._exchange_mode == "halo":
            with obs.span("halo_build", parts=part.num_parts) as sp:
                self.halo = build_halo_maps(part)
            self.build_s["halo_maps"] = sp.dur_s
            src, send_idx = self.halo.edge_src_local, self.halo.send_idx
        else:
            self.halo = None
            src, send_idx = part.edge_src, None
        with obs.span("plan_build", parts=part.num_parts) as sp:
            self.gdata = shard_graph(
                src, part.edge_dst, part.num_edges_valid, part.in_degree,
                send_idx, part.shard_nodes, self.k, self.device,
                self.backend, cfg.aggregate_precision, self._xch_meta(),
                overlap=self._halo_overlap(),
                table_csr=self._needs_table_csr(), edge_map=self._edge_map)
            device_sync(self.device)
        self.build_s["csrs"] = sp.dur_s

    def _build_perhost(self):
        """``-perhost``: the parts from the ``.lux`` byte ranges
        (spmd.py:1383-1529, the vertex half), k = 1."""
        from roc_tpu_torch.graph import lux, shard_load
        cfg = self.config
        if not cfg.filename:
            raise SystemExit("error: -perhost needs -file (an on-disk .lux "
                             "dataset)")
        path = cfg.filename + lux.LUX_SUFFIX
        ag = shard_load.single_process_allgather
        P = int(cfg.num_parts)
        with obs.span("partition", parts=P) as sp:
            meta = shard_load.meta_from_lux(path, P, 0, ag)
            local = shard_load.load_local_shards(path, meta, range(P))
        self.build_s["partition"] = sp.dur_s
        self.part = meta
        self.local = local
        if self._exchange_mode == "halo":
            with obs.span("halo_build", parts=P) as sp:
                self.halo = shard_load.build_halo_local(meta, local, ag)
            self.build_s["halo_maps"] = sp.dur_s
            src, send_idx = self.halo.edge_src_local, self.halo.send_idx
        else:
            self.halo = None
            src, send_idx = local.edge_src, None
        with obs.span("plan_build", parts=P) as sp:
            self.gdata = shard_graph(
                src, local.edge_dst, meta.num_edges_valid, local.in_degree,
                send_idx, meta.shard_nodes, self.k, self.device,
                self.backend, cfg.aggregate_precision, self._xch_meta(),
                overlap=self._halo_overlap(),
                table_csr=self._needs_table_csr(), edge_map=self._edge_map)
            device_sync(self.device)
        self.build_s["csrs"] = sp.dur_s

    def _place_data(self):
        """The node tensors for the current partition, [P*S, ...] in part
        order, each part's block copied to the device on its own (a lazy
        dataset's memmap is read one part at a time), and the graph
        context (called from _setup and on every reshard)."""
        ds, part, dev = self.dataset, self.part, self.device
        P, S = part.num_parts, part.shard_nodes
        with obs.span("place", parts=P) as sp:
            self.x = torch.empty((P * S, ds.features.shape[1]),
                                 dtype=self.dtype, device=dev)
            self.labels = torch.empty((P * S, ds.num_classes),
                                      dtype=torch.float32, device=dev)
            self.mask = torch.empty(P * S, dtype=torch.int32, device=dev)
            for p in range(P):
                rows = slice(p * S, (p + 1) * S)
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
        """The skew report (spmd.py:1556-1570)."""
        m = self.part
        live = np.asarray(m.num_edges_valid, np.float64)
        print(f"# shards: P={m.num_parts} S={m.shard_nodes} "
              f"E={m.shard_edges} edges/shard min={int(live.min())} "
              f"mean={int(live.mean())} max={int(live.max())} "
              f"padded-max tax={padded_max_tax(m) * 100:.1f}%",
              file=sys.stderr)
        if self.halo is not None:
            print(f"# halo: K={self.halo.K} table rows="
                  f"{self.gdata.table_rows()} halo rows="
                  f"{self.halo.halo_rows_total}", file=sys.stderr)

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

    def wire_bytes(self) -> int:
        """Per-position wire bytes of one step's forward exchanges
        (roc_tpu's in-graph ``wire_bytes`` metric)."""
        xd, _, xc = self._xch_meta()
        return channel.wire_bytes_per_step(
            self._exchange_mode, self.part.num_parts, self.part.shard_nodes,
            self._aggregate_widths(), send_cols=self.gdata.K,
            xch_dtype=xd, xch_comp=xc)

    def _obs_setup(self):
        """The epoch record's ``wire_bytes`` and ``edges`` (one count per
        mesh position: the sum of its block's in-degrees, pad rows' 1.0
        included, as roc_tpu's ``jnp.sum(gd.in_degree)``), and the
        ledger's wire prediction (spmd.py:1796-1817)."""
        if self._metrics is None:
            return
        self._obs_wire = self.wire_bytes()
        kS = self.k * self.part.shard_nodes
        deg = self.gdata.in_degree
        self._obs_edges = [int(b.sum()) for b in deg.split(kS)]
        led = get_ledger()
        if led.attached:
            self._wire_key = content_key(mode=self._exchange_mode,
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
        (spmd.py:1887-1897)."""
        return (isinstance(self.part, Partition)
                and not self.config.perhost_load
                and self._exchange_mode in ("halo", "allgather")
                and self.k == 1)

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
