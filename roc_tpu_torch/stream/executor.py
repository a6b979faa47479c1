"""StreamTrainer: the out-of-core shard-rotation executor behind -stream
(roc_tpu/stream/executor.py).

The padded graph (features, labels, each shard's CSR, every
segment-boundary activation) lives in host stores of shape ``[P*S, d]``,
shard-major, the layout of ``graph/partition.py``.  The card holds only
``-stream-slots`` slots: preallocated device tensors (table, own rows,
CSR, cotangents) that every rotation refills in place.  An epoch is a
sequence of sweeps, one per model segment (``segments.py``), forward then
reverse, each rotating the P shards through the slots while the ring
copies shard i+1 under shard i's compute.

Copies: the ring's worker gathers a shard's table rows (``index_select``
over the shard's halo map) into the slot's pinned staging arena and
copies them, and the pinned store slices, to the slot with
``non_blocking=True`` on a side CUDA stream; the compute stream waits on
the copy's event.  A slot is refilled only after the side stream has
waited on the event the compute stream recorded when it last let the
slot go, and its staging only after its previous copies finished.  A
slot's table, own rows and cotangents share one device arena, sized to
the widest segment.

The backward sweep recomputes each segment's forward from its host-held
inputs (the streaming analog of the planner's REMAT) under autograd,
accumulates the parameter gradients on the card and sends the cotangents
of the table and own rows back to the host stores: the compute stream
copies them into one of two pinned pull buffers (so the card holds one
shard's at a time), and the ring's worker, overlapped with the next
shard's compute, adds them with the CPU ``index_add_`` on a torch view
of the fp32 cotangent store, in index order (roc_tpu runs
``np.add.at``, the same sums).  ``_drain_scatters`` waits for them
before a sweep that reads the cotangent stores and before the optimizer
step.

Each shard's dropout key is ``fold_in(step_key, i)`` and each op's
``fold_in(that, slot)`` (executor.py:711), so the masks are roc_tpu's
StreamTrainer's.  Shard loss terms and metric tallies are pure sums, so
the streamed epoch computes the in-core loss up to float reassociation.

Tiers: ``-bf16-storage`` keeps every float wire (stores, slots, boundary
outputs, the cotangent fetch) in bf16, rounded once to nearest even at
the store boundary, with fp32 compute and fp32 cotangent accumulators;
the edge wire narrows to 16 bits where a shard's rows fit (widened on the
card).  ``-stream-spill DIR`` moves the boundary stores to CRC'd memmaps
(``spill.py``).

Calibration (executor.py:227-244, 803-812): under ``-obs`` the setup
predicts the epoch's wire bytes (the port's own
``predicted_epoch_xfer_bytes``), the ring's overlap (1.0, prefetch hiding
every transfer) and the transfer seconds (the bytes over
``stream/host.py``'s ``STREAM_BW_BYTES_S``); each epoch measures them.

A graph stub (``-perhost`` loading, executor.py:189-200) streams straight
off the ``.lux`` byte ranges: process 0's cut (``shard_load.
meta_from_lux``) and every shard's padded edge arrays
(``load_local_shards``); the topology is never held whole.  ``-stream`` is
single-process: it trades host memory for device memory instead of
scaling out.

``reshard`` (the balancer's hook, executor.py:899-925) applies a new cut
under the frozen slot shapes: re-cut the graph (or re-read the moved byte
ranges on the ``.lux`` path), then rebuild the table maps with the halo
width frozen (``_stream_maps``' ``K_force``: a cut that needs more
raises, asking for a restart).  No slot is reallocated.  The balancer runs here
where it can probe the whole graph: a ``Csr`` graph, one process
(executor.py:371-376).
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch

from roc_tpu_torch import fault, obs, ops
from roc_tpu_torch.fault.guard import guarded_update, nan_scale
from roc_tpu_torch.graph import shard_load
from roc_tpu_torch.graph.csr import Csr
from roc_tpu_torch.graph.partition import _round_up, partition_graph
from roc_tpu_torch.graph.lux import LUX_SUFFIX, MASK_NONE
from roc_tpu_torch.obs.ledger import content_key, get_ledger
from roc_tpu_torch.parallel.halo import part_csrs
from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.softmax import PerfMetrics
from roc_tpu_torch.stream import host as stream_host
from roc_tpu_torch.stream import spill as stream_spill
from roc_tpu_torch.stream.ring import PrefetchRing
from roc_tpu_torch.stream.segments import (predicted_epoch_bytes,
                                           run_segment, split_segments)
from roc_tpu_torch.train.driver import Trainer
from roc_tpu_torch.train.graph_data import effective_backend, model_has_gat

__all__ = ["StreamTrainer"]


def _stream_maps(meta, edge_src, K_force=None):
    """Frozen-shape halo maps for the rotating table gather
    (executor.py:83-141): ``(K, tbl_idx, esrc_local)``, where
    ``tbl_idx[i]`` gathers shard i's ``[S + P*K]`` table from a ``[P*S, d]``
    store (its own S rows, then K halo rows per owner, unfilled entries on
    each owner's pad row S-1) and ``esrc_local[i]`` rewrites the padded
    global edge sources into that table."""
    P, S, E = int(meta.num_parts), int(meta.shard_nodes), int(meta.shard_edges)
    need = []
    kmax = 1
    for i in range(P):
        src = np.asarray(edge_src[i], np.int64)
        owner = src // S
        per = {}
        for q in np.unique(owner[owner != i]):
            rows = np.unique(src[owner == q] - q * S)
            per[int(q)] = rows
            kmax = max(kmax, len(rows))
        need.append(per)
    if K_force is None:
        K = _round_up(kmax + max(8, kmax // 4), 8)
    else:
        if kmax > K_force:
            raise ValueError(
                f"stream reshard: new cut needs halo width {kmax} > frozen "
                f"K={K_force}; restart -stream to rebuild the slot shapes")
        K = int(K_force)
    # roclint: allow(unpinned-host-buffer) host gather index over the host stores, never staged
    tbl_idx = np.empty((P, S + P * K), np.int64)
    # roclint: allow(unpinned-host-buffer) host index map, built once a cut into the parts' CSRs, not a rotated store
    esrc_local = np.empty((P, E), np.int32)
    owners_base = np.repeat(np.arange(P, dtype=np.int64) * S + (S - 1), K)
    for i in range(P):
        halo = owners_base.copy()
        for q, rows in need[i].items():
            halo[q * K: q * K + len(rows)] = q * S + rows
        tbl_idx[i, :S] = i * S + np.arange(S, dtype=np.int64)
        tbl_idx[i, S:] = halo
        src = np.asarray(edge_src[i], np.int64)
        owner = src // S
        local = src - owner * S
        out = local.copy()
        for q, rows in need[i].items():
            sel = owner == q
            out[sel] = S + q * K + np.searchsorted(rows, local[sel])
        esrc_local[i] = out.astype(np.int32)
    return K, tbl_idx, esrc_local


def _narrow(a: np.ndarray, bound: int, compact: bool) -> np.ndarray:
    """The 16-bit edge wire of the bf16 tier: indices below ``bound`` <=
    2^16 as int16 words (widened on the card), else int32."""
    if compact and bound <= 1 << 16:
        return a.astype(np.uint16).view(np.int16)
    return a.astype(np.int32)


def _widen(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.int16:
        return t.to(torch.int32).bitwise_and_(0xFFFF)
    return t


class _Slot:
    """One device slot: flat device buffers refilled in place (``feat``,
    one arena for a segment's table, own rows and cotangents), the pinned
    staging arena of its gathers and conversions, and its events."""

    def __init__(self, sizes: dict, dev: torch.device, pin: bool):
        self.dev = {k: torch.empty(n, dtype=dt, device=dev)
                    for k, (n, dt) in sizes.items()}
        n, dt = sizes["feat"]
        self.stage = torch.empty(n, dtype=dt, pin_memory=pin)
        cuda = dev.type == "cuda"
        self.copied = torch.cuda.Event() if cuda else None
        self.released = torch.cuda.Event() if cuda else None


class StreamTrainer(Trainer):
    """Host-streaming trainer: fixed device slots, rotating shards.
    ``bounds`` overrides the greedy cut (inclusive (lo, hi) per part) of a
    ``Csr`` graph."""

    def __init__(self, config, dataset, model, bounds=None):
        if config.multihost:
            raise SystemExit("error: -stream is single-process (it is the "
                             "out-of-core alternative to scaling out across "
                             "hosts; -multihost scales out through the SPMD "
                             "trainer)")
        self._init_bounds = bounds
        super().__init__(config, dataset, model)

    # -- setup -------------------------------------------------------------

    def _setup(self):
        cfg, ds, dev = self.config, self.dataset, self.device
        if self.dtype != torch.float32:
            raise SystemExit("error: -stream computes in fp32 (-bf16 casts "
                             "the whole model; use -bf16-storage to stream "
                             "bf16 slots with fp32 compute)")
        P = int(cfg.num_parts)
        if P < 2:
            raise SystemExit("error: -stream needs -parts >= 2 (one slot "
                             "computing, at least one in flight)")
        if cfg.bf16_storage and (cfg.bf16_rounding != "nearest"
                                 or cfg.bf16_exchange != "plain"):
            raise SystemExit("error: -stream bf16 slots implement the "
                             "nearest/plain wire contract only (stochastic "
                             "rounding and compensated exchange live in the "
                             "SPMD trainer's exchange codec)")
        if getattr(self, "_ring", None) is not None:
            self.close()
        self._P = P
        self._bf16 = bool(cfg.bf16_storage)
        self._sdtype = torch.bfloat16 if self._bf16 else torch.float32
        self._np_sdtype = stream_host.BF16 if self._bf16 else \
            np.dtype(np.float32)
        self._spill_dir = str(cfg.stream_spill or "")
        if self._spill_dir:
            os.makedirs(self._spill_dir, exist_ok=True)
        self.backend = effective_backend(cfg, self.model, dev)
        self._edge_map = self.backend == "kernel" and model_has_gat(
            self.model)
        self._lux_path = ""
        if isinstance(ds.graph, Csr):
            self.part = partition_graph(
                ds.graph, P, bounds=None if self._init_bounds is None
                else np.asarray(self._init_bounds, np.int64))
            meta = self.part.meta
            arrays = (self.part.edge_src, self.part.edge_dst,
                      self.part.in_degree)
        else:
            # a GraphStub: stream straight off the .lux byte ranges
            if not cfg.filename:
                raise SystemExit("error: -stream on a graph stub needs "
                                 "-file (an on-disk .lux dataset)")
            self._lux_path = cfg.filename + LUX_SUFFIX
            meta = self.part = shard_load.meta_from_lux(self._lux_path, P)
            arrays = self._load_lux_shards(meta)
        self.segments = split_segments(self.model)
        self._nseg = len(self.segments)
        self._install_graph(meta, *arrays)
        self._alloc_stores()
        self.params = self.model.init_params(self.key, device=dev)
        self.opt_state = self.optimizer.init(self.params)
        self.num_nodes = int(meta.num_nodes)
        self._resolve_mem_plan()
        self._alloc_slots()
        cuda = dev.type == "cuda"
        self._side = torch.cuda.Stream(dev) if cuda else None
        init = None
        if cuda:
            # set_device needs an index; "cuda" alone names the current one
            init = functools.partial(
                torch.cuda.set_device,
                torch.cuda.current_device() if dev.index is None
                else dev.index)
        self._ring = PrefetchRing(cfg.stream_slots, self._fetch,
                                  initializer=init)
        self._fetches = 0
        self._grad_acc = None
        self._xfer_bytes = 0
        self._scatter_futs = []
        self._scatter_s = 0.0
        self._scatter_wait_s = 0.0
        self._spill_read_s = 0.0
        self._spill_write_s = 0.0
        self._spill_read_bytes = 0
        self._spill_write_bytes = 0
        self._logits_sink = None
        self._epoch_stream = []
        self._last_stream_stats = None
        led = get_ledger()
        if led.attached:
            self._wire_key = content_key(parts=P, segments=self._nseg,
                                         slots=int(cfg.stream_slots))
            pred = self.predicted_epoch_xfer_bytes()["port"]
            led.predict("wire_bytes", self._wire_key, pred, "bytes")
            led.predict("overlap_frac", self._wire_key, 1.0, "frac")
            led.predict("stream_xfer_s", self._wire_key,
                        pred / stream_host.STREAM_BW_BYTES_S, "s")
        if cfg.verbose:
            budget = cfg.stream_budget_bytes()
            held = cfg.stream_slots * self.slot_bytes()
            note = ""
            if budget:
                note = (f" vs budget {budget / 2**20:.0f} MiB "
                        f"({'fits' if held <= budget else 'OVER'})")
            tier = "bf16" if self._bf16 else "fp32"
            pinned = stream_host.pinned_supported()
            if self._spill_dir:
                tier += f"+spill({self._spill_dir})"
            print(f"# stream: {P} shards x {self._nseg} segments through "
                  f"{cfg.stream_slots} slots, ~{held / 2**20:.1f} MiB "
                  f"device-resident{note}, halo K={self._K}, {tier} slots, "
                  f"{'pinned' if pinned else 'pageable'} host stores")

    def _load_lux_shards(self, meta):
        """Every shard's padded edge arrays from the ``.lux`` byte
        ranges."""
        shards = shard_load.load_local_shards(self._lux_path, meta,
                                              range(int(meta.num_parts)))
        return shards.edge_src, shards.edge_dst, shards.in_degree

    def _install_graph(self, meta, edge_src, edge_dst, in_degree,
                       K_force=None):
        """The cut's table map, each shard's CSR and the padded node
        stores, all on the host (the boundary stores do not depend on the
        cut: a reshard keeps them)."""
        self._meta = meta
        P = self._P
        S, E = int(meta.shard_nodes), int(meta.shard_edges)
        self._S, self._E = S, E
        K, tbl_idx, esrc_local = _stream_maps(meta, edge_src, K_force)
        self._K = K
        self._T = T = S + P * K
        self._tbl_idx = tbl_idx
        self._tbl_idx_t = torch.from_numpy(tbl_idx)
        row_ptr, col, t_row_ptr, t_col, t_pos = part_csrs(
            esrc_local, np.asarray(edge_dst, np.int64), S, T, self._edge_map)
        compact = self._bf16
        to_store = stream_host.to_store
        self._row_ptr = to_store(row_ptr)
        self._col = to_store(_narrow(col, T, compact))
        self._t_row_ptr = to_store(t_row_ptr)
        self._t_col = to_store(_narrow(t_col, S, compact))
        self._t_pos = None if t_pos is None else to_store(t_pos)
        self._indeg = to_store(np.asarray(in_degree, np.float32))
        ds = self.dataset
        # one nearest-even rounding per value at load, the storage contract
        self._store_x = self._store_rows(meta.pad_nodes(
            np.asarray(ds.features, np.float32)))
        self._labels = self._store_rows(meta.pad_nodes(
            ds.onehot_labels().astype(np.float32)))
        self._mask = to_store(meta.pad_nodes(np.asarray(ds.mask, np.int32),
                                             fill=MASK_NONE))
        if hasattr(self, "_stores"):
            self._stores[0] = self._store_x

    def _store_rows(self, a: np.ndarray) -> np.ndarray:
        """A host store of ``a`` in the storage dtype (bf16 rounded to
        nearest even by torch's cast)."""
        out = stream_host.alloc(a.shape, self._np_sdtype)
        stream_host.torch_view(out).copy_(torch.from_numpy(a))
        return out

    def _alloc_stores(self):
        """Boundary-activation stores (storage dtype) and their fp32
        cotangent accumulators; tid 0 is the padded feature store.  Under
        -stream-spill both are CRC'd memmaps (executor.py:307-337)."""
        PS = self._P * self._S
        dims = {}
        for seg in self.segments:
            dims.update(seg.out_dims)
        self._stores = {0: self._store_x}
        self._cots = {}
        self._spill_tids = set()
        for seg in self.segments:
            for t in seg.out_tids:
                if self._spill_dir:
                    self._stores[t] = stream_spill.create_store(
                        os.path.join(self._spill_dir, f"act{t}.spill"),
                        (PS, dims[t]), self._np_sdtype)
                    self._cots[t] = stream_spill.create_store(
                        os.path.join(self._spill_dir, f"cot{t}.spill"),
                        (PS, dims[t]), np.float32)
                    self._spill_tids.add(t)
                else:
                    self._stores[t] = stream_host.alloc(
                        (PS, dims[t]), self._np_sdtype)
                    self._cots[t] = stream_host.alloc((PS, dims[t]),
                                                      np.float32)

    def _seg_floats(self, seg) -> tuple:
        """(table, own, cots) element counts of one segment's slot."""
        S, T = self._S, self._T
        table = T * seg.out_dims[seg.table_tid] if seg.head is not None else 0
        own = sum(S * seg.out_dims[t] for t in seg.own_in_tids)
        cots = 0 if seg.is_last else sum(S * seg.out_dims[t]
                                         for t in seg.out_tids)
        return table, own, cots

    def _alloc_slots(self):
        """``stream_slots`` device slots sized to the widest segment, and
        two pinned pull buffers for the cotangents the scatters add."""
        S, E, T = self._S, self._E, self._T
        sd = self._sdtype
        C = self.dataset.num_classes
        per_seg = [self._seg_floats(seg) for seg in self.segments]
        sizes = {"feat": (max(sum(f) for f in per_seg), sd),
                 "labels": (S * C, sd), "mask": (S, torch.int32),
                 "indeg": (S, torch.float32),
                 "row_ptr": (S + 1, torch.int64),
                 "col": (E, torch.from_numpy(self._col[:0]).dtype),
                 "t_row_ptr": (T + 1, torch.int64),
                 "t_col": (E, torch.from_numpy(self._t_col[:0]).dtype)}
        if self._t_pos is not None:
            sizes["t_pos"] = (E, torch.int32)
        pin = stream_host.pinned_supported()
        self._slots = [_Slot(sizes, self.device, pin)
                       for _ in range(self.config.stream_slots)]
        pull = max(t + o for t, o, _ in per_seg)
        self._pulls = [torch.empty(pull, dtype=sd, pin_memory=pin)
                       for _ in range(2)]
        self._pull_futs = [None, None]
        self._npull = 0

    def slot_bytes(self) -> int:
        """Bytes one device slot holds (executor.py:351-369: table, own
        rows, cotangents, outputs, the edge wire), the worst segment's;
        what -stream-budget should be sized to, times the ring depth.  The
        port's edge wire is the shard's CSR and its transpose."""
        S, E, T = self._S, self._E, self._T
        ai = 2 if self._bf16 else 4
        csr = (S + 1 + T + 1) * 8 + E * (self._col.itemsize
                                         + self._t_col.itemsize)
        if self._t_pos is not None:
            csr += E * 4
        worst = 0
        for seg in self.segments:
            b = csr + S * 4 + sum(self._seg_floats(seg)) * ai
            for t in seg.out_tids:
                b += S * seg.out_dims[t] * 4
            worst = max(worst, b)
        return worst

    def predicted_epoch_xfer_bytes(self) -> dict:
        """One training epoch's host-to-card bytes: roc_tpu's
        ``predicted_epoch_bytes`` (its two-array edge wire) and the port's
        own (each fetch ships the shard's CSR, and the backward's also its
        transpose and GAT's edge map), both at this run's itemsizes."""
        P, S, E, T = self._P, self._S, self._E, self._T
        ai = 2 if self._bf16 else 4
        ci, ti = self._col.itemsize, self._t_col.itemsize
        roc = predicted_epoch_bytes(
            self.segments, P, S, E, self._K, self.dataset.num_classes,
            act_itemsize=ai, esrc_itemsize=ci, edst_itemsize=ti)
        fwd_csr = (S + 1) * 8 + E * ci
        bwd_csr = fwd_csr + (T + 1) * 8 + E * ti + \
            (E * 4 if self._t_pos is not None else 0)
        n = self._nseg
        port = roc - (2 * n - 1) * P * E * (ci + ti) \
            + (n - 1) * P * fwd_csr + n * P * bwd_csr
        return {"roc_tpu": int(roc), "port": int(port)}

    # -- host <-> device ----------------------------------------------------

    def _stream_ctx(self):
        return torch.cuda.stream(self._side) if self._side is not None \
            else contextlib.nullcontext()

    def _fetch(self, item):
        """Worker side: fill the next slot with one shard's inputs and
        start its copies; returns the slot's tensors."""
        phase, k, i = item
        seg = self.segments[k]
        S, T = self._S, self._T
        lo = i * S
        s = self._fetches % len(self._slots)
        self._fetches += 1
        slot = self._slots[s]
        if slot.copied is not None:
            slot.copied.synchronize()      # its staging is free again
        out = {"slot": s}
        moved = 0

        def put(name, src: torch.Tensor, shape):
            nonlocal moved
            n = src.numel()
            dst = slot.dev[name][:n].view(shape)
            dst.copy_(src.reshape(shape), non_blocking=True)
            moved += src.numel() * src.element_size()
            return dst

        with self._stream_ctx():
            if slot.released is not None:
                self._side.wait_event(slot.released)
            out["row_ptr"] = put("row_ptr", torch.from_numpy(
                self._row_ptr[i]), (S + 1,))
            out["col"] = put("col", torch.from_numpy(self._col[i]), (-1,))
            if phase == "bwd":
                out["t_row_ptr"] = put("t_row_ptr", torch.from_numpy(
                    self._t_row_ptr[i]), (T + 1,))
                out["t_col"] = put("t_col", torch.from_numpy(
                    self._t_col[i]), (-1,))
                if self._t_pos is not None:
                    out["t_pos"] = put("t_pos", torch.from_numpy(
                        self._t_pos[i]), (-1,))
            out["indeg"] = put("indeg", torch.from_numpy(self._indeg[i]),
                               (S,))
            off = 0

            def feat(src: torch.Tensor, rows: int, d: int) -> torch.Tensor:
                """Copy ``src`` into the slot's arena at ``off``."""
                nonlocal moved, off
                dst = slot.dev["feat"][off:off + rows * d].view(rows, d)
                dst.copy_(src.reshape(rows, d), non_blocking=True)
                moved += src.numel() * src.element_size()
                off += rows * d
                return dst

            if seg.head is not None:
                tid = seg.table_tid
                d = seg.out_dims[tid]
                stage = slot.stage[:T * d]
                with obs.span("stream_gather", seg=k, shard=i) as gsp:
                    torch.index_select(
                        stream_host.torch_view(self._stores[tid]), 0,
                        self._tbl_idx_t[i], out=stage.view(T, d))
                if tid in self._spill_tids:
                    self._spill_read_s += gsp.dur_s
                    self._spill_read_bytes += stage.numel() * \
                        stage.element_size()
                out["table"] = feat(stage, T, d)
            own = {}
            for t in seg.own_in_tids:
                d = seg.out_dims[t]
                own[t] = feat(self._rows(self._stores[t], t, lo, i,
                                         slot.stage[off:off + S * d]), S, d)
            out["own"] = own
            if seg.is_last:
                C = self.dataset.num_classes
                out["labels"] = put("labels", stream_host.torch_view(
                    self._labels[lo:lo + S]), (S, C))
                out["mask"] = put("mask", torch.from_numpy(
                    self._mask[lo:lo + S]), (S,))
            if phase == "bwd" and not seg.is_last:
                # the cotangent wire rides the storage dtype: one rounding
                # here, the fp32 accumulation left in the store
                out["cots"] = {t: feat(self._rows(
                    self._cots[t], t, lo, i,
                    slot.stage[off:off + S * seg.out_dims[t]],
                    convert=self._bf16), S, seg.out_dims[t])
                    for t in seg.out_tids}
            if slot.copied is not None:
                slot.copied.record(self._side)
        out["copied"] = slot.copied
        self._xfer_bytes += moved
        fault.point("stream.device_put")
        return out

    def _rows(self, store, tid, lo, shard, stage: torch.Tensor,
              convert: bool = False) -> torch.Tensor:
        """One shard's rows of a host or spill store as a tensor the copy
        can read: the pinned store slice itself, or (a spill store, or a
        cotangent converted to bf16) a copy in the slot's staging."""
        view = store[lo:lo + self._S]
        src = stream_host.torch_view(view)
        if tid in self._spill_tids:
            with obs.span("stream_spill_read", tid=tid, shard=shard) as sp:
                stage.copy_(src.reshape(-1))
            self._spill_read_s += sp.dur_s
            self._spill_read_bytes += view.nbytes
            return stage
        if convert:
            stage.copy_(src.reshape(-1))
            return stage
        return src

    def _release(self, a):
        """The compute stream lets slot ``a`` go: a later fill waits for
        what was enqueued so far."""
        ev = self._slots[a["slot"]].released
        if ev is not None:
            ev.record(torch.cuda.current_stream(self.device))

    def _wait_copied(self, a):
        if a["copied"] is not None:
            torch.cuda.current_stream(self.device).wait_event(a["copied"])

    def _csr(self, a) -> ops.DeviceCsr:
        return ops.DeviceCsr(a["row_ptr"], _widen(a["col"]),
                             a.get("t_row_ptr"),
                             _widen(a["t_col"]) if "t_col" in a else None,
                             a.get("t_pos"))

    def _sweep(self, phase, k, consume):
        """Rotate the P shards of one (phase, segment) sweep through the
        slots; prefetch never crosses the sweep's end (the next sweep reads
        stores this one is still writing)."""
        ring = self._ring
        items = [(phase, k, i) for i in range(self._P)]
        for j, it in enumerate(items):
            for nxt in items[j:j + ring.num_slots]:
                if not ring.ensure(nxt):
                    break
            a = ring.wait(it)
            self._wait_copied(a)
            with obs.span("stream_rotate", phase=phase, seg=k, shard=it[2]):
                consume(it[2], a)
            self._release(a)

    def _write_outs(self, i, outs):
        """One shard's boundary outputs (already in the storage dtype) into
        their stores; spill writes under their own span (they block the
        consumer: the spill-stall signal)."""
        lo = i * self._S

        def write(t):
            stream_host.torch_view(
                self._stores[t][lo:lo + self._S]).copy_(outs[t])

        spilled = [t for t in outs if t in self._spill_tids]
        for t in outs:
            if t not in self._spill_tids:
                write(t)
        if spilled:
            with obs.span("stream_spill_write", shard=i,
                          tids=len(spilled)) as sp:
                for t in spilled:
                    write(t)
            self._spill_write_s += sp.dur_s
            self._spill_write_bytes += sum(
                outs[t].numel() * outs[t].element_size() for t in spilled)

    def _scatter_async(self, seg, i, dt, down):
        """Send shard i's cotangents to the host stores: their copy into a
        pinned pull buffer on the compute stream (so the card holds one
        shard's at a time), then, on the ring's worker, the adds into the
        fp32 stores once the copy's event has fired.  Two pull buffers
        alternate; one is reused only after the adds that read it.  Only
        the wait for the copy is retried: the adds run once."""
        b = self._npull % 2
        self._npull += 1
        if self._pull_futs[b] is not None:
            self._pull_futs[b].result()
        buf, off, host = self._pulls[b], 0, {}
        for t, g in ([("table", dt)] if dt is not None else []) + \
                list(down.items()):
            host[t] = buf[off:off + g.numel()].view(g.shape)
            host[t].copy_(g, non_blocking=True)
            off += g.numel()
        ev = None
        if self._side is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))

        def pull():
            fault.point("stream.scatter")
            if ev is not None:
                ev.synchronize()
            return host

        def work():
            with obs.span("stream_scatter", seg=seg.index, shard=i) as sp:
                got = fault.retrying("stream.scatter", pull,
                                     retry_on=(OSError, RuntimeError))
                lo = i * self._S
                for t, h in got.items():
                    h = h.to(torch.float32)
                    if t == "table":
                        torch.from_numpy(self._cots[seg.table_tid]) \
                            .index_add_(0, self._tbl_idx_t[i], h)
                    else:
                        torch.from_numpy(
                            self._cots[t][lo:lo + self._S]).add_(h)
            self._scatter_s += sp.dur_s

        fut = self._ring.submit(work)
        self._pull_futs[b] = fut
        self._scatter_futs.append(fut)

    def _drain_scatters(self):
        """Wait for the queued scatters (worker errors re-raise here); only
        time blocked on unfinished ones counts against overlap."""
        futs, self._scatter_futs = self._scatter_futs, []
        if not futs:
            return
        if not futs[-1].done():
            with obs.span("stream_scatter_wait", pending=len(futs)) as sp:
                for f in futs:
                    f.result()
            self._scatter_wait_s += sp.dur_s
        else:
            for f in futs:
                f.result()

    # -- one segment on one shard ------------------------------------------

    def _run(self, seg, a, params, key, train, table=None, own=None):
        f32 = torch.float32
        tab = a.get("table") if table is None else table
        own = a["own"] if own is None else own
        return run_segment(
            seg, params, None if tab is None else tab.to(f32),
            {t: v.to(f32) for t, v in own.items()}, self._csr(a),
            a["indeg"], key, train, self.backend,
            self.config.aggregate_precision)

    # -- epoch execution ---------------------------------------------------

    def _train_step(self, key, alpha: float, scale: float):
        P, n = self._P, self._nseg
        self._ring.reset_epoch_stats()
        self._xfer_bytes = 0
        self._scatter_s = self._scatter_wait_s = 0.0
        self._spill_read_s = self._spill_write_s = 0.0
        self._spill_read_bytes = self._spill_write_bytes = 0
        keys = [prng.fold_in(key, i) for i in range(P)]
        for c in self._cots.values():
            c[:] = 0.0
        self._grad_acc = {}
        loss_parts = []
        with obs.span("stream_epoch", parts=P, segments=n) as sp:
            for k in range(n - 1):
                self._sweep("fwd", k, self._consume_fwd(k, keys))
            req = {name: p.detach().requires_grad_(True)
                   for name, p in self.params.items()}
            for k in range(n - 1, -1, -1):
                self._drain_scatters()
                self._sweep("bwd", k, self._consume_bwd(k, keys, req,
                                                        loss_parts))
            self._drain_scatters()
            grads = {name: self._grad_acc.get(name, torch.zeros_like(p))
                     for name, p in self.params.items()}
            if scale != 1.0:
                grads = {name: g * scale for name, g in grads.items()}
            loss = torch.stack(loss_parts).sum()
            (self.params, self.opt_state, self._last_nonfinite,
             self._last_gnorm) = guarded_update(
                self.optimizer, self.params, grads, self.opt_state, alpha)
        self._note_epoch_stats(sp.dur_s)
        return loss

    def _consume_fwd(self, k, keys):
        seg = self.segments[k]

        def consume(i, a):
            with torch.no_grad():
                vals = self._run(seg, a, self.params, keys[i], True)
            self._write_outs(i, {t: vals[t].to(self._sdtype)
                                 for t in seg.out_tids})

        return consume

    def _consume_bwd(self, k, keys, req, loss_parts):
        seg = self.segments[k]
        f32 = torch.float32
        names = list(req)

        def consume(i, a):
            table = a.get("table")
            if table is not None and seg.table_tid in self._cots:
                table = table.detach().requires_grad_(True)
            own = {t: (v.detach().requires_grad_(True) if t in self._cots
                       else v) for t, v in a["own"].items()}
            vals = self._run(seg, a, req, keys[i], True, table, own)
            if seg.is_last:
                loss = ops.masked_softmax_cross_entropy(
                    vals[self.model.logits.id], a["labels"].to(f32),
                    a["mask"])
                loss_parts.append(loss.detach())
                outs, cots = [loss], None
            else:
                outs = [vals[t] for t in seg.out_tids]
                cots = [a["cots"][t].to(f32) for t in seg.out_tids]
            wrt = [req[name] for name in names]
            diff_own = [t for t, v in own.items() if v.requires_grad]
            if table is not None and table.requires_grad:
                wrt.append(table)
            wrt += [own[t] for t in diff_own]
            live = [j for j, o in enumerate(outs) if o.requires_grad]
            if not live:
                return
            outs = [outs[j] for j in live]
            if cots is not None:
                cots = [cots[j] for j in live]
            grads = torch.autograd.grad(outs, wrt, grad_outputs=cots,
                                        allow_unused=True)
            for name, g in zip(names, grads):
                if g is None:  # a parameter of another segment
                    continue
                acc = self._grad_acc.get(name)
                self._grad_acc[name] = g if acc is None else acc + g
            rest = list(grads[len(names):])
            dt = rest.pop(0) if table is not None and table.requires_grad \
                else None
            down = {t: g for t, g in zip(diff_own, rest) if g is not None}
            if dt is not None or down:
                self._scatter_async(seg, i, dt, down)

        return consume

    def _note_epoch_stats(self, wall_s):
        st = self._ring.epoch_stats()
        wall = max(float(wall_s), 1e-12)
        scat_overlap = 1.0 - self._scatter_wait_s / max(self._scatter_s,
                                                        1e-12)
        self._last_stream_stats = {
            "stream_stall_s": round(st["stall_s"], 6),
            "stream_transfer_s": round(st["transfer_s"], 6),
            "stream_overlap_frac": round(st["overlap_frac"], 4),
            "stream_stall_frac": round(min(st["stall_s"] / wall, 1.0), 4),
            "stream_bytes": int(self._xfer_bytes),
            "stream_scatter_s": round(self._scatter_s, 6),
            "stream_scatter_overlap_frac": round(
                min(max(scat_overlap, 0.0), 1.0), 4),
        }
        if self._spill_dir:
            self._last_stream_stats.update({
                "stream_spill_read_s": round(self._spill_read_s, 6),
                "stream_spill_write_s": round(self._spill_write_s, 6),
                "stream_spill_bytes": int(self._spill_read_bytes
                                          + self._spill_write_bytes),
                "stream_spill_stall_frac": round(
                    min(self._spill_write_s / wall, 1.0), 4),
            })
        self._epoch_stream.append(
            dict(self._last_stream_stats, epoch=int(self.epoch)))
        led = get_ledger()
        wk = getattr(self, "_wire_key", None)
        if led.attached and wk is not None:
            # wire bytes pair in the trainer's _obs_epoch, from the record
            led.measure("overlap_frac", wk, st["overlap_frac"], "frac",
                        epoch=int(self.epoch))
            led.measure("stream_xfer_s", wk, st["transfer_s"], "s",
                        epoch=int(self.epoch))

    def _obs_epoch_extra(self, epoch):
        del epoch
        return dict(self._last_stream_stats) \
            if self._last_stream_stats else None

    def stream_stats(self) -> dict:
        """The ring's geometry and the per-epoch stats."""
        return dict(self._last_stream_stats or {},
                    slots=int(self.config.stream_slots),
                    num_parts=self._P, segments=self._nseg,
                    halo_width=self._K, slot_bytes=self.slot_bytes(),
                    stream_dtype="bf16" if self._bf16 else "fp32",
                    stream_spill=self._spill_dir,
                    host_stores=stream_host.stats(),
                    epochs=list(self._epoch_stream))

    # -- eval / inference --------------------------------------------------

    def evaluate(self) -> PerfMetrics:
        n = self._nseg
        for k in range(n - 1):
            self._sweep("eval", k, self._consume_eval_mid(k))
        acc = []
        self._sweep("eval", n - 1, self._consume_eval_last(acc))
        return PerfMetrics(*(sum(m[j] for m in acc)
                             for j in range(len(acc[0]))))

    def _consume_eval_mid(self, k):
        seg = self.segments[k]

        def consume(i, a):
            with torch.no_grad():
                vals = self._run(seg, a, self.params, None, False)
            self._write_outs(i, {t: vals[t].to(self._sdtype)
                                 for t in seg.out_tids})

        return consume

    def _consume_eval_last(self, acc):
        seg = self.segments[-1]

        def consume(i, a):
            with torch.no_grad():
                vals = self._run(seg, a, self.params, None, False)
                logits = vals[self.model.logits.id]
                acc.append(ops.perf_metrics(
                    logits, a["labels"].to(torch.float32), a["mask"]))
            if self._logits_sink is not None:
                lo = i * self._S
                self._logits_sink[lo:lo + self._S].copy_(logits)

        return consume

    def predict_logits(self) -> torch.Tensor:
        """Inference logits [N, C] in node order, on the device (the sweeps
        write the padded [P*S, C] shard-major rows; the padding is
        dropped)."""
        # roclint: allow(unpinned-host-buffer) device->host sink of the logits, never ships
        sink = torch.zeros((self._P * self._S, self.dataset.num_classes),
                           dtype=torch.float32)
        self._logits_sink = sink
        try:
            self.evaluate()
        finally:
            self._logits_sink = None
        rows = np.concatenate([
            np.arange(p * self._S, p * self._S + int(nv))
            for p, nv in enumerate(self._meta.num_valid)])
        return sink[torch.from_numpy(rows)].to(self.device)

    # -- resharding (the balancer's hook) -------------------------------------

    def _balance_supported(self) -> bool:
        """The balancer probes the whole graph: a ``Csr`` graph, one
        process (executor.py:371-376); the ``.lux`` path still reshards
        when called."""
        return isinstance(self.dataset.graph, Csr)

    def reshard(self, new_bounds) -> float:
        """Apply a cut at an epoch boundary under the frozen slot shapes
        (S, E and the halo width K): pure host work, no slot reallocated.
        Returns the wall seconds."""
        bounds = np.asarray(new_bounds, np.int64)
        self._drain_scatters()
        with obs.span("reshard", parts=self._P, mode="stream") as sp:
            if self._lux_path:
                meta = self.part = shard_load.meta_from_lux(
                    self._lux_path, self._P, bounds=bounds,
                    shard_nodes=self._S, shard_edges=self._E)
                arrays = self._load_lux_shards(meta)
            else:
                self.part = partition_graph(
                    self.dataset.graph, self._P, bounds=bounds,
                    shard_nodes=self._S, shard_edges=self._E)
                meta = self.part.meta
                arrays = (self.part.edge_src, self.part.edge_dst,
                          self.part.in_degree)
            self._install_graph(meta, *arrays, K_force=self._K)
        return sp.dur_s

    def close(self) -> None:
        """Stop the ring's worker."""
        self._drain_scatters()
        self._ring.close()
        self._ring = None
