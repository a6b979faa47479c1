"""Crash-consistent dynamic-graph deltas for the serving engine
(roc_tpu/serve/delta.py).

Three pieces, one discipline (journal before memory, memory before the
device, the device swap under the plan lock):

  DeltaJournal   append-only write-ahead log, byte for byte roc_tpu's: one
                 CRC32-framed record per applied batch, monotone sequence
                 numbers, fsync before the acknowledgement.  Open
                 truncates a torn tail (a crash mid-append); a CRC
                 mismatch with bytes after it, or a sequence gap, is bit
                 rot: a typed DeltaJournalError, never a guess.  A journal
                 written by either package opens in the other.
  _RowStore      the host's live graph: the CSR of the last rebuild
                 (NumPy) plus a dict of the rows touched since, each row's
                 live sources in roc_tpu's global order (base order, then
                 appends).  The last occurrence of s in row d is then the
                 most recently added live instance of (s, d), the one
                 roc_tpu retires.  Classify, retire and no-op cost
                 O(batch x row length); the whole live CSR is
                 materialized only at a checkpoint and a replan.
  DeltaManager   validation (an out-of-range id -> DeltaError, nothing
                 journaled), warn-once idempotence (re-adding a live edge,
                 retiring a dead one: counted no-ops), the row patch, the
                 escalation ladder, snapshot and restore, restart replay,
                 the obs spans, counters, the delta-apply ledger pair and
                 the watchdog's delta EWMA.

The patch.  roc_tpu re-cuts the binned cells a delta touches; the port's
graph is a ``DeviceCsr``, so its patch rewrites rows.  The engine places
no transpose for serving, so there is none to patch.  The manager owns two
device CSR buffers (row_ptr [N+1] int64, col_idx [capacity] int32, the
in-degrees [N] float32) of one capacity, the live edges plus
``HEADROOM_EDGES``.  A batch commits to the host store, then writes the
new CSR into the idle buffer: the new row_ptr and the touched rows'
sources cross to the device, and every untouched row moves on the device
by its row_ptr shift (one ``torch.cat`` of the old buffer's untouched runs
and the touched rows, written in place); the in-degrees are the active
buffer's with the touched rows replaced.  The buffers then swap under the
engine's plan lock.  So a patch never rebuilds the CSR, never allocates a
buffer and never builds a kernel, and after any sequence of batches the
device row_ptr / col_idx are bitwise
``DeviceCsr.from_csr(from_edges(N, *live_edges()), transpose=False)``.
``cells_patched`` keeps roc_tpu's name in the counters; here it counts the
rows rewritten.

Every write runs on the device's current stream, as the serving forward
does, and a forward that read a buffer finished (its window synced its
rows to the host) before the swap that retired the buffer, so the next
patch can overwrite it.

The escalation ladder: a batch that takes the live edges past the
capacity is journaled and committed to the host store, and returns mode
``"replanning"``: a background thread allocates larger buffers and fills
them from the materialized live CSR while the old buffers keep serving,
swaps them in under the plan lock (kill windows ``delta.swap.kill_pre`` /
``_post``), adopts the live CSR as the new base and checkpoints.

Snapshots (``<journal>.snapshot.npz``, ``train.checkpoint.save_arrays``)
keep roc_tpu's ``kind``, ``seq``, ``rebuilt`` and ``counters``; in place of
roc_tpu's plan cells (``fwd_p1`` ... ``bwd_p2``) the port's holds its base
CSR and the override rows.  The port restores from roc_tpu's snapshot
through its ``live_src`` / ``live_dst``; roc_tpu cannot read the port's
plan-less snapshot.

Accepted: in-core engines on the kernel backend whose every aggregation is
sum or avg (GCN, gcn-chain, GIN, SAGE-mean, with or without
``-megafuse``).  Refused with DeltaError: ``-stream``, the plain ``xla``
backend, GAT (as roc_tpu refuses them), and max/min aggregation: roc_tpu's
extreme aggregations read its unpatched edge list and serve the base
graph, and the port neither copies that stale answer nor invents another.

Chaos sites (fault/inject.py):
  delta.apply                 transient reject before the journal write
  delta.journal.append/.fsync transient I/O faults inside the retried
                              append (recovered by fault.retrying)
  delta.journal.kill_record   kill -9 before any record byte lands
  delta.journal.kill_fsync    kill -9 after the write, before fsync
  delta.journal.kill_ack      kill -9 after fsync, before the patch
  delta.replan.slow           stall the background replan (the old
                              buffers keep serving)
  delta.swap.kill_pre/_post   kill -9 either side of the buffer swap
  delta.ckpt.write/kill_tmp/kill_rename   the snapshot writer
                              (train.checkpoint.save_arrays)
  delta.ckpt.kill_snap        kill -9 between snapshot and truncate

Restart replays the journal over the frozen graph (or the latest snapshot)
through the same apply path and reaches the exact served state.

Locks: ``_mu`` (mutations) is taken before the engine's ``_plan_lock``;
queries take only the plan lock.
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading
import warnings
import zlib
from typing import Optional

import numpy as np
import torch

from roc_tpu_torch import fault, obs
from roc_tpu_torch.analysis import witness as _witness
from roc_tpu_torch.graph.csr import from_edges
from roc_tpu_torch.obs import roofline
from roc_tpu_torch.obs.ledger import content_key, get_ledger
from roc_tpu_torch.ops.aggregate import DeviceCsr, note_csr_build
from roc_tpu_torch.stream.host import STREAM_BW_BYTES_S
from roc_tpu_torch.train import checkpoint as _ckpt
from roc_tpu_torch.train.graph_data import DenseGraphData

__all__ = ["DeltaError", "DeltaJournalError", "DeltaJournal",
           "DeltaManager", "HEADROOM_EDGES"]

# Edges a device buffer holds beyond the live edges at its (re)build: the
# net growth the patch path absorbs before a batch escalates to a replan.
HEADROOM_EDGES = 1 << 16


class DeltaError(ValueError):
    """A rejected delta batch (malformed/out-of-range input) or a delta
    operation against an engine that cannot accept one.  Rejected
    batches are never journaled and never partially applied."""


class DeltaJournalError(RuntimeError):
    """A delta journal that cannot be trusted: bad magic/header, CRC
    bit rot with valid bytes after it, a sequence gap, or a snapshot
    newer than the journal's base.  (A torn TAIL is not an error — the
    crash window the WAL exists for — it is truncated on open.)"""


# -- journal framing --------------------------------------------------------
# header: magic, base_seq, crc32(magic + base_seq)   [atomic via rename]
# record: u32 len | payload | u32 crc32(payload)
#   payload: u64 seq, u32 n_add, u32 n_ret, then (n_add + n_ret) little-
#   endian int64 (src, dst) pairs, adds first.
# fleet/replog.py frames its segments' records with _LEN and _REC.
_MAGIC = b"RDJ1"
_HDR = struct.Struct("<4sQI")
_LEN = struct.Struct("<I")
_REC = struct.Struct("<QII")


class DeltaJournal:
    """Append-only delta WAL (format above).  Not thread-safe on its
    own; DeltaManager serializes every call under its mutation lock."""

    def __init__(self, path: str):
        self.path = path
        self.base_seq = 0
        self.last_seq = 0
        self.records: list = []   # [(seq, add[n,2], ret[n,2])]
        self.torn_bytes = 0       # truncated on open (0 = clean)
        if os.path.exists(path):
            self._scan()
        else:
            self._write_header(0)
        self._f = open(path, "r+b")
        self._size = os.path.getsize(path)

    def _write_header(self, base_seq: int) -> None:
        tmp = self.path + ".tmp"
        hdr = _MAGIC + struct.pack("<Q", base_seq)
        hdr += _LEN.pack(zlib.crc32(hdr) & 0xFFFFFFFF)

        def _w():
            with open(tmp, "wb") as f:
                f.write(hdr)
        fault.retrying("delta.journal.create", _w)
        fault.fsync_replace(tmp, self.path)
        self.base_seq = self.last_seq = base_seq
        self.records = []

    def _scan(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        if len(data) < _HDR.size:
            raise DeltaJournalError(
                f"delta journal {self.path!r}: truncated header "
                f"({len(data)} bytes) — the header write is atomic, so "
                f"this is corruption, not a crash window")
        magic, base_seq, hcrc = _HDR.unpack(data[:_HDR.size])
        if magic != _MAGIC:
            raise DeltaJournalError(
                f"delta journal {self.path!r}: bad magic {magic!r}")
        if hcrc != zlib.crc32(data[:_HDR.size - 4]) & 0xFFFFFFFF:
            raise DeltaJournalError(
                f"delta journal {self.path!r}: header CRC mismatch "
                f"(bit rot)")
        self.base_seq = prev = base_seq
        off = good = _HDR.size
        n = len(data)
        while off < n:
            end = off + _LEN.size
            if end > n:
                break                                   # torn tail
            (rlen,) = _LEN.unpack(data[off:end])
            if end + rlen + _LEN.size > n:
                break                                   # torn tail
            rec = data[end:end + rlen]
            (rcrc,) = _LEN.unpack(data[end + rlen:end + rlen + _LEN.size])
            if zlib.crc32(rec) & 0xFFFFFFFF != rcrc:
                if end + rlen + _LEN.size == n:
                    break                               # torn final frame
                raise DeltaJournalError(
                    f"delta journal {self.path!r}: CRC mismatch at offset "
                    f"{off} with valid frames after it — bit rot, not a "
                    f"torn tail; the journal cannot be trusted")
            if rlen < _REC.size:
                raise DeltaJournalError(
                    f"delta journal {self.path!r}: undersized record at "
                    f"offset {off}")
            seq, na, nr = _REC.unpack(rec[:_REC.size])
            if rlen != _REC.size + (na + nr) * 16:
                raise DeltaJournalError(
                    f"delta journal {self.path!r}: record length disagrees "
                    f"with its edge counts at offset {off}")
            if seq != prev + 1:
                raise DeltaJournalError(
                    f"delta journal {self.path!r}: sequence gap "
                    f"({prev} -> {seq}) — records were lost")
            pay = np.frombuffer(rec, dtype="<i8", offset=_REC.size)
            add = pay[:2 * na].reshape(na, 2).astype(np.int64)
            ret = pay[2 * na:].reshape(nr, 2).astype(np.int64)
            self.records.append((seq, add, ret))
            prev = seq
            off = good = end + rlen + _LEN.size
        self.last_seq = prev
        if off < n or good < n:
            self.torn_bytes = n - good
            fault.emit_event("delta_journal_torn_tail", path=self.path,
                             dropped_bytes=int(self.torn_bytes))
            with open(self.path, "r+b") as f:
                f.truncate(good)
                os.fsync(f.fileno())

    def append(self, seq: int, add: np.ndarray, ret: np.ndarray) -> None:
        """Durably frame one batch before any in-memory patch.  The three
        kill sites cover: nothing written / written-not-fsynced / fsynced-
        not-applied; restart replay handles each."""
        add = np.ascontiguousarray(add, dtype="<i8").reshape(-1, 2)
        ret = np.ascontiguousarray(ret, dtype="<i8").reshape(-1, 2)
        rec = _REC.pack(seq, len(add), len(ret)) \
            + add.tobytes() + ret.tobytes()
        frame = _LEN.pack(len(rec)) + rec \
            + _LEN.pack(zlib.crc32(rec) & 0xFFFFFFFF)
        off = self._size

        def _w():
            fault.point("delta.journal.kill_record")
            self._f.seek(off)
            self._f.truncate(off)
            fault.point("delta.journal.append")
            self._f.write(frame)
            self._f.flush()
            fault.point("delta.journal.kill_fsync")
            fault.point("delta.journal.fsync")
            os.fsync(self._f.fileno())
        fault.retrying("delta.journal.append", _w)
        fault.point("delta.journal.kill_ack")
        self._size = off + len(frame)
        self.last_seq = seq
        self.records.append((seq, add.astype(np.int64),
                             ret.astype(np.int64)))

    def truncate_to(self, seq: int) -> None:
        """Fold replayed history into a snapshot: atomically replace the
        journal with an empty one whose base_seq is ``seq``."""
        self._f.close()
        self._write_header(seq)
        self._f = open(self.path, "r+b")
        self._size = os.path.getsize(self.path)

    def records_after(self, seq: int):
        """Resident records with sequence number > ``seq``, in order: the
        replication log's read API (fleet/replog.py seals them into
        segments).  Records folded into a snapshot are gone by design; a
        follower that needs them catches up from the snapshot."""
        return [(s, a, r) for s, a, r in self.records if s > seq]

    def close(self) -> None:
        self._f.close()


# -- the host store ---------------------------------------------------------

class _RowStore:
    """The live graph on the host: the base CSR of the last rebuild plus
    the rows touched since, each a list of its live sources in global
    order.  ``deg`` is the live in-degree of every row."""

    def __init__(self, row_ptr: np.ndarray, col_idx: np.ndarray,
                 rows: Optional[dict] = None):
        self.rp = np.ascontiguousarray(row_ptr, np.int64)
        self.col = np.ascontiguousarray(col_idx, np.int32)
        self.rows: dict = rows or {}
        self.deg = np.diff(self.rp)
        for d, lst in self.rows.items():
            self.deg[d] = len(lst)
        self.n_live = int(self.deg.sum())

    @property
    def num_nodes(self) -> int:
        return self.rp.size - 1

    def count(self, s: int, d: int) -> int:
        """Live instances of (s, d)."""
        lst = self.rows.get(d)
        if lst is not None:
            return lst.count(s)
        return int(np.count_nonzero(
            self.col[self.rp[d]:self.rp[d + 1]] == s))

    def _row(self, d: int) -> list:
        lst = self.rows.get(d)
        if lst is None:
            lst = self.rows[d] = self.col[self.rp[d]:self.rp[d + 1]].tolist()
        return lst

    def commit(self, adds, rets) -> np.ndarray:
        """Adds land before retires; a retire drops the last occurrence
        of its source in the row.  Returns the touched rows, ascending."""
        touched = set()
        for s, d in adds:
            self._row(d).append(s)
            touched.add(d)
        for s, d in rets:
            lst = self._row(d)
            del lst[len(lst) - 1 - lst[::-1].index(s)]
            touched.add(d)
        t = np.fromiter(sorted(touched), np.int64, len(touched))
        for d in t.tolist():
            self.deg[d] = len(self.rows[d])
        self.n_live += len(adds) - len(rets)
        return t

    def row_ptr(self) -> np.ndarray:
        rp = np.zeros(self.num_nodes + 1, np.int64)
        np.cumsum(self.deg, out=rp[1:])
        return rp

    def materialize(self):
        """(row_ptr int64, col_idx int32) of the live CSR."""
        pieces, prev = [], 0
        for d in sorted(self.rows):
            pieces.append(self.col[self.rp[prev]:self.rp[d]])
            # roclint: allow(host-sync) host row store over python lists, no device array
            pieces.append(np.asarray(self.rows[d], np.int32))
            prev = d + 1
        pieces.append(self.col[self.rp[prev]:])
        return self.row_ptr(), np.concatenate(pieces)

    def overrides(self):
        """The touched rows as (ids, row_ptr, sources) arrays."""
        # roclint: allow(host-sync) host row store over python lists, no device array
        ids = np.asarray(sorted(self.rows), np.int64)
        # roclint: allow(host-sync) host row store over python lists, no device array
        lens = np.asarray([len(self.rows[d]) for d in ids.tolist()],
                          np.int64)
        ptr = np.zeros(ids.size + 1, np.int64)
        np.cumsum(lens, out=ptr[1:])
        # roclint: allow(host-sync) host row store over python lists, no device array
        src = np.asarray([s for d in ids.tolist() for s in self.rows[d]],
                         np.int32)
        return ids, ptr, src


class _ReplanTicket:
    """Join handle for one background replan."""

    def __init__(self):
        self._done = threading.Event()
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


# -- the manager ------------------------------------------------------------

_COUNTER_KEYS = ("batches", "applied_adds", "applied_retires",
                 "noop_adds", "noop_retires", "rejected", "cells_patched",
                 "replans", "swaps", "checkpoints", "replayed")


def _check_model(model) -> None:
    """Refuse a model whose aggregations the row patch cannot serve:
    graph attention (as roc_tpu refuses it) and max/min aggregation."""
    if model is None:
        return
    if any(op.kind == "gat" for op in model.ops):
        raise DeltaError(
            "dynamic deltas do not support graph attention (roc_tpu "
            "refuses its plan-backend attention; the port refuses GAT "
            "alike)")
    extreme = sorted({op.attrs["aggr"] for op in model.ops
                      if op.kind == "aggregate"} & {"max", "min"})
    if extreme:
        raise DeltaError(
            f"dynamic deltas do not support {'/'.join(extreme)} "
            f"aggregation: roc_tpu patches only its sum plans and "
            f"in-degrees, so its extreme aggregations keep reading the "
            f"base edge list; the port refuses rather than serve that "
            f"stale graph")


class DeltaManager:
    """Owns delta state for one ServeEngine: journal, host store, device
    buffers, escalation, snapshot/restore, counters.

    ``get_gdata``/``set_gdata`` read and install the engine's resident
    DenseGraphData; installs happen under ``plan_lock``, the lock the
    serve worker holds for a whole window, so a query never sees a torn
    CSR.  ``headroom`` is the edges each buffer holds beyond the live
    edges (``HEADROOM_EDGES``); ``model``, when given, is checked by
    ``_check_model``."""

    def __init__(self, get_gdata, set_gdata, plan_lock, num_nodes: int,
                 journal_path: Optional[str] = None, watchdog=None,
                 ledger_key: Optional[str] = None, verbose: bool = False,
                 headroom: Optional[int] = None, model=None):
        self._get_gdata = get_gdata
        self._set_gdata = set_gdata
        self._plan_lock = plan_lock
        self.num_nodes = int(num_nodes)
        self.watchdog = watchdog
        self.verbose = verbose
        self.headroom = HEADROOM_EDGES if headroom is None else \
            int(headroom)
        self._ledger_key = ledger_key or content_key(
            model="delta", nodes=num_nodes)
        self._mu = _witness.trace("DeltaManager._mu", threading.Lock())
        self._ticket: Optional[_ReplanTicket] = None
        self._replan_thread: Optional[threading.Thread] = None
        self._broken: Optional[BaseException] = None
        self._closed = False
        self._replaying = False
        self._noop_warned = False
        self.counters = {k: 0 for k in _COUNTER_KEYS}
        # the last patch's seconds: classify_s, journal_s, commit_s,
        # rewrite_s, install_s (lock_wait_s, the wait for the window in
        # flight, is a part of it), beside rows and bytes_to_device
        self.last_patch: dict = {}

        gd = get_gdata()
        _check_model(model)
        self._check_supported(gd)
        self._backend, self._precision = gd.backend, gd.precision
        self.device = gd.csr.row_ptr.device
        self.journal = DeltaJournal(journal_path) if journal_path else None
        self._snap_path = (journal_path + ".snapshot.npz"
                           if journal_path else None)
        snap = None
        if self._snap_path and os.path.exists(self._snap_path):
            try:
                snap = _ckpt.load_arrays(self._snap_path)
            except _ckpt.CheckpointError as e:
                raise DeltaJournalError(
                    f"delta snapshot {self._snap_path!r} failed "
                    f"verification: {e}") from e
        if snap is not None:
            self._restore_from_snapshot(snap)
        else:
            # the frozen graph the engine placed: one host copy at enable
            # roclint: allow(host-sync) enable-time host copy of the resident CSR, once, off the request path
            rp = gd.csr.row_ptr.cpu().numpy()
            # roclint: allow(host-sync) enable-time host copy of the resident CSR, once, off the request path
            col = gd.csr.col_idx.cpu().numpy()
            self._store = _RowStore(rp, col)
            if not np.array_equal(self._store.deg.astype(np.float32),
                                  # roclint: allow(host-sync) enable-time host copy of the resident in-degrees, once, off the request path
                                  gd.in_degree.cpu().numpy()):
                raise DeltaError("the resident in-degrees disagree with "
                                 "the resident CSR; refusing the patch "
                                 "path")
            self._rebuilt = False
            self._seq = self.journal.base_seq if self.journal else 0
            self._install_fresh()

        if self.journal is not None:
            base = self.journal.base_seq
            if base > self._seq:
                raise DeltaJournalError(
                    f"delta journal base_seq {base} is ahead of the "
                    f"snapshot seq {self._seq} — records were lost")
            self._replaying = True
            try:
                for seq, add, ret in self.journal.records:
                    if seq <= self._seq:
                        continue
                    self.apply(add, ret, wait_replan=True)
                    self.counters["replayed"] += 1
            finally:
                self._replaying = False

    # -- setup helpers ------------------------------------------------------
    @staticmethod
    def _check_supported(gd) -> None:
        if gd is None or gd.backend != "kernel":
            raise DeltaError(
                "dynamic deltas require the kernel aggregation backend "
                "with a resident CSR (streamed and xla engines have no "
                "patchable rows)")
        if gd.csr.t_row_ptr is not None:
            raise DeltaError(
                "dynamic deltas patch the forward CSR only: the resident "
                "CSR was placed with its transpose, which no patch "
                "would keep current (serving places none)")

    def _alloc(self, capacity: int):
        """Two buffers of one capacity: [row_ptr, col_idx, in_degree]."""
        n, dev = self.num_nodes, self.device
        return [[torch.zeros(n + 1, dtype=torch.int64, device=dev),
                 torch.zeros(capacity, dtype=torch.int32, device=dev),
                 torch.zeros(n, dtype=torch.float32, device=dev)]
                for _ in range(2)]

    def _gdata_of(self, buf, n_edges: int):
        rp, col, deg = buf
        return DenseGraphData(csr=DeviceCsr(rp, col[:n_edges]),
                              in_degree=deg, backend=self._backend,
                              precision=self._precision)

    def _fill(self, rp: np.ndarray, col: np.ndarray, deg: np.ndarray):
        """New buffers holding the live CSR (capacity: live + headroom):
        the full build of enable, restore and replan."""
        bufs = self._alloc(int(col.size) + self.headroom)
        brp, bcol, bdeg = bufs[0]
        brp.copy_(torch.from_numpy(rp))
        bcol[:col.size].copy_(torch.from_numpy(col))
        bdeg.copy_(torch.from_numpy(deg.astype(np.float32)))
        if self.device.type == "cuda":
            # roclint: allow(host-sync) the fill's copies must land before the buffers are installed for the serve worker; enable or replan, off the request path
            torch.cuda.current_stream(self.device).synchronize()
        note_csr_build()
        return bufs

    def _install_fresh(self) -> None:
        """Materialize the host store into new buffers and install them."""
        rp, col = self._store.materialize()
        bufs = self._fill(rp, col, self._store.deg)
        with self._plan_lock:
            self._set_gdata(self._gdata_of(bufs[0], col.size))
        self._adopt(bufs, rp)

    def _adopt(self, bufs, rp) -> None:
        self._bufs, self._active, self._dev_rp = bufs, 0, rp
        self.capacity = int(bufs[0][1].numel())

    def _restore_from_snapshot(self, snap) -> None:
        arrays, extra = snap
        if extra.get("kind") != "delta-snapshot":
            raise DeltaJournalError(
                f"{self._snap_path!r} is not a delta snapshot")
        if "base_col_idx" in arrays:          # the port's own layout
            ids = arrays["row_ids"].astype(np.int64).tolist()
            ptr = arrays["row_ptr"].astype(np.int64)
            src = arrays["row_src"].astype(np.int64)
            rows = {d: src[ptr[i]:ptr[i + 1]].tolist()
                    for i, d in enumerate(ids)}
            self._store = _RowStore(arrays["base_row_ptr"],
                                    arrays["base_col_idx"], rows)
        else:                                 # roc_tpu's: its live edges
            base = from_edges(self.num_nodes, arrays["live_src"],
                              arrays["live_dst"])
            self._store = _RowStore(base.row_ptr, base.col_idx)
        if not np.array_equal(self._store.deg,
                              arrays["in_degree"].astype(np.int64)):
            raise DeltaJournalError(
                "snapshot in-degrees disagree with its live edges")
        self._rebuilt = bool(extra["rebuilt"])
        self._seq = int(extra["seq"])
        for k, v in extra.get("counters", {}).items():
            if k in self.counters:
                self.counters[k] = int(v)
        self._install_fresh()

    # -- the one write path -------------------------------------------------
    def apply(self, add_edges=None, retire_edges=None,
              wait_replan: bool = False) -> dict:
        """Apply one delta batch.  Contract: validate-or-reject (nothing
        journaled on reject), journal before memory, rewrite the touched
        rows into the idle buffer and swap it in (no CSR rebuild, no
        allocation, no kernel build), escalate to a background replan when
        the live edges outgrow the capacity.  Returns a result dict (seq,
        mode, per-op counts, rows patched, the replan ticket when
        escalated).  The whole call is the ``delta_batch`` span."""
        with obs.span("delta_batch") as sp:
            result = self._apply_batch(add_edges, retire_edges, wait_replan)
            sp.args.update(adds=result["applied_adds"],
                           retires=result["applied_retires"],
                           mode=result["mode"])
        return result

    def _apply_batch(self, add_edges, retire_edges,
                     wait_replan: bool) -> dict:
        with self._mu:
            if self._closed:
                raise DeltaError("delta manager is closed")
            if self._broken is not None:
                raise DeltaError(
                    "delta manager is in a crashed state (a previous "
                    "apply or replan died mid-flight); restart and "
                    "replay the journal") from self._broken
            if self._ticket is not None and not self._ticket.done:
                # a replan is in flight: the old buffers serve queries,
                # but mutations serialize behind the swap
                # roclint: allow(lock-blocking) mutations MUST serialize behind the in-flight replan under _mu; queries never take _mu, so serving stays live
                self._ticket.wait()
            if self._ticket is not None:
                if self._ticket.error is not None:
                    raise DeltaError(
                        "background replan failed; restart and replay "
                        "the journal") from self._ticket.error
                self._ticket = None
            with obs.span("delta_classify") as sp_host:
                add = self._validate(add_edges, "add_edges")
                ret = self._validate(retire_edges, "retire_edges")
                # roclint: allow(lock-blocking) pre-WAL chaos site: a kill here unwinds through `with _mu` releasing it, and the journal has not advanced, so restart replays cleanly
                fault.point("delta.apply")   # transient chaos: pre-WAL
                eff_add, eff_ret, noop_add, noop_ret = self._classify(add,
                                                                      ret)
            self.counters["noop_adds"] += noop_add
            self.counters["noop_retires"] += noop_ret
            if (noop_add or noop_ret) and not self._noop_warned \
                    and not self._replaying:
                self._noop_warned = True
                warnings.warn(
                    "delta batch contained idempotent no-ops (re-adding "
                    "a live edge / retiring a dead one); counted in "
                    "delta counters, not an error (warning once)",
                    RuntimeWarning, stacklevel=4)
            if not eff_add and not eff_ret:
                self.counters["batches"] += 1
                return {"seq": self._seq, "mode": "noop",
                        "applied_adds": 0, "applied_retires": 0,
                        "noop_adds": noop_add, "noop_retires": noop_ret,
                        "cells_patched": 0}
            seq = self._seq + 1
            with obs.span("delta_journal") as sp_journal:
                if self.journal is not None and not self._replaying:
                    # roclint: allow(lock-blocking) WAL-before-memory IS the commit point: the fsync'd append must complete under _mu or a racing apply could journal seq+1 before seq is durable
                    self.journal.append(seq, add, ret)
            try:
                with obs.span("delta_apply", adds=len(eff_add),
                              retires=len(eff_ret)) as sp:
                    # roclint: allow(lock-blocking) the in-memory commit matching the WAL record above; it reaches kill windows and checkpoint fsync by design, and a crash inside poisons the manager for replay
                    result = self._apply_effective(seq, eff_add, eff_ret)
            except BaseException as e:
                # past the WAL: memory is behind the journal; poison the
                # manager, restart replays exactly
                self._broken = e
                raise
            self.counters["batches"] += 1
            self.counters["applied_adds"] += len(eff_add)
            self.counters["applied_retires"] += len(eff_ret)
            result.update(noop_adds=noop_add, noop_retires=noop_ret,
                          applied_adds=len(eff_add),
                          applied_retires=len(eff_ret))
            self.last_patch.update(classify_s=sp_host.dur_s,
                                   journal_s=sp_journal.dur_s)
            if not self._replaying:
                self._note_obs(sp.dur_s, result)
            ticket = result.get("ticket")
        if ticket is not None and wait_replan:
            ticket.wait()
            if ticket.error is not None:
                raise DeltaError("replan failed") from ticket.error
        return result

    def _validate(self, edges, what: str) -> np.ndarray:
        if edges is None:
            return np.zeros((0, 2), np.int64)
        try:
            # roclint: allow(host-sync) caller batch ingress, host data
            arr = np.asarray(edges)
            if arr.size == 0:
                return np.zeros((0, 2), np.int64)
            if not np.issubdtype(arr.dtype, np.integer):
                raise ValueError(f"dtype {arr.dtype} is not integral")
            arr = arr.reshape(-1, 2).astype(np.int64)
        except (ValueError, TypeError) as e:
            self.counters["rejected"] += 1
            raise DeltaError(
                f"{what} must be an [n, 2] integer array of (src, dst) "
                f"node ids: {e}") from e
        if arr.size and (arr.min() < 0 or arr.max() >= self.num_nodes):
            self.counters["rejected"] += 1
            raise DeltaError(
                f"{what} node ids out of range [0, {self.num_nodes}): "
                f"min={arr.min()}, max={arr.max()} (batch rejected, "
                f"journal untouched)")
        return arr

    def _classify(self, add: np.ndarray, ret: np.ndarray):
        """Split a validated batch into effective ops and idempotent
        no-ops, honoring within-batch ordering (adds land before
        retires, duplicates collapse)."""
        eff_add, eff_ret = [], []
        noop_add = noop_ret = 0
        pend: dict = {}   # (s, d) -> net live delta within this batch
        live: dict = {}   # (s, d) -> live instances before this batch
        count = self._store.count

        def before(sd):
            n = live.get(sd)
            if n is None:
                n = live[sd] = count(*sd)
            return n
        for sd in map(tuple, add.tolist()):
            if before(sd) + pend.get(sd, 0) > 0:
                noop_add += 1
            else:
                eff_add.append(sd)
                pend[sd] = pend.get(sd, 0) + 1
        for sd in map(tuple, ret.tolist()):
            if before(sd) + pend.get(sd, 0) <= 0:
                noop_ret += 1
            else:
                eff_ret.append(sd)
                pend[sd] = pend.get(sd, 0) - 1
        return eff_add, eff_ret, noop_add, noop_ret

    def _apply_effective(self, seq: int, eff_add, eff_ret) -> dict:
        with obs.span("delta_commit") as sp_commit:
            touched = self._store.commit(eff_add, eff_ret)
        self._seq = seq
        if self._store.n_live > self.capacity:
            # the batch is journaled and committed to the host store; it
            # reaches the device with the replan's buffers
            ticket = self._escalate()
            return {"seq": seq, "mode": "replanning", "cells_patched": 0,
                    "ticket": ticket}
        self._patch(touched)
        self.last_patch["commit_s"] = sp_commit.dur_s
        self.counters["cells_patched"] += int(touched.size)
        return {"seq": seq, "mode": "applied",
                "cells_patched": int(touched.size)}

    def _patch(self, touched: np.ndarray) -> None:
        """Write the live CSR into the idle buffer, then swap it in."""
        store = self._store
        old_rp, new_rp = self._dev_rp, store.row_ptr()
        src_rp, src_col, src_deg = self._bufs[self._active]
        idle = 1 - self._active
        dst_rp, dst_col, dst_deg = self._bufs[idle]
        with obs.span("delta_rewrite") as sp:
            vals = [store.rows[d] for d in touched.tolist()]
            host = np.fromiter((s for v in vals for s in v), np.int32,
                               int(sum(map(len, vals))))
            t_dev = torch.from_numpy(host).to(self.device)
            pieces, prev, off = [], 0, 0
            for d, v in zip(touched.tolist(), vals):
                a, b = int(old_rp[prev]), int(old_rp[d])
                if b > a:
                    pieces.append(src_col[a:b])
                if v:
                    pieces.append(t_dev[off:off + len(v)])
                off += len(v)
                prev = d + 1
            a, b = int(old_rp[prev]), int(old_rp[-1])
            if b > a:
                pieces.append(src_col[a:b])
            n_edges = int(new_rp[-1])
            if pieces:
                torch.cat(pieces, out=dst_col[:n_edges])
            idx = torch.from_numpy(touched).to(self.device)
            deg = torch.from_numpy(
                store.deg[touched].astype(np.float32)).to(self.device)
            dst_deg.copy_(src_deg)
            dst_deg[idx] = deg
            dst_rp.copy_(torch.from_numpy(new_rp))
        with obs.span("delta_install") as sp_install:
            # the wait for the window in flight, a part of the install: its
            # span closes once the lock is taken, or as taking it raises
            with contextlib.ExitStack() as waiting:
                lock_wait = waiting.enter_context(obs.span("delta_lock_wait"))
                with self._plan_lock:
                    waiting.close()
                    self._set_gdata(self._gdata_of(self._bufs[idle],
                                                   n_edges))
            self._active, self._dev_rp = idle, new_rp
        self.last_patch = {
            "rows": int(touched.size), "rewrite_s": sp.dur_s,
            "install_s": sp_install.dur_s, "lock_wait_s": lock_wait.dur_s,
            "bytes_to_device": int(new_rp.nbytes + host.nbytes
                                   + 8 * touched.size + 4 * touched.size)}

    def _live_edges(self):
        """(src, dst) int64 of the live edges, in CSR order."""
        rp, col = self._store.materialize()
        dst = np.repeat(np.arange(self.num_nodes, dtype=np.int64),
                        np.diff(rp))
        return col.astype(np.int64), dst

    # -- escalation ladder --------------------------------------------------
    def _escalate(self) -> _ReplanTicket:
        self.counters["replans"] += 1
        ticket = _ReplanTicket()
        self._ticket = ticket
        if self._replaying:
            self._replan_worker(ticket)
            if ticket.error is not None:
                raise DeltaError("replay replan failed") from ticket.error
        else:
            t = threading.Thread(target=self._replan_worker,
                                 args=(ticket,), daemon=True,
                                 name="roc-delta-replan")
            self._replan_thread = t
            t.start()
        return ticket

    def _replan_worker(self, ticket: _ReplanTicket) -> None:
        """Rebuild on the mutated graph, off the serve path: the old
        buffers answer queries until the swap, which happens under the
        plan lock at a window boundary.  Swap and checkpoint are one
        crash-consistent unit."""
        try:
            fault.point("delta.replan.slow")
            rp, col = self._store.materialize()
            bufs = self._fill(rp, col, self._store.deg)
            with self._plan_lock:
                # roclint: allow(lock-blocking) the swap kill windows sit INSIDE the plan lock on purpose: the crash-consistency drill proves a kill at either edge of the atomic swap unwinds (releasing the lock) with the old or the new buffers whole
                fault.point("delta.swap.kill_pre")
                self._set_gdata(self._gdata_of(bufs[0], col.size))
                # roclint: allow(lock-blocking) see kill_pre above: same sanctioned kill window, post-swap edge
                fault.point("delta.swap.kill_post")
            self._adopt(bufs, rp)
            self._store = _RowStore(rp, col)
            self._rebuilt = True
            self.counters["swaps"] += 1
            if not self._replaying:
                self.checkpoint()
        except BaseException as e:           # incl. SimulatedCrash
            ticket.error = e
            self._broken = e
        finally:
            ticket._done.set()

    # -- snapshot + truncate (one crash-consistent unit) --------------------
    def checkpoint(self) -> None:
        """Fold the journal into a verified snapshot: durable snapshot
        write (train.checkpoint.save_arrays), then journal truncate.  A
        kill between the two leaves snapshot(seq=S) + the full journal;
        restart skips replay of records <= S."""
        if self.journal is None:
            return
        st = self._store
        ids, ptr, src = st.overrides()
        arrays = dict(base_row_ptr=st.rp, base_col_idx=st.col,
                      row_ids=ids, row_ptr=ptr, row_src=src,
                      in_degree=st.deg.astype(np.int64))
        extra = dict(kind="delta-snapshot", seq=int(self._seq),
                     rebuilt=bool(self._rebuilt), layout="csr-rows",
                     counters={k: int(v) for k, v in self.counters.items()})
        _ckpt.save_arrays(self._snap_path, arrays, extra, site="delta.ckpt")
        fault.point("delta.ckpt.kill_snap")
        self.journal.truncate_to(self._seq)
        self.counters["checkpoints"] += 1

    # -- observability ------------------------------------------------------
    def _note_obs(self, dur_s: float, result: dict) -> None:
        led = get_ledger()
        # the patch's cost model: a fixed host overhead per batch and per
        # row rewritten, the bytes to the device over the host link, and
        # the buffer's read and write over HBM
        rows = int(result.get("cells_patched", 0))
        nbytes = self.last_patch.get("bytes_to_device", 0) if rows else 0
        led.predict("delta-apply", self._ledger_key,
                    2e-4 + 2e-5 * rows + nbytes / STREAM_BW_BYTES_S
                    + 8.0 * self._store.n_live / roofline.PEAK_BW, "s")
        led.measure("delta-apply", self._ledger_key, dur_s, "s")
        if self.watchdog is not None:
            alert = self.watchdog.observe_delta(self.counters["batches"],
                                                dur_s)
            if alert is not None and self.verbose:
                print(f"# watchdog: delta apply {alert['apply_s']*1e3:.2f} "
                      f"ms is {alert['ratio']:.2f}x its EWMA")

    @property
    def applied_seq(self) -> int:
        """Watermark: the highest delta sequence number whose effects are
        visible to queries (the fleet router's freshness floor)."""
        return self._seq

    @property
    def snapshot_path(self) -> Optional[str]:
        """Where ``checkpoint()`` writes the snapshot (None when running
        volatile); the fleet's snapshot protocol ships this file and the
        truncated journal to a catching-up replica."""
        return self._snap_path

    def buffer_ptrs(self) -> list:
        """The two col_idx buffers' device addresses, active first."""
        return [int(self._bufs[i][1].data_ptr())
                for i in (self._active, 1 - self._active)]

    def stats(self) -> dict:
        out = dict(self.counters)
        out["seq"] = self._seq
        out["rebuilt"] = self._rebuilt
        out["live_edges"] = int(self._store.n_live)
        out["journal"] = self.journal.path if self.journal else None
        return out

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Finish-or-journal: wait out any in-flight apply (the mutation
        lock), join the background replan, close the journal.  Called by
        ServeEngine.close() before the queue drains."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            if self._ticket is not None and not self._ticket.done:
                # roclint: allow(lock-blocking) close() is finish-or-journal: holding _mu while the last replan drains keeps a racing apply() from slipping a mutation into a closing manager
                self._ticket.wait()
            if self._replan_thread is not None:
                # roclint: allow(lock-blocking) same close() barrier: the replan worker never takes _mu, so joining it under _mu cannot deadlock, and it must be dead before the journal closes
                self._replan_thread.join(timeout=60.0)
                self._replan_thread = None
            if self.journal is not None:
                self.journal.close()
