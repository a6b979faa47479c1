"""Replication log (roc_tpu/fleet/replog.py): the delta WAL, shipped.

A single primary ServeEngine owns the write path (validation, WAL,
patch); follower replicas never journal primary-originated mutations of
their own accord — they replay what the primary ships.  The shipping
unit is a *segment*: the CRC-framed journal records since the follower's
last acknowledged sequence number, sealed under one header and published
through a Transport.  The framing is byte-compatible with the journal's
record frames on purpose — the seq-gap / torn-tail / bit-rot taxonomy
from `serve/delta.py` applies verbatim:

  header: magic ``RSG1`` | u64 first_seq | u64 last_seq | u32 n_records
          | f64 sealed_at (unix wall; replication-lag measurement)
          | u32 crc32(header so far)
  body:   n_records journal frames, verbatim
          (u32 len | payload | u32 crc32(payload))

Decode classifies exactly like journal open: a segment shorter than its
framing is a *torn segment* (the crash window a retried transport
re-ships), a CRC mismatch is *bit rot*, first_seq != follower_seq + 1 is
a *sequence gap* — each a typed :class:`ReplicationError` subclass so
the router can tell "re-ship it" from "this follower needs a snapshot".

The snapshot protocol is the delta manager's checkpoint-then-truncate
cycle worn sideways: the primary's `DeltaManager.checkpoint()` already
folds the journal into a verified snapshot + a truncated journal; a
crashed or new replica catches up by installing copies of those two
files and letting its own DeltaManager restore + replay — then applies
the tail segments sealed after the snapshot.  Nothing new to trust: the
same CRC'd writer, the same restore path, the same replay machinery.

Transports (one interface, three wires):

  InProcTransport   deque + condition variable — replicas in one process
                    (the selftest / CI fleet)
  FileTransport     numbered segment files in a spool directory, written
                    via fault.fsync_replace — survives process restarts,
                    which is what the kill-window tests replay through
  SocketTransport   length-prefixed TCP on localhost — the cross-process
                    shape (listen() one end, connect() the other)

Chaos sites: ``fleet.ship`` (transient publish fault inside the retried
send), ``fleet.ship.kill_pre`` / ``fleet.ship.kill_post`` (kill -9
either side of the publish — the before/after-segment-fsync windows of
the acceptance matrix).
"""

from __future__ import annotations

import functools
import os
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from roc_tpu_torch import fault
from roc_tpu_torch.serve.delta import _LEN, _REC

__all__ = ["ReplicationError", "TornSegmentError", "SegmentGapError",
           "SegmentRotError", "Transport", "InProcTransport",
           "FileTransport", "SocketTransport", "encode_segment",
           "decode_segment", "replay_segment", "install_snapshot_files",
           "ReplicationLog"]

_SEG_MAGIC = b"RSG1"
_SEG_HDR = struct.Struct("<4sQQIdI")     # magic, first, last, n, sealed, crc


class ReplicationError(RuntimeError):
    """A shipped segment that cannot be applied as-is."""


class TornSegmentError(ReplicationError):
    """Truncated mid-frame: a crash/partial write the transport retry
    re-ships.  Never applied partially — decode is all-or-nothing."""


class SegmentRotError(ReplicationError):
    """CRC mismatch inside a complete segment: bit rot, never trusted."""


class SegmentGapError(ReplicationError):
    """first_seq is ahead of the follower's watermark + 1: records were
    missed (e.g. the follower was dead across a checkpoint/truncate).
    The correct reaction is snapshot catch-up, not replay."""


def encode_segment(records: List[Tuple[int, np.ndarray, np.ndarray]],
                   sealed_at: Optional[float] = None) -> bytes:
    """Seal journal records (dense-monotone seq order) into one segment."""
    assert records, "cannot seal an empty segment"
    first, last = records[0][0], records[-1][0]
    assert last - first + 1 == len(records), "records not dense in seq"
    body = bytearray()
    for seq, add, ret in records:
        add = np.ascontiguousarray(add, dtype="<i8").reshape(-1, 2)
        ret = np.ascontiguousarray(ret, dtype="<i8").reshape(-1, 2)
        rec = _REC.pack(seq, len(add), len(ret)) \
            + add.tobytes() + ret.tobytes()
        body += _LEN.pack(len(rec)) + rec \
            + _LEN.pack(zlib.crc32(rec) & 0xFFFFFFFF)
    if sealed_at is None:
        # wall clock, not perf_counter: the seal stamp crosses process
        # boundaries on the file/socket transports
        sealed_at = time.time()
    hdr = _SEG_MAGIC + struct.pack("<QQId", first, last, len(records),
                                   float(sealed_at))
    hdr += _LEN.pack(zlib.crc32(hdr) & 0xFFFFFFFF)
    return hdr + bytes(body)


def decode_segment(data: bytes):
    """(records, sealed_at) or a typed ReplicationError — all-or-nothing,
    same taxonomy as journal open (see module docstring)."""
    if len(data) < _SEG_HDR.size:
        raise TornSegmentError(
            f"segment truncated inside its header ({len(data)} bytes)")
    magic, first, last, n, sealed_at, crc = _SEG_HDR.unpack(
        data[:_SEG_HDR.size])
    if magic != _SEG_MAGIC:
        raise SegmentRotError(f"bad segment magic {magic!r}")
    if crc != zlib.crc32(data[:_SEG_HDR.size - 4]) & 0xFFFFFFFF:
        raise SegmentRotError("segment header CRC mismatch (bit rot)")
    if last - first + 1 != n:
        raise SegmentRotError(
            f"segment header seq range [{first}, {last}] disagrees with "
            f"its record count {n}")
    records, off, prev = [], _SEG_HDR.size, first - 1
    for _ in range(n):
        if off + _LEN.size > len(data):
            raise TornSegmentError(f"segment torn at offset {off}")
        (rlen,) = _LEN.unpack(data[off:off + _LEN.size])
        end = off + _LEN.size + rlen + _LEN.size
        if end > len(data):
            raise TornSegmentError(f"segment torn at offset {off}")
        rec = data[off + _LEN.size:end - _LEN.size]
        (rcrc,) = _LEN.unpack(data[end - _LEN.size:end])
        if zlib.crc32(rec) & 0xFFFFFFFF != rcrc:
            raise SegmentRotError(
                f"segment record CRC mismatch at offset {off} (bit rot)")
        if rlen < _REC.size:
            raise SegmentRotError(f"undersized segment record at {off}")
        seq, na, nr = _REC.unpack(rec[:_REC.size])
        if rlen != _REC.size + (na + nr) * 16:
            raise SegmentRotError(
                f"segment record length disagrees with its edge counts "
                f"at offset {off}")
        if seq != prev + 1:
            raise SegmentGapError(
                f"segment seq gap ({prev} -> {seq}) inside one segment")
        pay = np.frombuffer(rec, dtype="<i8", offset=_REC.size)
        records.append((seq, pay[:2 * na].reshape(na, 2).astype(np.int64),
                        pay[2 * na:].reshape(nr, 2).astype(np.int64)))
        prev = seq
        off = end
    if off != len(data):
        raise SegmentRotError(
            f"{len(data) - off} trailing bytes after the last framed "
            f"record — not a torn tail; the segment cannot be trusted")
    return records, float(sealed_at)


def replay_segment(seg: bytes, applied_seq: int, apply_fn):
    """Exactly-once replay of one shipped segment through
    ``apply_fn(seq, add, ret)`` — the follower half of the protocol,
    shared by :class:`roc_tpu_torch.fleet.replica.Replica` and driven directly
    by the kill-window tests.

    Records at or below ``applied_seq`` are skipped (at-least-once
    transports re-ship; the watermark makes the apply exactly-once); a
    first needed record past ``applied_seq + 1`` raises
    :class:`SegmentGapError` (records were missed — snapshot catch-up,
    never blind replay).  The ``fleet.replay.kill_mid`` chaos site sits
    BETWEEN records: a follower dying mid-segment leaves a journaled
    prefix its own restart replays, and the re-shipped segment's
    already-applied records dedup through the advanced watermark.

    Returns ``(applied, skipped, sealed_at)``.
    """
    records, sealed_at = decode_segment(seg)
    todo = [(s, a, r) for s, a, r in records if s > applied_seq]
    skipped = len(records) - len(todo)
    if todo and todo[0][0] != applied_seq + 1:
        raise SegmentGapError(
            f"follower at seq {applied_seq} received a segment whose "
            f"first needed record is {todo[0][0]}; records were missed "
            f"— snapshot catch-up required")
    applied = 0
    for seq, add, ret in todo:
        apply_fn(seq, add, ret)
        applied += 1
        fault.point("fleet.replay.kill_mid")
    return applied, skipped, sealed_at


def install_snapshot_files(snap: bytes, journal: bytes,
                           snapshot_path: str, journal_path: str) -> None:
    """Write a primary's (snapshot, truncated journal) pair over a
    follower's local files — each side fsync-renamed, but the PAIR is
    not one atomic unit: ``fleet.snap.kill_install`` sits in the window
    between them.  Recovery is re-running the install from the top; it
    is idempotent, and the half-installed state (new snapshot + old
    journal) is never trusted because catch-up always restarts the
    engine only after BOTH writes land."""
    for path, data, first in ((snapshot_path, snap, True),
                              (journal_path, journal, False)):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        fault.fsync_replace(tmp, path)
        if first:
            fault.point("fleet.snap.kill_install")


# -- transports -------------------------------------------------------------

class Transport:
    """One unicast primary->follower wire.  ``send`` on the primary end,
    ``recv`` on the follower end; segments arrive whole and in order or
    not at all (each implementation frames/fsyncs accordingly)."""

    def send(self, seg: bytes) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcTransport(Transport):
    """Same-process fleet: a bounded deque + condition variable."""

    def __init__(self, maxlen: int = 4096):
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._maxlen = int(maxlen)

    def send(self, seg: bytes) -> None:
        with self._cv:
            if len(self._q) >= self._maxlen:
                raise ReplicationError(
                    f"in-proc transport backlog at {self._maxlen} "
                    f"segments; follower is not draining")
            self._q.append(bytes(seg))
            self._cv.notify_all()

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        # Predicate loop against a deadline: a notify stolen by a sibling
        # follower (or a spurious wakeup) must not eat the whole timeout
        # budget in one swallow — re-wait for whatever remains.
        deadline = (time.perf_counter() + timeout) if timeout else None
        with self._cv:
            while not self._q and deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            return self._q.popleft() if self._q else None

    def depth(self) -> int:
        with self._cv:
            return len(self._q)


class FileTransport(Transport):
    """Spool-directory fleet: ``seg-%010d.bin`` files, fsync-renamed so a
    reader never sees a torn segment *file* (torn *contents* from a
    simulated mid-write crash still decode to TornSegmentError — the
    kill-window tests write those deliberately)."""

    def __init__(self, spool_dir: str):
        self.dir = spool_dir
        os.makedirs(spool_dir, exist_ok=True)
        self._wcursor = self._scan_max() + 1
        self._rcursor = 0

    def _scan_max(self) -> int:
        mx = -1
        for name in os.listdir(self.dir):
            if name.startswith("seg-") and name.endswith(".bin"):
                try:
                    mx = max(mx, int(name[4:-4]))
                except ValueError:
                    pass
        return mx

    def _path(self, i: int) -> str:
        return os.path.join(self.dir, f"seg-{i:010d}.bin")

    def send(self, seg: bytes) -> None:
        path = self._path(self._wcursor)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(seg)
        fault.fsync_replace(tmp, path)
        self._wcursor += 1

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        deadline = time.time() + (timeout or 0.0)
        while True:
            path = self._path(self._rcursor)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    data = f.read()
                self._rcursor += 1
                return data
            if time.time() >= deadline:
                return None
            time.sleep(0.002)


class SocketTransport(Transport):
    """Cross-process fleet: length-prefixed segments over localhost TCP.
    ``SocketTransport.listen()`` binds the follower end on an ephemeral
    port; ``SocketTransport.connect(port)`` is the primary end."""

    def __init__(self, sock: socket.socket, accept: bool):
        self._lsock = sock if accept else None
        self._sock = None if accept else sock
        self._buf = b""

    @classmethod
    def listen(cls) -> "SocketTransport":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        return cls(s, accept=True)

    @classmethod
    def connect(cls, port: int, timeout: float = 5.0) -> "SocketTransport":
        s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        return cls(s, accept=False)

    @property
    def port(self) -> int:
        return (self._lsock or self._sock).getsockname()[1]

    def _ensure(self, timeout: Optional[float]) -> bool:
        if self._sock is None:
            self._lsock.settimeout(timeout or 5.0)
            try:
                self._sock, _ = self._lsock.accept()
            except socket.timeout:
                return False
        return True

    def send(self, seg: bytes) -> None:
        self._sock.sendall(_LEN.pack(len(seg)) + seg)

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        if not self._ensure(timeout):
            return None
        self._sock.settimeout(timeout or 5.0)
        try:
            while len(self._buf) < _LEN.size:
                chunk = self._sock.recv(65536)
                if not chunk:
                    return None
                self._buf += chunk
            (n,) = _LEN.unpack(self._buf[:_LEN.size])
            while len(self._buf) < _LEN.size + n:
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise TornSegmentError(
                        "peer closed mid-segment (torn on the wire)")
                self._buf += chunk
        except socket.timeout:
            return None
        seg = self._buf[_LEN.size:_LEN.size + n]
        self._buf = self._buf[_LEN.size + n:]
        return seg

    def close(self) -> None:
        for s in (self._sock, self._lsock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


# -- the primary's shipping side --------------------------------------------

def _publish(tr: Transport, seg: bytes) -> None:
    """One retried publish attempt: the ``fleet.ship`` transient site
    fires per ATTEMPT (an InjectedFault is an OSError, so the retry
    budget absorbs it like a real flaky wire), then the bytes go out."""
    fault.point("fleet.ship")
    tr.send(seg)

class ReplicationLog:
    """Seals the primary engine's journal tail into segments and ships
    one copy down every registered transport.

    The primary's DeltaManager remains the single source of truth: this
    class only READS (`journal.records_after`) and never mutates delta
    state.  `ship()` is idempotent per watermark — it seals everything
    past `shipped_seq` (nothing to seal -> no segment) and advances the
    watermark only after every transport took the bytes, so a transient
    publish fault (``fleet.ship``, retried) or a kill either side of the
    publish (``fleet.ship.kill_pre/_post``) at worst re-ships records a
    follower's own watermark already filters — at-least-once delivery on
    an exactly-once apply.
    """

    def __init__(self, engine, verbose: bool = False):
        if engine.deltas is None or engine.deltas.journal is None:
            raise ReplicationError(
                "the replication primary needs a journaled delta engine "
                "(delta_journal=<path>): the WAL is the replication log")
        self.engine = engine
        self.verbose = verbose
        self.transports: List[Transport] = []
        self.shipped_seq = engine.delta_seq()
        self.segments_shipped = 0
        self.records_shipped = 0

    def attach(self, transport: Transport) -> Transport:
        """Register one follower wire.  A transport attached mid-stream
        only sees segments sealed after attach — catch a late follower
        up through the snapshot protocol first (Replica.catch_up)."""
        self.transports.append(transport)
        return transport

    def detach(self, transport: Transport) -> None:
        if transport in self.transports:
            self.transports.remove(transport)

    def ship(self) -> Optional[bytes]:
        """Seal + publish the journal tail past the shipped watermark.
        Returns the sealed segment bytes (tests and the snapshot drill
        inspect them) or None when there is nothing new."""
        mgr = self.engine.deltas
        with mgr._mu:
            records = mgr.journal.records_after(self.shipped_seq)
        if not records:
            return None
        seg = encode_segment(records)
        fault.point("fleet.ship.kill_pre")
        for tr in self.transports:
            fault.retrying("fleet.ship", functools.partial(_publish, tr, seg))
        fault.point("fleet.ship.kill_post")
        self.shipped_seq = records[-1][0]
        self.segments_shipped += 1
        self.records_shipped += len(records)
        return seg

    def snapshot_blob(self) -> Tuple[bytes, bytes, int]:
        """(snapshot_bytes, journal_bytes, seq) for replica catch-up:
        fold the journal into a fresh snapshot (checkpoint = snapshot +
        truncate, the delta manager's crash-consistent unit), then read
        both files.
        The returned seq is the snapshot's watermark — tail segments the
        follower needs are exactly those sealed with first_seq > seq."""
        mgr = self.engine.deltas
        with mgr._mu:
            mgr.checkpoint()
            seq = mgr.applied_seq
        with open(mgr.snapshot_path, "rb") as f:
            snap = f.read()
        with open(mgr.journal.path, "rb") as f:
            jour = f.read()
        return snap, jour, seq

    def stats(self) -> dict:
        return {"shipped_seq": int(self.shipped_seq),
                "segments_shipped": int(self.segments_shipped),
                "records_shipped": int(self.records_shipped),
                "transports": len(self.transports)}
