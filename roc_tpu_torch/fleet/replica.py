"""One fleet member (roc_tpu/fleet/replica.py): a ServeEngine wearing a
replication watermark.

A replica is the existing serving stack, unchanged: a cold start (its
CSR placements, ``cold_start_stats["csr_builds"]``), the microbatch queue,
and a delta manager journaling to a **local** WAL.  What this wrapper adds
is the fleet contract:

* ``applied_seq`` — the highest delta sequence visible to queries here
  (``engine.delta_seq()``); the router reads it for its freshness floor.
* ``load`` — pending undrained requests (``engine.pending()``); the
  router's least-loaded dispatch signal.
* ``apply_segment`` — replay one shipped segment through the same
  classify/patch path the primary ran.  Exactly-once: records at or
  below the watermark are skipped (so at-least-once transports are
  safe), a first-needed-seq ahead of watermark + 1 is a typed
  :class:`SegmentGapError` (the router reacts with snapshot catch-up,
  never blind replay).  Classification is deterministic and noops are
  never journaled, so journaled records are exactly the effective
  batches — a follower replaying them stays in bitwise seq-lockstep
  with the primary.
* ``install_snapshot`` / ``restart`` — the catch-up and crash halves.
  Install writes the primary's snapshot + truncated journal over the
  replica's local pair (``fleet.snap.kill_install`` between the two
  fsync-renames is the non-atomic window; recovery is simply re-running
  catch-up, the install is idempotent) and restarts the engine, whose
  DeltaManager already knows how to restore snapshot + replay tail.
  ``restart`` alone is the simulated replica death: tear the engine
  down, rebuild from the local journal pair.

Each replica also journals replayed records into its own WAL — that is
what makes a *replica* crash-consistent on its own: its restart path is
the primary's restart path.
"""

from __future__ import annotations

import time
from typing import Optional

from roc_tpu_torch import fault
from roc_tpu_torch.fleet.replog import (SegmentGapError, Transport,
                                        install_snapshot_files,
                                        replay_segment)

__all__ = ["Replica"]


class Replica:
    """ServeEngine + watermark + catch-up; see module docstring."""

    def __init__(self, name: str, config, dataset, model,
                 checkpoint_path: Optional[str], journal_path: str,
                 watchdog=None, transport: Optional[Transport] = None,
                 start_queue: bool = True, device=None):
        assert journal_path, \
            "a fleet replica needs a local journal path (its WAL is " \
            "both its crash story and its replay target)"
        self.name = name
        self._config = config
        self._dataset = dataset
        self._model = model
        self._ckpt_path = checkpoint_path
        self.journal_path = journal_path
        self.watchdog = watchdog
        self.transport = transport
        self._start_queue = start_queue
        self._device = device
        self.engine = None
        self.alive = False
        self.segments_applied = 0
        self.records_applied = 0
        self.records_skipped = 0       # at-least-once dedup hits
        self.last_lag_s = 0.0          # seal-to-applied, last segment
        self.restarts = 0
        self.engine = self._build()
        self.alive = True

    def _build(self):
        from roc_tpu_torch.serve.engine import ServeEngine
        return ServeEngine(self._config, self._dataset, self._model,
                           checkpoint_path=self._ckpt_path,
                           watchdog=self.watchdog,
                           start_queue=self._start_queue,
                           delta_journal=self.journal_path,
                           device=self._device)

    # -- fleet-facing signals ----------------------------------------------
    @property
    def applied_seq(self) -> int:
        return self.engine.delta_seq() if self.alive else -1

    @property
    def load(self) -> int:
        return self.engine.pending() if self.alive else 1 << 30

    @property
    def snapshot_path(self) -> str:
        return self.journal_path + ".snapshot.npz"

    # -- query path (router calls these) ------------------------------------
    def submit(self, node_ids, deadline_s: Optional[float] = None):
        return self.engine.submit(node_ids, deadline_s=deadline_s)

    def query(self, node_ids, timeout: float = 60.0):
        return self.engine.query(node_ids, timeout=timeout)

    # -- replication path ----------------------------------------------------
    def apply_segment(self, seg: bytes) -> int:
        """Replay one shipped segment; returns records actually applied.
        Raises :class:`SegmentGapError` when the segment starts past the
        watermark + 1 (catch-up needed) and re-raises the decode
        taxonomy (torn / bit rot) untouched."""
        def _apply(seq, add, ret):
            res = self.engine.apply_delta(add if len(add) else None,
                                          ret if len(ret) else None)
            if res.get("seq") != seq:
                raise SegmentGapError(
                    f"replica {self.name!r} fell out of seq lockstep: "
                    f"replayed record {seq} landed as local seq "
                    f"{res.get('seq')}")

        applied, skipped, sealed_at = replay_segment(
            seg, self.applied_seq, _apply)
        self.records_skipped += skipped
        if not applied:
            return 0
        self.segments_applied += 1
        self.records_applied += applied
        # wall clock on purpose: the seal stamp was taken on the primary,
        # possibly in another process
        self.last_lag_s = max(time.time() - sealed_at, 0.0)
        return applied

    def poll(self, timeout: float = 0.0) -> int:
        """Drain the attached transport: apply every queued segment.
        Returns total records applied this poll."""
        assert self.transport is not None, \
            f"replica {self.name!r} has no transport attached"
        total = 0
        while True:
            seg = self.transport.recv(timeout if total == 0 else 0.0)
            if seg is None:
                return total
            total += self.apply_segment(seg)

    # -- catch-up + crash ----------------------------------------------------
    def install_snapshot(self, snap: bytes, journal: bytes) -> None:
        """Overwrite the local snapshot + journal with the primary's pair
        and restart the engine over them.  The two fsync-renames are not
        one atomic unit — ``fleet.snap.kill_install`` sits in the window
        — but the install is idempotent: a crash mid-install is healed
        by re-running catch-up from the top."""
        if self.alive:
            self.engine.close()
            self.alive = False
        install_snapshot_files(snap, journal, self.snapshot_path,
                               self.journal_path)
        self.restart()

    def catch_up(self, replog) -> int:
        """Full snapshot catch-up from the primary's ReplicationLog;
        returns the watermark the replica restarted at."""
        snap, journal, seq = replog.snapshot_blob()
        self.install_snapshot(snap, journal)
        return seq

    def kill(self) -> None:
        """Replica death.  With ``fleet.replica.kill`` armed this raises
        :class:`~roc_tpu_torch.fault.SimulatedCrash` *after* marking the
        replica dead and WITHOUT graceful teardown — the abandoned
        engine simply stops receiving work, exactly like a process that
        lost its CPU; nothing acked can be lost because every journaled
        record was fsynced before its ack.  Disarmed, it degrades to a
        graceful stop (the engine drains and closes)."""
        try:
            fault.point("fleet.replica.kill")
        except BaseException:
            self.alive = False   # hard kill: no close(), no drain
            raise
        if self.alive:
            self.engine.close()
            self.alive = False

    def restart(self) -> None:
        """Rebuild the engine from the local journal pair — the
        DeltaManager restore path (snapshot + tail replay) brings the
        served state back to the watermark."""
        if self.alive:
            self.engine.close()
        self.engine = self._build()
        self.alive = True
        self.restarts += 1

    def close(self) -> None:
        if self.alive:
            self.engine.close()
            self.alive = False
        if self.transport is not None:
            self.transport.close()

    def stats(self) -> dict:
        out = {"name": self.name, "alive": bool(self.alive),
               "applied_seq": int(self.applied_seq),
               "segments_applied": int(self.segments_applied),
               "records_applied": int(self.records_applied),
               "records_skipped": int(self.records_skipped),
               "restarts": int(self.restarts),
               "last_lag_s": float(self.last_lag_s)}
        if self.alive:
            out["load"] = int(self.load)
            out["cold_start"] = dict(self.engine.cold_start_stats)
        return out
