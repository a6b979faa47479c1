"""Backpressure-aware query router over a replicated serving fleet
(roc_tpu/fleet/router.py).

One primary (owns the delta write path and the replication log) plus N
followers (replay shipped segments).  Queries go to ANY sufficiently
fresh replica; deltas go to the primary and fan out as sealed segments.

Dispatch is least-loaded with a freshness floor: a replica whose applied
watermark trails the primary's by more than ``freshness_floor`` records
is excluded until it catches up (floor ``None`` disables the check —
eventual-consistency reads; floor ``0`` is read-your-writes).  Within
the eligible set the router picks the smallest queue depth
(``Replica.load``), so a replica stuck in replay naturally stops
receiving traffic twice over — stale AND deep.

Backpressure is typed end to end.  A replica that sheds at its depth cap
(:class:`~roc_tpu_torch.serve.queue.Overloaded`) costs the router one *retry
on a sibling*; when every eligible sibling has shed, the router raises
:class:`FleetOverloaded` (an ``Overloaded`` subclass, so existing
clients' backoff paths already handle it) and counts it — shed is
reported, never silent.  Per-request deadline expiry keeps its queue
semantics (the future resolves with ``Overloaded``); the router just
aggregates the counts in ``stats()``.

The autoscale hook is deliberately a *hook*: the router decides, the
caller (selftest, bench, a real operator loop) provides ``spawn_cb`` /
``drain_cb``.  The ladder reads the two observability feeds it already
pays for — the watchdog's serve-p99 EWMA (per-replica latency trend)
and the fleet-lag EWMA fed through ``observe_fleet`` at every pump —
plus the router's own shed rate:

  scale UP    when the window's shed rate crosses ``up_shed_rate`` or a
              fleet-lag/serve-p99 watchdog alert fired this window
  scale DOWN  when a full cooldown of windows saw zero shed, zero
              alerts, and an idle mean queue depth

with a cooldown between actions so one burst cannot thrash the fleet.
Every decision lands in ``scale_events`` with its reason.

Replication lag gets the predicted/measured ledger treatment like every
other subsystem: predicted from the per-record patch cost model (the
segment must be decoded + each record classified and row-patched on
the follower), measured as the seal-to-applied wall clock carried in
the segment header.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from roc_tpu_torch.fleet.replica import Replica
from roc_tpu_torch.fleet.replog import ReplicationLog, SegmentGapError
from roc_tpu_torch.obs.ledger import content_key, get_ledger
from roc_tpu_torch.serve.queue import Closed, Overloaded

__all__ = ["FleetOverloaded", "FleetRouter"]


class FleetOverloaded(Overloaded):
    """Every eligible replica shed this request: fleet-wide
    backpressure.  Subclasses the queue's Overloaded so single-engine
    clients' backoff handling works unchanged; the extra type tells a
    fleet-aware caller that sibling retry is already exhausted."""


class FleetRouter:
    """Least-loaded, freshness-floored dispatch; see module docstring."""

    def __init__(self, primary: Replica, followers: List[Replica],
                 replog: ReplicationLog,
                 freshness_floor: Optional[int] = 0,
                 max_retries: int = 1,
                 watchdog=None,
                 spawn_cb: Optional[Callable[[], Replica]] = None,
                 drain_cb: Optional[Callable[[Replica], None]] = None,
                 up_shed_rate: float = 0.05,
                 scale_cooldown: int = 4,
                 min_replicas: int = 1, max_replicas: int = 8,
                 verbose: bool = False):
        assert max_retries >= 0 and scale_cooldown >= 1
        self.primary = primary
        self.followers = list(followers)
        self.replog = replog
        self.freshness_floor = freshness_floor
        self.max_retries = int(max_retries)
        self.watchdog = watchdog
        self.spawn_cb = spawn_cb
        self.drain_cb = drain_cb
        self.up_shed_rate = float(up_shed_rate)
        self.scale_cooldown = int(scale_cooldown)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.verbose = verbose
        self.submits = 0
        self.routed = 0
        self.shed = 0              # FleetOverloaded raised (all siblings)
        self.sibling_retries = 0   # Overloaded absorbed by a retry
        self.pumps = 0
        self.catch_ups = 0
        self.scale_events: List[dict] = []
        self._win_submits = 0
        self._win_shed = 0
        self._win_alerts = 0
        self._quiet_windows = 0
        self._since_scale = self.scale_cooldown  # first window may scale
        self._ledger_key = content_key(
            kind="fleet", replicas=1 + len(self.followers),
            floor=-1 if freshness_floor is None else int(freshness_floor))

    # -- membership ---------------------------------------------------------
    @property
    def replicas(self) -> List[Replica]:
        return [self.primary] + self.followers

    @property
    def bundle(self):
        """The primary's frozen bundle — lets serve/loadgen.run_load
        drive the router exactly like a single engine."""
        return self.primary.engine.bundle

    def eligible(self) -> List[Replica]:
        head = self.primary.applied_seq
        out = []
        for rep in self.replicas:
            if not rep.alive:
                continue
            if self.freshness_floor is not None and \
                    head - rep.applied_seq > self.freshness_floor:
                continue
            out.append(rep)
        return out

    # -- query path ---------------------------------------------------------
    def submit(self, node_ids, deadline_s: Optional[float] = None):
        """Route one request; returns the chosen replica's ServeFuture.
        Raises :class:`FleetOverloaded` when every eligible replica
        sheds (or none is eligible at all)."""
        self.submits += 1
        self._win_submits += 1
        ranked = sorted(self.eligible(), key=lambda r: r.load)
        if not ranked:
            self._shed_one()
            raise FleetOverloaded(
                "no replica satisfies the freshness floor (fleet "
                "catching up); shedding — retry with backoff")
        tried = 0
        for rep in ranked:
            if tried > self.max_retries:
                break
            try:
                fut = rep.submit(node_ids, deadline_s=deadline_s)
            except (Overloaded, Closed):
                # Overloaded: replica shed at its depth cap.  Closed: it
                # raced a kill/close between eligibility and submit.
                # Both re-route to the next-least-loaded sibling.
                tried += 1
                self.sibling_retries += 1
                continue
            self.routed += 1
            return fut
        self._shed_one()
        raise FleetOverloaded(
            f"all {min(len(ranked), tried)} eligible replicas shed this "
            f"request; fleet-wide backpressure — retry with backoff")

    def _shed_one(self) -> None:
        self.shed += 1
        self._win_shed += 1

    def query(self, node_ids, timeout: float = 60.0):
        return self.submit(node_ids).result(timeout)

    # -- delta + replication path -------------------------------------------
    def apply_delta(self, add_edges=None, retire_edges=None,
                    wait_replan: bool = False, pump: bool = True) -> dict:
        """Apply one delta batch on the primary and (by default) pump it
        through the fleet before returning — the synchronous shape the
        parity tests pin.  ``pump=False`` defers shipping for callers
        that batch several deltas per segment."""
        res = self.primary.engine.apply_delta(add_edges, retire_edges,
                                              wait_replan=wait_replan)
        if pump:
            self.pump()
        return res

    def pump(self, timeout: float = 0.0) -> int:
        """One replication turn: seal + ship the primary's journal tail,
        have every live follower drain its transport, feed the lag EWMA
        and the ledger, run the autoscale ladder.  Returns records
        replayed fleet-wide this pump.  A follower that reports a
        sequence gap is caught up through the snapshot protocol in-line
        (counted, never silent)."""
        seg = self.replog.ship()
        applied = 0
        for rep in self.followers:
            if not rep.alive or rep.transport is None:
                continue
            try:
                applied += rep.poll(timeout)
            except SegmentGapError:
                self.catch_ups += 1
                rep.catch_up(self.replog)
                applied += rep.poll(0.0)
            if rep.applied_seq < self.replog.shipped_seq:
                # behind the SHIPPED watermark with a drained transport:
                # the missing records were sealed before this replica's
                # transport attached (restart/join) and will never
                # arrive on it — snapshot catch-up is the only road
                self.catch_ups += 1
                before = rep.applied_seq
                rep.catch_up(self.replog)
                applied += max(rep.applied_seq - before, 0)
                applied += rep.poll(0.0)
        self.pumps += 1
        if seg is not None:
            self._note_lag(applied)
        self.maybe_scale()
        return applied

    def _note_lag(self, records: int) -> None:
        live = [r for r in self.followers if r.alive]
        lag = max((r.last_lag_s for r in live), default=0.0)
        n = max(records, 1)
        led = get_ledger()
        # follower replay cost model: fixed decode/ship overhead + the
        # primary's own per-record patch model (classification and row
        # re-cut repeat identically on the follower)
        led.predict("fleet-lag", self._ledger_key, 5e-4 + 4e-4 * n, "s")
        led.measure("fleet-lag", self._ledger_key, lag, "s")
        if self.watchdog is not None:
            rate = self._win_shed / max(self._win_submits, 1)
            alert = self.watchdog.observe_fleet(self.pumps, lag,
                                                shed_rate=rate)
            if alert is not None:
                self._win_alerts += 1
                if self.verbose:
                    print(f"# watchdog: fleet lag {alert['lag_s']*1e3:.2f}"
                          f" ms is {alert['ratio']:.2f}x its EWMA")

    # -- autoscale ladder ----------------------------------------------------
    def maybe_scale(self) -> Optional[dict]:
        """One ladder step over the current window's counters; returns
        the scale event (also appended to ``scale_events``) or None."""
        if self.spawn_cb is None and self.drain_cb is None:
            return None
        self._since_scale += 1
        shed_rate = self._win_shed / max(self._win_submits, 1)
        serve_hot = False
        if self.watchdog is not None:
            serve_hot = any(a.get("kind") in ("serve-p99", "fleet-lag")
                            for a in self.watchdog.alerts[-4:])
        hot = shed_rate > self.up_shed_rate or serve_hot
        idle = (self._win_shed == 0 and self._win_alerts == 0 and
                all(r.load == 0 for r in self.replicas if r.alive))
        self._quiet_windows = self._quiet_windows + 1 if idle else 0
        self._win_submits = self._win_shed = self._win_alerts = 0
        if self._since_scale < self.scale_cooldown:
            return None
        event = None
        n = len(self.replicas)
        if hot and n < self.max_replicas and self.spawn_cb is not None:
            rep = self.spawn_cb()
            if rep is not None:
                self.followers.append(rep)
                event = {"event": self.pumps, "action": "spawn",
                         "replica": rep.name,
                         "reason": ("shed-rate" if shed_rate >
                                    self.up_shed_rate else "watchdog")}
        elif (self._quiet_windows >= self.scale_cooldown and
              n > self.min_replicas and self.drain_cb is not None and
              self.followers):
            rep = self.followers.pop()
            self.replog.detach(rep.transport)
            self.drain_cb(rep)
            event = {"event": self.pumps, "action": "drain",
                     "replica": rep.name, "reason": "idle"}
        if event is not None:
            self._since_scale = 0
            self._quiet_windows = 0
            self.scale_events.append(event)
            if self.verbose:
                print(f"# fleet: {event['action']} {event['replica']} "
                      f"({event['reason']})")
        return event

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        for rep in self.replicas:
            rep.close()

    def stats(self) -> dict:
        expired = sum(r.engine.queue.expired
                      for r in self.replicas
                      if r.alive and r.engine.queue is not None)
        return {"replicas": len(self.replicas),
                "alive": sum(1 for r in self.replicas if r.alive),
                "submits": int(self.submits),
                "routed": int(self.routed),
                "shed": int(self.shed),
                "sibling_retries": int(self.sibling_retries),
                "expired": int(expired),
                "pumps": int(self.pumps),
                "catch_ups": int(self.catch_ups),
                "head_seq": int(self.primary.applied_seq),
                "min_seq": min((r.applied_seq for r in self.replicas
                                if r.alive), default=-1),
                "scale_events": list(self.scale_events),
                "replog": self.replog.stats(),
                "members": [r.stats() for r in self.replicas]}
