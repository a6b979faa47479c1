"""BalanceManager: the collect -> fit -> propose -> apply loop
(roc_tpu/balance/manager.py).

One balance round at an epoch boundary (train/driver.py):

  collect  probe each part's live aggregation time (its live edges only:
           the padded edge arrays would show every part the same work)
           through the port's sum (``ops.scatter_gather``: the sum kernel
           on the card, its plain version on the CPU), with the work
           counters from the partition and the halo structure;
  fit      refit the online least-squares cost model on the telemetry ring;
  propose  the min-max repartition search under the frozen shard shape;
  apply    reshard only when the predicted relative gain clears
           ``min_gain`` and the projected saving over the remaining epochs
           exceeds the *measured* resharding cost.  The first apply is
           optimistic (no measurement exists yet; applying is how one is
           made); every later decision amortizes the measured cost.

A proposal equal to the current cut is skipped outright, so a balancer
whose search reproduces the static cut leaves the training trajectory bit
for bit unchanged.  ``probe`` is an attribute so a caller can inject the
times (the tests assert nothing on wall-clock times).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from roc_tpu_torch import obs, ops
from roc_tpu_torch.balance import search
from roc_tpu_torch.balance.cost_model import OnlineCostModel
from roc_tpu_torch.balance.telemetry import ShardSample, TelemetryBuffer
from roc_tpu_torch.train.driver import device_sync

# Probe geometry: feature width and the edge-op target that sets the
# repeat count (amortizes launch overhead into the timed region).
_PROBE_WIDTH = 32
_PROBE_TARGET_EDGES = 600_000
_PROBE_MAX_REPS = 192
_PROBE_TRIES = 5


def probe_part_times(part, device="cpu", precision: str = "fast",
                     width: int = _PROBE_WIDTH) -> List[float]:
    """Measured per-iteration aggregation time of each part's live edges:
    ``reps`` sums over a [P*S, width] table, synced, the minimum of
    ``_PROBE_TRIES`` over ``reps`` (roc_tpu's synced span)."""
    device = torch.device(device)
    P, S = part.num_parts, part.shard_nodes
    table = torch.ones((P * S, width), dtype=torch.float32, device=device)
    out = []
    for p in range(P):
        ne = int(part.num_edges_valid[p])
        if ne == 0:
            out.append(0.0)
            continue
        row_ptr = np.zeros(S + 1, np.int64)
        np.cumsum(np.bincount(part.edge_dst[p, :ne], minlength=S),
                  out=row_ptr[1:])
        csr = ops.DeviceCsr(
            torch.as_tensor(row_ptr, device=device),
            torch.as_tensor(part.edge_src[p, :ne].astype(np.int32),
                            device=device))
        reps = min(max(1, -(-_PROBE_TARGET_EDGES // ne)), _PROBE_MAX_REPS)
        with torch.no_grad():
            ops.scatter_gather(table, csr, "sum", precision)  # warm
            device_sync(device)
            best = np.inf
            for _ in range(_PROBE_TRIES):
                with obs.span("probe", part=p, reps=reps) as sp:
                    for _ in range(reps):
                        ops.scatter_gather(table, csr, "sum", precision)
                    device_sync(device)
                best = min(best, sp.dur_s)
        out.append(best / reps)
    return out


class BalanceManager:
    """Per-trainer balancer state; one instance lives for the whole run."""

    def __init__(self, min_gain: float = 0.05, trace_path: str = "",
                 telemetry: Optional[TelemetryBuffer] = None,
                 halo_width: int = 0, halo_itemsize: int = 0):
        self.min_gain = float(min_gain)
        # 0 = the caller did not thread the run's shape: the cost model
        # keeps its probe-width fp32 prior
        kw = {}
        if halo_width:
            kw["halo_width"] = int(halo_width)
        if halo_itemsize:
            kw["halo_itemsize"] = int(halo_itemsize)
        self.model = OnlineCostModel(**kw)
        # `is not None`, not `or`: an empty TelemetryBuffer is falsy
        self.telemetry = (telemetry if telemetry is not None
                          else TelemetryBuffer(trace_path=trace_path))
        self.reshard_cost_s: Optional[float] = None
        self.rounds = 0
        self.events: List[dict] = []
        self.probe = probe_part_times
        # the run's obs.PerfWatchdog under -obs: probe-time stragglers
        # land in the same alert stream as slow epochs
        self.watchdog = None

    @classmethod
    def from_config(cls, cfg, halo_width: int = 0, halo_itemsize: int = 0,
                    telemetry: Optional[TelemetryBuffer] = None
                    ) -> "BalanceManager":
        return cls(min_gain=cfg.balance_min_gain,
                   trace_path=cfg.balance_trace, telemetry=telemetry,
                   halo_width=halo_width, halo_itemsize=halo_itemsize)

    # -- the four stages --------------------------------------------------
    def collect(self, part, graph, epoch: int, device="cpu",
                precision: str = "fast") -> List[ShardSample]:
        """Probe and counters for every part, recorded in the ring."""
        times = self.probe(part, device=device, precision=precision)
        halo_in, halo_out = search.halo_counts(graph.row_ptr, graph.col_idx,
                                               part.bounds)
        samples = []
        for p in range(part.num_parts):
            s = ShardSample(
                epoch=epoch, part=p, time_s=float(times[p]),
                nodes=int(part.num_valid[p]),
                edges=int(part.num_edges_valid[p]),
                halo_in=int(halo_in[p]), halo_out=int(halo_out[p]))
            self.telemetry.record(s)
            samples.append(s)
        return samples

    def fit(self) -> float:
        X, t = self.telemetry.design()
        if len(t) == 0:
            return float("nan")
        return self.model.fit(X, t)

    def propose(self, part, graph):
        """(bounds, predicted_times_new, predicted_times_current)."""
        bounds, times = search.propose_bounds(
            graph.row_ptr, graph.col_idx, part.num_parts, self.model,
            max_nodes=part.shard_nodes - 1, max_edges=part.shard_edges)
        cur = self.model.predict(
            search.part_features(graph.row_ptr, graph.col_idx, part.bounds))
        return bounds, times, cur

    def step(self, trainer, epoch: int, remaining_epochs: int
             ) -> Optional[dict]:
        """One balance round against a live trainer.  Returns the decision
        record (also in ``self.events`` and the JSONL trace), or None when
        the trainer has no partition."""
        part = getattr(trainer, "part", None)
        if part is None:
            return None
        graph = trainer.dataset.graph
        self.rounds += 1
        # calibration pair for the fitted model: predict the slowest part's
        # probe time before probing (once a measured fit exists), measure
        # it right after
        led = obs.get_ledger()
        pred_key = None
        if led.attached and self.rounds > 1:
            from roc_tpu_torch.obs.ledger import content_key
            feats = search.part_features(graph.row_ptr, graph.col_idx,
                                         part.bounds)
            pred_key = content_key(round=self.rounds,
                                   parts=part.num_parts)
            led.predict("shard_cost", pred_key,
                        float(np.max(self.model.predict(feats))), "s",
                        epoch=int(epoch))
        samples = self.collect(part, graph, epoch, device=trainer.device,
                               precision=trainer.config.aggregate_precision)
        if pred_key is not None:
            led.measure("shard_cost", pred_key,
                        max(s.time_s for s in samples), "s",
                        epoch=int(epoch))
        if self.watchdog is not None:
            for alert in self.watchdog.observe_shards(
                    epoch, [s.time_s for s in samples]):
                self.telemetry.record_event("watchdog", **alert)
        r2 = self.fit()
        bounds, t_new, t_cur = self.propose(part, graph)
        ev = self._decide(trainer, part, bounds, t_new, t_cur, epoch,
                          remaining_epochs, r2)
        self.events.append(ev)
        self.telemetry.record_event("balance", **ev)
        return ev

    def _decide(self, trainer, part, bounds, t_new, t_cur, epoch,
                remaining_epochs, r2) -> dict:
        max_new, max_cur = float(np.max(t_new)), float(np.max(t_cur))
        rel_gain = 1.0 - max_new / max_cur if max_cur > 0 else 0.0
        ev = {"epoch": epoch, "round": self.rounds, "r2": r2,
              "pred_max_cur_s": max_cur, "pred_max_new_s": max_new,
              "rel_gain": rel_gain, "action": "skip"}
        if np.array_equal(np.asarray(bounds), np.asarray(part.bounds)):
            ev["action"] = "noop"          # proposal == current cut
            return ev
        if rel_gain < self.min_gain:
            ev["reason"] = f"gain {rel_gain:.3f} < min_gain {self.min_gain}"
            return ev
        # the projected saving over the remaining epochs must beat the
        # measured reshard cost; the probe-level gain scales the latest
        # measured epoch time
        epoch_s = trainer.epoch_times[-1] if getattr(
            trainer, "epoch_times", None) else 0.0
        if self.reshard_cost_s is not None:
            saving = rel_gain * epoch_s * remaining_epochs
            if saving <= self.reshard_cost_s:
                ev["reason"] = (f"projected saving {saving:.3f}s <= measured "
                                f"reshard cost {self.reshard_cost_s:.3f}s")
                return ev
        cost = trainer.reshard(np.asarray(bounds, dtype=np.int64))
        self.reshard_cost_s = float(cost)
        ev.update(action="reshard", reshard_cost_s=float(cost),
                  bounds=np.asarray(bounds).tolist())
        return ev
