"""Runtime perf watchdog (roc_tpu/obs/watchdog.py): an EWMA of epoch wall
time that flags an epoch slower than ``ratio`` x the mean, the non-finite
step feed of the fault guard, the streaming executor's two stall feeds
(the ring's stall fraction, the spill writes' stall fraction), the serving
feeds (the engine's p99, the delta manager's apply time, the fleet's
replication lag) and the calibration ledger's per-model ratio EWMAs.

roc_tpu can seed the EWMA from its committed TPU kernel budgets
(``seed_for_graph``); no TPU number describes this port's card, so the
port's watchdog always starts from its measured warm-up: epoch 0 (kernel
builds, allocator warm-up) never sets the baseline, and the detector arms
after ``warmup`` epochs.  Alerts are plain dicts, emitted through the
metrics registry; ``verdict()`` summarizes them.  ``state_dict`` /
``load_state`` carry the EWMA through a checkpoint, in a form either
package's checkpoint holds (unknown keys are ignored both ways).
"""

from __future__ import annotations

from typing import List, Optional

DEFAULT_RATIO = 2.0        # alert when epoch > ratio x EWMA
DEFAULT_ALPHA = 0.25       # EWMA smoothing (higher = adapts faster)
DEFAULT_WARMUP = 2         # observe this many epochs before judging
# Calibration drift: alert when a cost model's measured/predicted ratio
# EWMA leaves this band (wide: the alert is for "the model stopped
# describing reality", not for 20 % noise)
CALIBRATION_BAND = (0.5, 2.0)


class PerfWatchdog:
    """EWMA slow-epoch detector, non-finite step counter and the stall,
    serving and calibration feeds."""

    _STATE_KEYS = ("ewma", "observed", "seeded", "stall_ewma",
                   "stall_observed", "spill_ewma", "spill_observed",
                   "serve_ewma", "serve_observed",
                   "delta_ewma", "delta_observed",
                   "fleet_ewma", "fleet_observed",
                   "calib_ewma", "calib_observed", "nonfinite_steps")

    def __init__(self, ratio: float = DEFAULT_RATIO,
                 alpha: float = DEFAULT_ALPHA,
                 warmup: int = DEFAULT_WARMUP,
                 calibration_band=CALIBRATION_BAND):
        self.ratio = float(ratio)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.seeded = False
        self.ewma: Optional[float] = None
        self.observed = 0
        self.alerts: List[dict] = []
        self.nonfinite_steps = 0
        # the stream executor's stall fractions (stall seconds over the
        # epoch's wall time), one EWMA each
        self.stall_ewma: Optional[float] = None
        self.stall_observed = 0
        self.spill_ewma: Optional[float] = None
        self.spill_observed = 0
        # serving p99 (serve engine), delta apply seconds (delta manager)
        # and replication lag (fleet router), one EWMA each
        self.serve_ewma: Optional[float] = None
        self.serve_observed = 0
        self.delta_ewma: Optional[float] = None
        self.delta_observed = 0
        self.fleet_ewma: Optional[float] = None
        self.fleet_observed = 0
        # per-cost-model measured/predicted ratio EWMAs (ledger feed)
        self.calibration_band = (float(calibration_band[0]),
                                 float(calibration_band[1]))
        self.calib_ewma: dict = {}
        self.calib_observed: dict = {}

    def state_dict(self) -> dict:
        """JSON-able EWMA state for the checkpoint's ``extra`` record, so a
        resumed run's watchdog is armed from its first epoch."""
        return {k: getattr(self, k) for k in self._STATE_KEYS}

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output; unknown and missing keys are
        ignored."""
        if not isinstance(state, dict):
            return
        for k in self._STATE_KEYS:
            if k in state:
                setattr(self, k, state[k])

    def observe_epoch(self, epoch: int, wall_s: float) -> Optional[dict]:
        """Feed one epoch's wall time; returns an alert dict or None."""
        wall_s = float(wall_s)
        armed = self.ewma is not None and \
            (self.seeded or self.observed >= self.warmup)
        alert = None
        if armed and wall_s > self.ratio * self.ewma:
            alert = {"kind": "slow-epoch", "epoch": int(epoch),
                     "wall_s": wall_s, "ewma_s": float(self.ewma),
                     "ratio": wall_s / self.ewma}
            self.alerts.append(alert)
            # clamp the outlier's pull, so one anomaly does not poison the
            # baseline the next epoch is measured against
            wall_s = self.ratio * self.ewma
        if self.observed >= 1 or self.seeded:
            # epoch 0 carries the kernel builds: start at epoch 1
            self.ewma = wall_s if self.ewma is None else \
                self.alpha * wall_s + (1.0 - self.alpha) * self.ewma
        self.observed += 1
        return alert

    def observe_nonfinite(self, epoch: int,
                          consecutive: int) -> Optional[dict]:
        """Feed one skipped (non-finite loss or gradient) step.  Always
        alerts, with the consecutive-skip streak, so the escalation
        ladder's state is in the metrics stream."""
        self.nonfinite_steps += 1
        alert = {"kind": "nonfinite", "epoch": int(epoch),
                 "consecutive": int(consecutive),
                 "total": int(self.nonfinite_steps)}
        self.alerts.append(alert)
        return alert

    def _observe_frac(self, kind: str, attr: str, epoch: int,
                      frac: float) -> Optional[dict]:
        """One stall-fraction feed (watchdog.py:131-185): alert when the
        fraction exceeds ``ratio`` x its EWMA, the baseline floored at
        0.02 (a fully overlapped run's 0.001 -> 0.003 wiggle is no
        alert); epoch 0 (first-touch transfers and page faults) never
        sets the baseline."""
        frac = float(frac)
        ewma = getattr(self, attr + "_ewma")
        observed = getattr(self, attr + "_observed")
        armed = ewma is not None and observed >= self.warmup
        baseline = max(ewma or 0.0, 0.02)
        alert = None
        if armed and frac > self.ratio * baseline:
            alert = {"kind": kind, "epoch": int(epoch), "stall_frac": frac,
                     "ewma": float(ewma), "ratio": frac / baseline}
            self.alerts.append(alert)
            frac = self.ratio * baseline
        if observed >= 1:
            setattr(self, attr + "_ewma", frac if ewma is None else
                    self.alpha * frac + (1.0 - self.alpha) * ewma)
        setattr(self, attr + "_observed", observed + 1)
        return alert

    def observe_stream(self, epoch: int,
                       stall_frac: float) -> Optional[dict]:
        """Feed one streamed epoch's ring stall fraction: an alert says the
        prefetch stopped hiding the transfers."""
        return self._observe_frac("stream-stall", "stall", epoch,
                                  stall_frac)

    def observe_spill(self, epoch: int,
                      stall_frac: float) -> Optional[dict]:
        """Feed one spilled epoch's spill-write stall fraction: an alert
        says the spill device stopped keeping up."""
        return self._observe_frac("spill-stall", "spill", epoch, stall_frac)

    def _observe_latency(self, kind: str, attr: str, idx_key: str,
                         idx: int, val_key: str, value: float,
                         **fields) -> Optional[dict]:
        """One latency feed (watchdog.py:187-262): alert when the sample
        exceeds ``ratio`` x its EWMA and clamp it there; observation 0
        (first-touch and warm-up noise) never sets the baseline."""
        v = float(value)
        ewma = getattr(self, attr + "_ewma")
        observed = getattr(self, attr + "_observed")
        armed = ewma is not None and observed >= self.warmup
        alert = None
        if armed and v > self.ratio * ewma:
            alert = {"kind": kind, idx_key: int(idx), val_key: v,
                     "ewma_s": float(ewma), "ratio": v / ewma, **fields}
            self.alerts.append(alert)
            v = self.ratio * ewma
        if observed >= 1:
            setattr(self, attr + "_ewma", v if ewma is None else
                    self.alpha * v + (1.0 - self.alpha) * ewma)
        setattr(self, attr + "_observed", observed + 1)
        return alert

    def observe_serve(self, window: int, p99_s: float) -> Optional[dict]:
        """Feed one serving p99 sample (the engine aggregates a few
        windows' request latencies per feed): queueing collapse or a slow
        dispatch shows in the tail before the mean moves."""
        return self._observe_latency("serve-latency", "serve", "window",
                                     window, "p99_s", p99_s)

    def observe_delta(self, batch: int, apply_s: float) -> Optional[dict]:
        """Feed one delta-apply wall time (every applied batch but the
        replayed ones): a patch that rewrites far more rows, or a slow
        journal fsync, shows here before it backs up the mutation path."""
        return self._observe_latency("delta-apply", "delta", "batch", batch,
                                     "apply_s", apply_s)

    def observe_fleet(self, event: int, lag_s: float,
                      shed_rate: float = 0.0) -> Optional[dict]:
        """Feed one replication-lag sample (seal to applied, worst
        follower, per shipped segment); the alert carries the router's
        shed rate, so an autoscale decision can be reconstructed."""
        return self._observe_latency("fleet-lag", "fleet", "event", event,
                                     "lag_s", lag_s,
                                     shed_rate=float(shed_rate))

    def observe_calibration(self, model: str, ratio: float,
                            epoch: int = -1) -> Optional[dict]:
        """Feed one joined (cost model, measured/predicted) ratio from the
        calibration ledger; alert when the model's ratio EWMA leaves
        ``calibration_band``.  A model's first ``warmup`` pairs only
        build its EWMA."""
        r = float(ratio)
        if r <= 0:
            return None    # a non-positive ratio is a broken pair
        model = str(model)
        ew = self.calib_ewma.get(model)
        self.calib_ewma[model] = r if ew is None else \
            self.alpha * r + (1.0 - self.alpha) * ew
        seen = self.calib_observed.get(model, 0) + 1
        self.calib_observed[model] = seen
        lo, hi = self.calibration_band
        cur = self.calib_ewma[model]
        if seen <= self.warmup or lo <= cur <= hi:
            return None
        alert = {"kind": "calibration-drift", "epoch": int(epoch),
                 "model": model, "ewma_ratio": float(cur),
                 "band_lo": lo, "band_hi": hi}
        self.alerts.append(alert)
        return alert

    def verdict(self) -> str:
        """"nonfinite" outranks "regressed" (any slow epoch), then
        "stream-stall", "spill-stall", "serve-latency", "delta-apply",
        "fleet-lag" and "calibration-drift"; "ok" otherwise."""
        kinds = {a["kind"] for a in self.alerts}
        for kind, word in (("nonfinite", "nonfinite"),
                           ("slow-epoch", "regressed"),
                           ("stream-stall", "stream-stall"),
                           ("spill-stall", "spill-stall"),
                           ("serve-latency", "serve-latency"),
                           ("delta-apply", "delta-apply"),
                           ("fleet-lag", "fleet-lag"),
                           ("calibration-drift", "calibration-drift")):
            if kind in kinds:
                return word
        return "ok"
