"""Runtime perf watchdog (roc_tpu/obs/watchdog.py): an EWMA of epoch wall
time that flags an epoch slower than ``ratio`` x the mean, the non-finite
step feed of the fault guard, and the streaming executor's two stall
feeds (the ring's stall fraction, the spill writes' stall fraction).

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


class PerfWatchdog:
    """EWMA slow-epoch detector and non-finite step counter."""

    _STATE_KEYS = ("ewma", "observed", "seeded", "stall_ewma",
                   "stall_observed", "spill_ewma", "spill_observed",
                   "nonfinite_steps")

    def __init__(self, ratio: float = DEFAULT_RATIO,
                 alpha: float = DEFAULT_ALPHA,
                 warmup: int = DEFAULT_WARMUP):
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

    def verdict(self) -> str:
        """"nonfinite" outranks "regressed" (any slow epoch), then
        "stream-stall", then "spill-stall"; "ok" otherwise."""
        kinds = {a["kind"] for a in self.alerts}
        for kind, word in (("nonfinite", "nonfinite"),
                           ("slow-epoch", "regressed"),
                           ("stream-stall", "stream-stall"),
                           ("spill-stall", "spill-stall")):
            if kind in kinds:
                return word
        return "ok"
