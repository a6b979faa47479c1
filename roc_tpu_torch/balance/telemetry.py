"""Per-part telemetry (roc_tpu/balance/telemetry.py, element for element):
work counters and probe timings, in a ring buffer and a JSONL trace.

The reference measures per-partition runtimes off its executed tasks and
feeds them back into the partitioner.  Each balance round records one
:class:`ShardSample` per part (the measured aggregation time and the work
counters the cost model regresses on: live nodes, live edges, halo rows in
and out) into a bounded ring, and optionally appends every record to a
JSONL trace.  Epoch times and rebalance decisions go through the same
writer, so one pass over the trace reconstructs the run's measure -> fit
-> reshard history.  The schema is roc_tpu's, so either package's trace
reads the same way.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Iterable, List, Optional, Tuple

import numpy as np

# Feature order of the cost model's design matrix (+ trailing constant 1).
FEATURE_NAMES = ("nodes", "edges", "halo_in", "halo_out")
NUM_FEATURES = len(FEATURE_NAMES) + 1


@dataclasses.dataclass(frozen=True)
class ShardSample:
    """One part's measurement at one balance round.

    ``time_s`` is the probe-measured per-iteration aggregation time;
    ``kind`` distinguishes measured probes from synthesized warm-start
    priors (cost_model.py) so fits can weight them differently.
    """

    epoch: int
    part: int
    time_s: float
    nodes: int
    edges: int
    halo_in: int
    halo_out: int
    plan_steps: int = 0
    kind: str = "probe"

    def features(self) -> np.ndarray:
        return np.array([self.nodes, self.edges, self.halo_in,
                         self.halo_out, 1.0], dtype=np.float64)


class TelemetryBuffer:
    """Bounded ring of :class:`ShardSample` + best-effort JSONL trace."""

    def __init__(self, capacity: int = 512, trace_path: str = ""):
        self.capacity = int(capacity)
        self.trace_path = trace_path
        self._ring: deque = deque(maxlen=self.capacity)

    # -- recording --------------------------------------------------------
    def record(self, sample: ShardSample) -> None:
        self._ring.append(sample)
        self._emit({"type": "shard", **dataclasses.asdict(sample)})

    def record_epoch(self, epoch: int, wall_s: float,
                     loss: Optional[float] = None,
                     peak_hbm: Optional[int] = None,
                     peak_hbm_source: str = "") -> None:
        """``peak_hbm``: the epoch's peak device memory in bytes, measured
        on the card, the memory planner's prediction elsewhere;
        ``peak_hbm_source`` says which ("measured" | "estimated")."""
        rec = {"type": "epoch", "epoch": epoch, "wall_s": round(wall_s, 6)}
        if loss is not None:
            rec["loss"] = float(loss)
        if peak_hbm is not None:
            rec["peak_hbm_bytes"] = int(peak_hbm)
            rec["peak_hbm_source"] = peak_hbm_source
        self._emit(rec)

    def record_event(self, kind: str, /, **fields) -> None:
        # positional-only: watchdog alerts legitimately carry a "kind"
        # FIELD (slow-epoch/straggler) next to the record's type
        self._emit({"type": kind, **fields})

    def _emit(self, obj: dict) -> None:
        if not self.trace_path:
            return
        try:
            with open(self.trace_path, "a") as f:
                f.write(json.dumps(obj, default=_jsonable) + "\n")
        except OSError:
            # roclint: allow(silent-swallow) tracing must never take down training
            pass    # tracing must never take down training

    # -- reading ----------------------------------------------------------
    def samples(self, kinds: Iterable[str] = ("probe",)) -> List[ShardSample]:
        kinds = set(kinds)
        return [s for s in self._ring if s.kind in kinds]

    def design(self, kinds: Iterable[str] = ("probe",)
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(X [n, 5], t [n]) over the retained samples, oldest first."""
        ss = self.samples(kinds)
        if not ss:
            return (np.zeros((0, NUM_FEATURES)), np.zeros((0,)))
        X = np.stack([s.features() for s in ss])
        t = np.array([s.time_s for s in ss], dtype=np.float64)
        return X, t

    def __len__(self) -> int:
        return len(self._ring)


def _jsonable(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)
