"""Calibration ledger (roc_tpu/obs/ledger.py, a copy: the module needs
only the standard library): the predicted-vs-measured flight recorder.

Every cost model of the port makes predictions a run can check against
itself: the memory estimator predicts the step time and the peak device
memory before the first epoch, the stream executor predicts its wire
bytes, ring overlap and transfer seconds from the slot geometry, the
delta manager prices a patch, the serving engine prices a forward from
the roofline.  Two record shapes ride the metrics JSONL envelope:

  {"type": "prediction",  "model": <cost-model name>, "key": <content key>,
   "value": <float>, "units": <str>, ...extra}
  {"type": "measurement", "model": ..., "key": ..., "value": ...,
   "units": ..., "predicted": <float>, "ratio": <measured/predicted>, ...}

``model`` names the cost model that spoke (step_time, peak_memory,
wire_bytes, overlap_frac, stream_xfer_s, delta-apply, serve-p50, ...);
``key`` is a *content key*, a canonical string over the inputs the
prediction was computed from (``content_key(rows=..., edges=...)``), so a
measurement joins the prediction made for its configuration.  A
measurement carries the joined prediction inline (``predicted`` +
``ratio``); ``python -m roc_tpu_torch.obs calibration`` aggregates the
ratios per model, and the watchdog's ``observe_calibration`` EWMA alerts
when a model leaves its band mid-run.

Emission is host-side and gated on ``attach()``: sites call
``get_ledger().predict(...)`` unconditionally, and the call is a dict
update unless a metrics registry is attached (``-obs`` runs).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

_RING = 4096  # joined-pair tail kept in memory (mirrors metrics tail)


def content_key(**kv) -> str:
    """Canonical content key over a prediction's inputs: sorted
    ``k=v`` pairs joined with ``|`` (`k` order-insensitive, so call
    sites don't have to agree on argument order)."""
    return "|".join(f"{k}={kv[k]}" for k in sorted(kv))


class CalibrationLedger:
    """Prediction/measurement recorder with content-keyed joining."""

    def __init__(self):
        self._emit: Optional[Callable] = None
        # latest prediction value per (model, key) — measurements join here
        self._pending: Dict[Tuple[str, str], float] = {}
        # joined (model, ratio) pairs since the last drain (watchdog feed)
        self._ratios: deque = deque(maxlen=_RING)
        # full joined-record tail for in-process consumers (selftest)
        self.records: deque = deque(maxlen=_RING)

    # -- wiring -----------------------------------------------------------
    def attach(self, emit: Callable) -> None:
        """Point the ledger at a record sink with the registry's
        signature: ``emit(kind, /, **fields)``.  The trainer attaches its
        MetricsRegistry so ledger records land in the same JSONL stream
        as epoch metrics."""
        self._emit = emit

    def detach(self) -> None:
        self._emit = None

    @property
    def attached(self) -> bool:
        return self._emit is not None

    # -- recording --------------------------------------------------------
    def predict(self, model: str, key: str, value, units: str,
                **extra) -> None:
        """One cost-model prediction.  Re-predicting the same (model,
        key) overwrites — the join always pairs against the newest."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        self._pending[(str(model), str(key))] = v
        rec = {"model": str(model), "key": str(key), "value": v,
               "units": str(units), **extra}
        self.records.append(("prediction", rec))
        if self._emit is not None:
            self._emit("prediction", **rec)

    def measure(self, model: str, key: str, value, units: str,
                **extra) -> Optional[float]:
        """One measurement; joins the pending prediction for (model,
        key) when there is one, stamping ``predicted`` + ``ratio`` into
        the record.  Returns the ratio (measured/predicted) or None when
        unpaired / predicted == 0."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            return None
        rec = {"model": str(model), "key": str(key), "value": v,
               "units": str(units), **extra}
        ratio = None
        pred = self._pending.get((str(model), str(key)))
        if pred is not None:
            rec["predicted"] = pred
            if pred != 0.0:
                ratio = v / pred
                rec["ratio"] = ratio
                self._ratios.append((str(model), ratio))
        self.records.append(("measurement", rec))
        if self._emit is not None:
            self._emit("measurement", **rec)
        return ratio

    def drain_ratios(self) -> List[Tuple[str, float]]:
        """(model, ratio) pairs joined since the last drain — the trainer
        feeds these to ``PerfWatchdog.observe_calibration`` at each epoch
        boundary."""
        out = list(self._ratios)
        self._ratios.clear()
        return out

    def clear(self) -> None:
        self._pending.clear()
        self._ratios.clear()
        self.records.clear()


_LEDGER: Optional[CalibrationLedger] = None


def get_ledger() -> CalibrationLedger:
    """The process-wide ledger (one per process, like the tracer)."""
    global _LEDGER
    if _LEDGER is None:
        _LEDGER = CalibrationLedger()
    return _LEDGER


# -- offline analysis (the CLI and its selftest) ---------------------------

_REQUIRED = ("model", "key", "value", "units")


def validate_records(records: List[dict]) -> List[str]:
    """Schema check over ledger records in a JSONL stream: every
    prediction/measurement carries model/key/value/units with a numeric
    value, and measurement ratios (when present) equal value/predicted.
    Returns human-readable problem strings (empty = valid)."""
    problems = []
    for i, r in enumerate(records):
        if r.get("type") not in ("prediction", "measurement"):
            continue
        for f in _REQUIRED:
            if f not in r:
                problems.append(f"record {i}: missing field {f!r}")
        v = r.get("value")
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            problems.append(f"record {i}: non-numeric value {v!r}")
        if r.get("type") == "measurement" and "ratio" in r:
            pred = r.get("predicted")
            if not isinstance(pred, (int, float)) or pred == 0:
                problems.append(f"record {i}: ratio without predicted")
            elif abs(r["ratio"] - r["value"] / pred) > 1e-9 * \
                    max(1.0, abs(r["ratio"])):
                problems.append(f"record {i}: ratio != value/predicted")
    return problems


def join(records: List[dict]) -> List[dict]:
    """Re-join predictions and measurements from a JSONL stream (for
    streams written before a crash, or by emitters that never paired).
    In-stream order per (model, key): each measurement joins the latest
    preceding prediction.  Measurements already carrying ``ratio`` pass
    through unchanged."""
    pending: Dict[Tuple[str, str], float] = {}
    out = []
    for r in records:
        t = r.get("type")
        if t == "prediction":
            try:
                pending[(r["model"], r["key"])] = float(r["value"])
            except (KeyError, TypeError, ValueError):
                # roclint: allow(silent-swallow) — malformed record never pairs
                pass
        elif t == "measurement":
            if "ratio" in r:
                out.append(r)
                continue
            r = dict(r)
            pred = pending.get((r.get("model"), r.get("key")))
            if pred not in (None, 0.0):
                r["predicted"] = pred
                r["ratio"] = float(r["value"]) / pred
            out.append(r)
    return out


def calibration_report(records: List[dict]) -> dict:
    """Per-model calibration summary over a JSONL stream:

    ``{model: {pairs, ratio_mean, ratio_min, ratio_max, units}}`` plus
    ``unpaired_predictions`` / ``unpaired_measurements`` counts — the
    structure `python -m roc_tpu_torch.obs calibration` renders and the
    calibration selftest asserts over."""
    joined = join(records)
    models: Dict[str, dict] = {}
    unpaired_m = 0
    for r in joined:
        if "ratio" not in r:
            unpaired_m += 1
            continue
        m = models.setdefault(r["model"], {
            "pairs": 0, "ratios": [], "units": r.get("units", "")})
        m["pairs"] += 1
        m["ratios"].append(float(r["ratio"]))
    preds = sum(1 for r in records if r.get("type") == "prediction")
    paired_keys = set()
    for r in joined:
        if "ratio" in r:
            paired_keys.add((r.get("model"), r.get("key")))
    unpaired_p = sum(
        1 for r in records if r.get("type") == "prediction"
        and (r.get("model"), r.get("key")) not in paired_keys)
    for m in models.values():
        rs = m.pop("ratios")
        m["ratio_mean"] = sum(rs) / len(rs)
        m["ratio_min"] = min(rs)
        m["ratio_max"] = max(rs)
    return {"models": models, "predictions": preds,
            "unpaired_predictions": unpaired_p,
            "unpaired_measurements": unpaired_m}
