"""Runtime observability (roc_tpu/obs): span tracer, per-epoch metrics,
watchdog, calibration ledger.

  tracer.py    host-side span ring and its Chrome trace-event export
  channel.py   the norms the per-epoch metrics record carries
  metrics.py   the metrics registry: JSONL stream, Prometheus textfile
  watchdog.py  EWMA slow-epoch detector, the non-finite step feed, the
               streaming executor's stall feeds, the serving feeds (p99,
               delta apply, fleet lag) and the calibration EWMAs
  roofline.py  the card's peaks and an epoch's FLOPs and bytes
  ledger.py    calibration ledger: content-keyed prediction/measurement
               records, joined by ``python -m roc_tpu_torch.obs
               calibration``
  report.py    ``python -m roc_tpu_torch.obs report``, the selftests

Entry points: ``with obs.span("phase"): ...`` anywhere on the host;
``-obs`` / ``ROC_OBS=1`` to record and export; the trainer wires the
rest.
"""

from roc_tpu_torch.obs.ledger import CalibrationLedger, get_ledger
from roc_tpu_torch.obs.metrics import MetricsRegistry, load_jsonl
from roc_tpu_torch.obs.tracer import (SpanTracer, enable, enabled,
                                      get_tracer, span,
                                      validate_chrome_trace)
from roc_tpu_torch.obs.watchdog import PerfWatchdog

__all__ = ["CalibrationLedger", "MetricsRegistry", "PerfWatchdog",
           "SpanTracer", "enable", "enabled", "get_ledger", "get_tracer",
           "load_jsonl", "span", "validate_chrome_trace"]
