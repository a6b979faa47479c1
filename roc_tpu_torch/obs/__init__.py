"""Runtime observability (roc_tpu/obs): span tracer, per-epoch metrics,
watchdog.

  tracer.py    host-side span ring and its Chrome trace-event export
  channel.py   the norms the per-epoch metrics record carries
  metrics.py   the metrics registry: JSONL stream, Prometheus textfile
  watchdog.py  EWMA slow-epoch detector, the non-finite step feed and
               the streaming executor's stall feeds
  roofline.py  the card's peaks and an epoch's FLOPs and bytes

Entry points: ``with obs.span("phase"): ...`` anywhere on the host;
``-obs`` / ``ROC_OBS=1`` to record and export; the trainer wires the
rest.  roc_tpu's calibration ledger and report CLI are not ported yet
(ROADMAP queue A).
"""

from roc_tpu_torch.obs.metrics import MetricsRegistry, load_jsonl
from roc_tpu_torch.obs.tracer import (SpanTracer, enable, enabled,
                                      get_tracer, span,
                                      validate_chrome_trace)
from roc_tpu_torch.obs.watchdog import PerfWatchdog

__all__ = ["MetricsRegistry", "PerfWatchdog", "SpanTracer", "enable",
           "enabled", "get_tracer", "load_jsonl", "span",
           "validate_chrome_trace"]
