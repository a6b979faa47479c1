"""Metrics registry and exporters (roc_tpu/obs/metrics.py): one stream of
``{"type": <kind>, **fields}`` records.

Every record goes to a best-effort JSONL file (the schema roc_tpu's
balance telemetry shares, so both packages' ``metrics.jsonl`` read the
same way) and to the latest-scalar table that ``write_prometheus``
renders as a Prometheus textfile.  The calibration ledger emits its
records through a registry's ``emit``.  roc_tpu's in-memory tail, series
readers and labeled gauges serve its bench, which is not ported.
"""

from __future__ import annotations

import json
import math
import os
from typing import List


class MetricsRegistry:
    """Named-record sink over the shared JSONL schema."""

    def __init__(self, jsonl_path: str = ""):
        self.jsonl_path = jsonl_path
        self.latest: dict = {}  # the latest scalar per "<kind>_<field>"

    def emit(self, kind: str, /, **fields):
        """One record: a JSONL line and the latest scalars.  ``kind`` is
        positional-only: watchdog alerts carry a "kind" field of their
        own."""
        if self.jsonl_path:
            try:
                with open(self.jsonl_path, "a", encoding="utf-8") as f:
                    f.write(json.dumps({"type": kind, **fields}) + "\n")
            except OSError:
                # roclint: allow(silent-swallow) the metrics stream must never take down the run
                pass    # the metrics stream must never take down the run
        for k, v in fields.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.latest[f"{kind}_{k}"] = float(v)

    def write_prometheus(self, path: str) -> bool:
        """Latest scalar per series as a Prometheus textfile; best-effort.
        Non-finite values are skipped."""
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            lines = []
            for name in sorted(self.latest):
                v = self.latest[name]
                if math.isfinite(v):
                    lines.append(f"{_metric_name(name)} {v:.10g}")
            with open(path, "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
            return True
        except OSError:
            return False


def _metric_name(name: str) -> str:
    """Sanitize to the Prometheus name charset [a-zA-Z_][a-zA-Z0-9_]*."""
    return "roc_" + "".join(c if c.isalnum() or c == "_" else "_"
                            for c in name)


def load_jsonl(path: str) -> List[dict]:
    """Read a metrics JSONL stream, skipping unparseable lines (a crashed
    run may leave a torn last line) and returning [] for a missing file."""
    out: List[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    # roclint: allow(silent-swallow) a torn JSONL tail after a crash holds no record
                    continue
    except OSError:
        # roclint: allow(silent-swallow) an absent stream holds no records
        pass
    return out
