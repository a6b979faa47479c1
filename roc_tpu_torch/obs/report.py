"""Render a ``-obs`` run's trace and metrics into a text summary, and the
obs layer's selftests (roc_tpu/obs/report.py).

``python -m roc_tpu_torch.obs report -dir roc_obs`` reads the two
artifacts a ``-obs`` run writes (trace.json, metrics.jsonl) and prints
per-span-type aggregates, the epoch and loss trajectory, any watchdog
alerts and the calibration table.  ``selftest`` is the obs gate: tracer
schema, watchdog fire and quiet, the span overhead bound, standard
library only.  ``calibration --selftest`` runs the port's cost-model
producers on tiny inputs and checks the ledger pairs them.
"""

from __future__ import annotations

import json
from typing import List

from roc_tpu_torch.obs.ledger import calibration_report, validate_records
from roc_tpu_torch.obs.metrics import load_jsonl
from roc_tpu_torch.obs.tracer import SpanTracer, validate_chrome_trace
from roc_tpu_torch.obs.watchdog import PerfWatchdog

# Gate of the selftest's overhead check.  A disabled span is two
# perf_counter_ns calls and a list push and pop; an enabled one adds a ring
# append.  50 us a span is ~100x that: the gate catches a pathological
# regression (lock contention, accidental I/O), not jitter.
MAX_SPAN_OVERHEAD_S = 50e-6


def summarize_trace(trace: dict) -> List[str]:
    by_name: dict = {}
    for ev in trace.get("traceEvents", []):
        st = by_name.setdefault(ev.get("name", "?"),
                                {"count": 0, "total_us": 0.0, "max_us": 0.0})
        st["count"] += 1
        dur = float(ev.get("dur", 0.0))
        st["total_us"] += dur
        st["max_us"] = max(st["max_us"], dur)
    lines = [f"# spans ({len(by_name)} types)"]
    for name, st in sorted(by_name.items(), key=lambda kv: -kv[1]["total_us"]):
        mean = st["total_us"] / st["count"]
        lines.append(f"#   {name:<16} x{st['count']:<5} "
                     f"total {st['total_us'] / 1e3:9.2f} ms  "
                     f"mean {mean / 1e3:8.3f} ms  "
                     f"max {st['max_us'] / 1e3:8.3f} ms")
    return lines


def _alert_detail(a: dict) -> str:
    """Generic one-line rendering of a watchdog alert's numeric fields —
    no per-kind template, so a new alert kind (stream-stall,
    calibration-drift, whatever comes next) renders correctly instead of
    falling into a slow-epoch-shaped else branch."""
    parts = []
    for k in sorted(a):
        v = a[k]
        if k in ("kind", "epoch") or isinstance(v, bool) \
                or not isinstance(v, (int, float)):
            continue
        parts.append(f"{k}={v:.4g}")
    return ", ".join(parts)


def summarize_metrics(records: List[dict]) -> List[str]:
    epochs = [r for r in records if r.get("type") == "metrics"]
    alerts = [r for r in records if r.get("type") == "watchdog"]
    trains = [r for r in records if r.get("type") == "train"]
    lines: List[str] = []
    # record-type census first, fully generic: every "type" in the stream
    # counts, including kinds this renderer knows nothing about
    by_type: dict = {}
    for r in records:
        t = str(r.get("type", "?"))
        by_type[t] = by_type.get(t, 0) + 1
    if by_type:
        lines.append("# records: " + ", ".join(
            f"{t} x{n}" for t, n in sorted(by_type.items())))
    if epochs:
        walls = [r["wall_s"] for r in epochs if "wall_s" in r]
        med = sorted(walls)[len(walls) // 2] if walls else 0.0
        lines.append(f"# metrics: {len(epochs)} epochs, "
                     f"median {med * 1e3:.1f} ms/epoch")
        last = epochs[-1]
        for key in ("loss", "grad_norm", "param_norm", "wire_bytes",
                    "mfu", "roofline_frac"):
            if key in last:
                lines.append(f"#   final {key} = {last[key]:.6g}")
    for r in trains:
        lines.append(f"#   verdict: {r.get('watchdog_verdict', '?')} "
                     f"({r.get('epochs', '?')} epochs, "
                     f"total {r.get('total_s', 0):.2f}s)")
    if alerts:
        lines.append(f"# watchdog alerts ({len(alerts)}):")
        for a in alerts:
            lines.append(f"#   {a.get('kind', '?')} @ epoch "
                         f"{a.get('epoch', '?')}: {_alert_detail(a)}")
    elif epochs or trains:
        lines.append("# watchdog: no alerts")
    if any(r.get("type") in ("prediction", "measurement") for r in records):
        lines.extend(summarize_calibration(records))
    return lines


def summarize_calibration(records: List[dict]) -> List[str]:
    """Per-cost-model calibration table over a stream's ledger records
    (the body of ``python -m roc_tpu_torch.obs calibration``)."""
    problems = validate_records(records)
    rep = calibration_report(records)
    lines = [f"# calibration: {len(rep['models'])} paired model(s), "
             f"{rep['predictions']} predictions "
             f"({rep['unpaired_predictions']} unpaired), "
             f"{rep['unpaired_measurements']} unpaired measurement(s)"]
    for name in sorted(rep["models"]):
        m = rep["models"][name]
        lines.append(f"#   {name:<14} x{m['pairs']:<4} "
                     f"ratio mean {m['ratio_mean']:.4g}  "
                     f"[{m['ratio_min']:.4g}, {m['ratio_max']:.4g}]  "
                     f"({m['units']})")
    if problems:
        lines.append(f"# calibration: {len(problems)} schema problem(s): "
                     f"{problems[0]}")
    return lines


def report(trace_path: str = "", metrics_path: str = "") -> str:
    lines: List[str] = []
    if trace_path:
        try:
            with open(trace_path, encoding="utf-8") as f:
                trace = json.load(f)
        except (OSError, ValueError) as e:
            lines.append(f"# trace: unreadable ({e})")
        else:
            problems = validate_chrome_trace(trace)
            if problems:
                lines.append(f"# trace: {len(problems)} schema problem(s): "
                             f"{problems[0]}")
            lines.extend(summarize_trace(trace))
    if metrics_path:
        records = load_jsonl(metrics_path)
        if records:
            lines.extend(summarize_metrics(records))
        else:
            lines.append(f"# metrics: no records at {metrics_path}")
    return "\n".join(lines) if lines else "# nothing to report"


# -- calibration (the ledger's CLI and selftest) -----------------------------

CALIB_MIN_MODELS = 5
# Sanity bands (measured/predicted mean ratio) for the models a run on any
# device can check: roc_tpu's bands for the two the port produces.
# roc_tpu's plan_steps (0.999, 1.001), staging_rows (0.999, 1.001) and
# arg_bytes (0.9, 1.1) have no producer in the port (no binned plan, no
# XLA buffer accounting).  The time models (step_time, stream_xfer_s,
# delta-apply, serve-p50) are reported, never judged: their constants
# describe the card, not the device a selftest runs on.
CALIB_BOUNDS = {
    "wire_bytes": (0.99, 1.01),
    "overlap_frac": (0.02, 1.5),
}


def calibration(metrics_path: str, out=print) -> int:
    """``python -m roc_tpu_torch.obs calibration``: join and report a
    stream's ledger records.  0 = schema-valid records found, 1 = schema
    problems, 2 = no ledger records at all."""
    records = load_jsonl(metrics_path)
    if not any(r.get("type") in ("prediction", "measurement")
               for r in records):
        out(f"# no ledger records at {metrics_path!r} "
            "(run with -obs / ROC_OBS=1 first)")
        return 2
    for line in summarize_calibration(records):
        out(line)
    return 1 if validate_records(records) else 0


def calibration_selftest(device: str = "cuda", out=print) -> int:
    """The calibration gate: a 3-epoch trainer (``step_time``), a 3-epoch
    streamed run (``wire_bytes``, ``overlap_frac``, ``stream_xfer_s``) and
    a tiny served engine with a few deltas (``delta-apply``,
    ``serve-p50``) must pair >= CALIB_MIN_MODELS cost models in one
    schema-valid stream, each judged model inside its CALIB_BOUNDS."""
    import os
    import tempfile
    import warnings

    import numpy as np

    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.models import build_gcn
    from roc_tpu_torch.obs.ledger import get_ledger
    from roc_tpu_torch.obs.metrics import MetricsRegistry
    from roc_tpu_torch.serve.engine import ServeEngine
    from roc_tpu_torch.stream.executor import StreamTrainer
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.driver import Trainer

    failures: List[str] = []
    quiet = lambda *a, **k: None  # noqa: E731
    with tempfile.TemporaryDirectory(prefix="roc_torch_calib_") as td:
        jsonl = os.path.join(td, "metrics.jsonl")
        ds = datasets.synthetic("calib", 120, 4.0, 8, 3, n_train=30,
                                n_val=30, n_test=30, seed=7)
        model = build_gcn([8, 8, 3], 0.0)
        # (a) the in-core trainer: step_time and peak_memory predictions,
        # the epoch's wall (and on the card its peak) measured
        cfg = Config(layers=[8, 8, 3], num_epochs=3, eval_every=1000,
                     dropout_rate=0.0, obs=True, obs_dir=td, device=device)
        Trainer(cfg, ds, model).train(print_fn=quiet)
        # (b) the stream executor: wire bytes, ring overlap, transfer s.
        # At 120 nodes a shard's compute is too short for the prefetch to
        # hide anything (the CPU's overlap swings 0-0.4 run to run); at
        # 2,000 nodes and 64 hidden columns it measures 0.4-0.6
        sds = datasets.synthetic("calib-stream", 2000, 4.0, 8, 3,
                                 n_train=500, n_val=500, n_test=500, seed=7)
        scfg = Config(layers=[8, 64, 3], num_epochs=3, num_parts=2,
                      stream=True, stream_slots=2, eval_every=1000,
                      dropout_rate=0.0, obs=True, obs_dir=td, device=device)
        StreamTrainer(scfg, sds, build_gcn(scfg.layers, 0.0)).train(
            print_fn=quiet)
        # (c) a served engine under deltas: delta-apply per batch, and
        # serve-p50 every _P99_FEED_WINDOWS windows
        led = get_ledger()
        reg = MetricsRegistry(jsonl_path=jsonl)
        led.attach(reg.emit)
        try:
            ecfg = Config(layers=[8, 8, 3], aggregate_backend="binned",
                          serve_batch=4, serve_wait_ms=0.5, device=device)
            rng = np.random.default_rng(0)
            n = ds.graph.num_nodes
            with ServeEngine(ecfg, ds, model, delta_journal="",
                             device=device) as eng, \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for _ in range(5):
                    eng.apply_delta(rng.integers(0, n, (4, 2)), None)
                for _ in range(24):
                    eng.query(rng.integers(0, n, 2), timeout=60.0)
        finally:
            led.detach()
        records = load_jsonl(jsonl)

    problems = validate_records(records)
    if problems:
        failures.append(f"{len(problems)} schema problem(s): {problems[0]}")
    rep = calibration_report(records)
    models = rep["models"]
    if len(models) < CALIB_MIN_MODELS:
        failures.append(f"only {len(models)} paired cost model(s) "
                        f"({sorted(models)}), need {CALIB_MIN_MODELS}")
    for name, (lo, hi) in CALIB_BOUNDS.items():
        m = models.get(name)
        if m and not (lo <= m["ratio_mean"] <= hi):
            failures.append(f"{name} mean ratio {m['ratio_mean']:.4g} "
                            f"outside [{lo}, {hi}]")
    if failures:
        for f_ in failures:
            out(f"calibration selftest FAIL: {f_}")
        return 1
    out(f"calibration selftest ok ({len(models)} paired models: "
        + ", ".join(f"{n} @ {models[n]['ratio_mean']:.3g}"
                    for n in sorted(models)) + ")")
    return 0


# -- selftest (the obs gate) --------------------------------------------------

def selftest(out=print) -> int:
    """0 when the obs layer holds its own contracts; 1 with a reason."""
    failures: List[str] = []

    # 1. tracer: nesting depths + Perfetto-loadable export
    tr = SpanTracer(capacity=64)
    tr.enabled = True
    with tr.span("outer", case="selftest"):
        with tr.span("inner"):
            pass
    spans = {s.name: s for s in tr.spans()}
    if set(spans) != {"outer", "inner"}:
        failures.append(f"tracer recorded {sorted(spans)}, "
                        "expected inner+outer")
    elif not (spans["inner"].depth == 1 and spans["outer"].depth == 0):
        failures.append("span nesting depths wrong")
    problems = validate_chrome_trace(tr.to_chrome_trace())
    if problems:
        failures.append(f"chrome-trace schema: {problems[0]}")
    try:
        json.dumps(tr.to_chrome_trace())
    except TypeError as e:
        failures.append(f"trace not JSON-serializable: {e}")

    # 2. watchdog: fires on an injected 3x epoch, quiet on a clean run
    wd = PerfWatchdog()
    for epoch in range(5):
        if wd.observe_epoch(epoch, 0.1) is not None:
            failures.append("watchdog fired on a clean warmup")
            break
    if wd.observe_epoch(5, 0.3) is None:
        failures.append("watchdog missed an injected 3x slow epoch")
    clean = PerfWatchdog()
    noise = [0.1, 0.102, 0.098, 0.101, 0.099, 0.103, 0.097]
    if any(clean.observe_epoch(i, t) for i, t in enumerate(noise)):
        failures.append("watchdog fired on +-3% noise")

    # 3. overhead: disabled spans (the always-on steady state) stay cheap
    tr2 = SpanTracer()
    reps = 2000
    with tr2.span("gate") as gate:   # obs times itself — no raw clocks
        for _ in range(reps):
            with tr2.span("probe"):
                pass
    per_span = gate.dur_s / reps
    if per_span > MAX_SPAN_OVERHEAD_S:
        failures.append(f"span overhead {per_span * 1e6:.1f} us > "
                        f"{MAX_SPAN_OVERHEAD_S * 1e6:.0f} us")

    if failures:
        for f_ in failures:
            out(f"obs selftest FAIL: {f_}")
        return 1
    out(f"obs selftest ok (span overhead {per_span * 1e6:.2f} us, "
        f"watchdog fire/quiet verified, trace schema valid)")
    return 0
