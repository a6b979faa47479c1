"""The port's host tracer on torch.profiler's clock (roc_tpu_torch/obs/
tracer.py), the spans of the serving queue, the delta apply and the
collector, and the benchmark's readers of them (perfbench/metrics/).

Clock: a span mirrored into a CPU profiler session and the same span in
the ring's Chrome export start within 1 ms of each other, on the OS
thread's row.  Queue: a stub serve function's worker records
``queue_idle``, ``queue_fill`` (``late_us`` on a deadline drain only) and
``queue_resolve``, and one ``request_queued`` a request, from its submit
to its drain.  Deltas: ``delta_batch`` holds every step of an apply, a
held plan lock shows as ``delta_lock_wait`` inside ``delta_install``, and
a lock whose taking raises still closes that span."""

import gc
import json
import os
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import spec
from roc_tpu_torch import obs
from roc_tpu_torch.graph.csr import from_edges
from roc_tpu_torch.obs import tracer as tracer_mod
from roc_tpu_torch.obs.tracer import SpanTracer
from roc_tpu_torch.serve.delta import DeltaManager
from roc_tpu_torch.serve.queue import MicrobatchQueue
from roc_tpu_torch.train.graph_data import dense_graph_data

ROOT = Path(__file__).resolve().parents[1]
CPU_ACTS = [torch.profiler.ProfilerActivity.CPU]
MS = 1_000_000   # ns


@pytest.fixture(autouse=True)
def _global_ring_as_found():
    """Tests here fill the process's ring; empty it and put the switch
    back."""
    was = obs.enabled()
    obs.get_tracer().clear()
    yield
    obs.enable(was)
    obs.get_tracer().clear()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _warm_profiler():
    """A process's first profiler session and first ``record_function``
    pay one-time set-up that is not the clock's: spend it before timing."""
    with torch.profiler.profile(activities=CPU_ACTS):
        with torch.profiler.record_function("warm"):
            pass


def _within(outer, inner) -> bool:
    return outer.start_ns <= inner.start_ns and \
        inner.start_ns + inner.dur_ns <= outer.start_ns + outer.dur_ns


# -- the clock ------------------------------------------------------------------

def test_mirrored_span_starts_where_the_ring_exports_it():
    _warm_profiler()
    tr = SpanTracer()
    tr.enabled = True
    with torch.profiler.profile(activities=CPU_ACTS) as prof:
        with tr.span("mirrored", case=1):
            torch.ones(64).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "mirrored"]
    assert len(events) == 1
    trace = tr.to_chrome_trace()
    base = trace["baseTimeNanoseconds"]
    assert base == tracer_mod.profiler_base_ns()
    (mine,) = _named_events(trace, "mirrored")
    assert abs((events[0].start_ns() - base) / 1e3 - mine["ts"]) < 1000.0
    assert mine["tid"] == threading.get_native_id()


def _named_events(trace, name):
    return [e for e in trace["traceEvents"] if e.get("name") == name]


def test_export_agrees_with_the_profilers_own(tmp_path):
    _warm_profiler()
    tr = SpanTracer()
    tr.enabled = True
    with torch.profiler.profile(activities=CPU_ACTS) as prof:
        with tr.span("interval"):
            time.sleep(0.005)
    prof.export_chrome_trace(str(tmp_path / "profile.json"))
    assert tr.write_chrome_trace(str(tmp_path / "obs.json"))
    theirs = json.loads((tmp_path / "profile.json").read_text())
    ours = json.loads((tmp_path / "obs.json").read_text())
    (t,) = _named_events(theirs, "interval")
    (m,) = _named_events(ours, "interval")
    assert ours["baseTimeNanoseconds"] == theirs["baseTimeNanoseconds"]
    assert abs(m["ts"] - t["ts"]) < 1000.0
    assert abs(m["dur"] - t["dur"]) < 1000.0
    assert (m["pid"], m["tid"]) == (t["pid"], t["tid"])


_OFF_PATH = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("t", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
tr = mod.SpanTracer()
with tr.span("quiet"):
    pass
print(len(tr.spans()), "torch" in sys.modules)
"""


def test_disabled_span_without_a_profiler_records_nothing():
    tr = SpanTracer()
    assert not tracer_mod._profiling()
    with tr.span("quiet") as sp:
        assert sp._rf is None
    tr.record("stamped", time.perf_counter_ns(), 10)
    assert sp.dur_ns > 0 and tr.spans() == []
    # the off path reads a flag and imports nothing
    out = subprocess.run(
        [sys.executable, "-c", _OFF_PATH,
         str(ROOT / "roc_tpu_torch" / "obs" / "tracer.py")],
        capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == ["0", "False"]


# -- the serving queue ----------------------------------------------------------

def test_queue_records_the_workers_timeline_and_each_wait():
    def serve(ids):
        time.sleep(0.002)
        return np.zeros((ids.size, 2), np.float32)

    obs.enable(True)
    q = MicrobatchQueue(serve, batch=4, wait_ms=5.0)
    try:
        time.sleep(0.03)
        futs = [q.submit([1])]            # under the batch: its wait runs out
        futs[0].result(10)
        time.sleep(0.03)
        futs.append(q.submit([1, 2, 3, 4]))   # a full batch drains at once
        futs[1].result(10)
    finally:
        q.close()
        obs.enable(False)
    spans = obs.get_tracer().spans()
    assert _named(spans, "queue_idle")
    fills = _named(spans, "queue_fill")
    resolves = _named(spans, "queue_resolve")
    queued = _named(spans, "request_queued")
    assert len(fills) == len(resolves) == len(queued) == 2
    assert fills[0].args["late_us"] >= 0.0
    assert "late_us" not in (fills[1].args or {})
    assert [r.args["requests"] for r in resolves] == [1, 1]
    for s, f, fill in zip(queued, futs, fills):
        assert f.t_submit <= f.t_drain <= f.t_done
        assert abs(s.start_ns - f.t_submit * 1e9) < 1000
        assert abs(s.dur_ns - (f.t_drain - f.t_submit) * 1e9) < 1000
        # taken into the window at its drain, inside the fill
        assert fill.start_ns <= s.start_ns + s.dur_ns <= \
            fill.start_ns + fill.dur_ns


# -- the delta apply ------------------------------------------------------------

class _SignallingLock:
    """A re-entrant lock that says when another thread starts to wait."""

    def __init__(self):
        self._lock = threading.RLock()
        self.holder = None
        self.contended = threading.Event()

    def __enter__(self):
        if self.holder is not None and \
                threading.current_thread() is not self.holder:
            self.contended.set()
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


def _manager(lock):
    rng = np.random.default_rng(3)
    csr = from_edges(96, rng.integers(0, 64, 200), rng.integers(0, 64, 200))
    holder = {"gd": dense_graph_data(csr, "kernel", "exact",
                                     torch.device("cpu"), transpose=False)}
    return DeltaManager(lambda: holder["gd"],
                        lambda g: holder.__setitem__("gd", g), lock,
                        csr.num_nodes, journal_path=None)


def _apply(mgr, add):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return mgr.apply(np.asarray(add), None)


def test_delta_apply_spans_nest_and_a_held_lock_is_its_wait():
    lock = _SignallingLock()
    mgr = _manager(lock)
    obs.enable(True)
    try:
        _apply(mgr, [[64, 70]])
        spans = obs.get_tracer().spans()
        (batch,) = _named(spans, "delta_batch")
        assert batch.args == {"adds": 1, "retires": 0, "mode": "applied"}
        parts = {n: _named(spans, n)[0] for n in (
            "delta_classify", "delta_journal", "delta_apply", "delta_commit",
            "delta_rewrite", "delta_install", "delta_lock_wait")}
        for n in ("delta_classify", "delta_journal", "delta_apply"):
            assert _within(batch, parts[n]), n
        for n in ("delta_commit", "delta_rewrite", "delta_install"):
            assert _within(parts["delta_apply"], parts[n]), n
        assert _within(parts["delta_install"], parts["delta_lock_wait"])
        # the four keys delta_patch_ms sums keep their spans; the new two
        # are theirs too, the lock's wait a part of the install
        lp = mgr.last_patch
        for key, name in (("classify_s", "delta_classify"),
                          ("journal_s", "delta_journal"),
                          ("rewrite_s", "delta_rewrite"),
                          ("install_s", "delta_install"),
                          ("commit_s", "delta_commit"),
                          ("lock_wait_s", "delta_lock_wait")):
            assert lp[key] == parts[name].dur_s, key
        assert lp["install_s"] >= lp["lock_wait_s"]

        holding = threading.Event()

        def hold():
            # held for 50 ms from when the install starts to wait
            with lock:
                holding.set()
                lock.contended.wait(10)
                time.sleep(0.05)

        lock.holder = threading.Thread(target=hold)
        lock.holder.start()
        assert holding.wait(10)
        _apply(mgr, [[65, 71]])
        lock.holder.join(10)
        assert not lock.holder.is_alive()
        assert mgr.last_patch["lock_wait_s"] >= 0.045
        assert mgr.last_patch["install_s"] >= mgr.last_patch["lock_wait_s"]
    finally:
        obs.enable(False)
        mgr.close()



class _FailingLock:
    """A lock whose taking raises once ``fail`` is set."""

    def __init__(self):
        self._lock = threading.RLock()
        self.fail = False

    def __enter__(self):
        if self.fail:
            raise RuntimeError("the plan lock could not be taken")
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


def test_delta_lock_wait_closes_when_taking_the_lock_raises():
    """The wait's span closes, and is recorded inside the install's, when
    taking the plan lock raises: no span is left open on the thread."""
    lock = _FailingLock()
    mgr = _manager(lock)
    obs.enable(True)
    try:
        lock.fail = True
        with pytest.raises(RuntimeError, match="could not be taken"):
            _apply(mgr, [[64, 70]])
        spans = obs.get_tracer().spans()
        (wait,) = _named(spans, "delta_lock_wait")
        (install,) = _named(spans, "delta_install")
        assert _within(install, wait)
        assert obs.get_tracer()._stack() == []
    finally:
        obs.enable(False)
        lock.fail = False
        mgr.close()

# -- the collector --------------------------------------------------------------

def test_gc_hook_records_collections_only_while_enabled():
    tr = SpanTracer()
    tr.set_enabled(True)
    try:
        assert tr._on_gc in gc.callbacks
        gc.collect()
        got = _named(tr.spans(), "gc")
        assert got and got[-1].args["generation"] == 2
        assert got[-1].args["collected"] >= 0 and got[-1].dur_ns > 0
    finally:
        tr.set_enabled(False)
    assert tr._on_gc not in gc.callbacks
    n = len(tr.spans())
    gc.collect()
    assert len(tr.spans()) == n


# -- the benchmark's readers ----------------------------------------------------

def _ring(*spans):
    """The process's ring, filled by hand: (name, start ms, dur ms, args)."""
    tr = obs.get_tracer()
    tr.enabled = True
    for name, start, dur, args in spans:
        tr.record(name, int(start * MS), int(dur * MS), **args)
    tr.enabled = False


_RINGS = {
    "queue_wait_ms.serve": (
        [("request_queued", 0, d, {}) for d in (1, 2, 3, 10)], 2.5),
    "wake_late_ms.serve": (
        [("queue_fill", 0, 2, {"late_us": 100.0}),
         ("queue_fill", 5, 1, {}),
         ("queue_fill", 9, 3, {"late_us": 300.0})], 0.2),
    # served from 100 to 900 ms of a 1 s window; idle 50 + 100 + 50 ms
    # inside it
    "worker_wait_pct.serve": (
        [("queue_idle", 0, 150, {}), ("request_queued", 100, 1, {}),
         ("queue_idle", 400, 100, {}), ("queue_resolve", 890, 10, {}),
         ("queue_idle", 850, 150, {})], 20.0),
    "delta_apply_ms": (
        [("delta_batch", 0, d, {}) for d in (4, 20, 6)], 6.0),
    "delta_lock_wait_ms": (
        [("delta_lock_wait", 0, d, {}) for d in (1, 2)], 1.5),
}


@pytest.mark.parametrize("name", sorted(_RINGS))
def test_span_reader_reads_its_spans_and_none_without_them(name):
    read = spec.metric_reader(name)
    run = {"kind": "serve", "trace": {"window_s": 1.0}}
    spans, want = _RINGS[name]
    assert read(run) is None
    _ring(("serve_window", 0, 7, {}))       # a span of another name
    assert read(run) is None
    _ring(*spans)
    assert read(run) == pytest.approx(want, rel=1e-9)
    assert read({"kind": "train", "trace": {"window_s": 1.0}}) is None
