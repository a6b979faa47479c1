"""Host-side span tracer: a ring of closed spans, monotonic clocks, Chrome
trace export (roc_tpu/obs/tracer.py).

    with obs.span("epoch", epoch=3) as sp:
        ...
    wall = sp.dur_s

A span always measures (the driver's epoch times are span durations,
tracing on or off); it is recorded into the ring only when tracing is
enabled: ``ROC_OBS=1`` in the environment, ``-obs`` on the CLI, or
``enable()``.  A disabled span costs two ``perf_counter_ns`` calls, a
list append and pop, and a read of torch.profiler's recording flag.

While a torch profiler records, every span also opens and closes a
``record_function`` of its name, ring on or off, so the span lies in the
profiler's trace on its own clock and thread: it names what the host did
in the device trace's gaps.  ``record()`` adds a span whose ends were
stamped elsewhere (a request's wait in the queue), into the ring only.
While the ring is on, a ``gc.callbacks`` hook records each pass of the
garbage collector as a ``gc`` span (mirrored into a recording profiler
too).

Export is Chrome trace-event JSON (``{"traceEvents": [{"ph": "X", ...}]}``,
timestamps and durations in microseconds), which Perfetto and
chrome://tracing load.  ``ts`` is on the clock of torch.profiler's own
``export_chrome_trace`` (epoch microseconds less its
``baseTimeNanoseconds``) and ``tid`` the OS thread id, so the ``-obs``
trace overlays the ``-profile`` trace of the same run.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import threading
import time
import warnings
from collections import deque
from typing import List, Optional, Set

DEFAULT_CAPACITY = 65536  # spans kept; old ones fall off the ring

# perf_counter_ns + _EPOCH_NS = time_ns, sampled once: the ring keeps the
# monotonic clock (durations), the export moves it onto the epoch's
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()

_profiler_mod = None   # torch.autograd.profiler, once torch has loaded it
_base_ns = None        # torch.profiler's export base, once read


def _profiling() -> bool:
    """Whether a torch profiler is recording.  Imports nothing: with
    torch not loaded, no profiler can be on."""
    global _profiler_mod
    mod = _profiler_mod
    if mod is None:
        mod = _profiler_mod = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
    return mod._is_profiler_enabled


def _mirror(name: str):
    """An open ``record_function`` of ``name`` in the recording profiler."""
    rf = _profiler_mod.record_function(name)
    rf.__enter__()
    return rf


def profiler_base_ns() -> int:
    """The epoch nanosecond torch.profiler's ``export_chrome_trace``
    subtracts from every timestamp (its ``baseTimeNanoseconds``), read once
    from the export of an empty CPU session; 0 while a profiler records
    (none can be started) or without torch."""
    global _base_ns
    if _base_ns is not None:
        return _base_ns
    if _profiling():
        return 0
    try:
        import torch
    except ImportError:
        return 0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                pass
            p.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            _base_ns = int(json.load(f).get("baseTimeNanoseconds", 0))
    finally:
        os.unlink(path)
    return _base_ns


class Span:
    """One closed span.  ``start_ns`` is `time.perf_counter_ns` (monotonic,
    process-local — NOT wall time); ``tid`` the OS thread id
    (`threading.get_native_id`); ``depth`` is the nesting level within its
    thread at open time (0 = top level)."""

    __slots__ = ("name", "start_ns", "dur_ns", "tid", "depth", "args")

    def __init__(self, name: str, start_ns: int, dur_ns: int, tid: int,
                 depth: int, args: Optional[dict]):
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.depth = depth
        self.args = args

    @property
    def dur_s(self) -> float:
        return self.dur_ns / 1e9

    def to_event(self, base_ns: int = 0) -> dict:
        """Chrome trace-event "complete" ("X") event, microsecond units,
        ``ts`` from the epoch nanosecond ``base_ns``."""
        ev = {"ph": "X", "name": self.name, "cat": "roc",
              "ts": (self.start_ns + _EPOCH_NS - base_ns) / 1e3,
              "dur": self.dur_ns / 1e3, "pid": os.getpid(), "tid": self.tid}
        if self.args:
            ev["args"] = {k: _jsonable(v) for k, v in self.args.items()}
        return ev


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


class _SpanCtx:
    """Context manager for one span: measures on exit, records into the
    tracer's ring only when tracing is enabled at close time, and mirrors
    into a profiler recording at open time."""

    __slots__ = ("_tracer", "name", "args", "start_ns", "dur_ns", "depth",
                 "_rf")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.start_ns = 0
        self.dur_ns = 0
        self.depth = 0
        self._rf = None

    def __enter__(self) -> "_SpanCtx":
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if _profiling():
            self._rf = _mirror(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_ns = time.perf_counter_ns() - self.start_ns
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        t = self._tracer
        if t.enabled:
            t._ring.append(Span(self.name, self.start_ns, self.dur_ns,
                                t._tid(), self.depth, self.args or None))
        return False

    @property
    def dur_s(self) -> float:
        return self.dur_ns / 1e9


class SpanTracer:
    """Ring buffer of closed spans + per-thread open-span stacks."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self._ring: deque = deque(maxlen=capacity)
        self._tls = threading.local()
        self._gc_start = 0
        self._gc_rf = None

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _tid(self) -> int:
        """This thread's OS id, read once: `threading.get_native_id` makes
        a system call each time."""
        tid = getattr(self._tls, "tid", None)
        if tid is None:
            tid = self._tls.tid = threading.get_native_id()
        return tid

    def span(self, name: str, **args) -> _SpanCtx:
        return _SpanCtx(self, name, args)

    def record(self, name: str, start_ns: int, dur_ns: int, **args):
        """Record a span stamped elsewhere (``start_ns`` on
        `time.perf_counter_ns`) on this thread, into the ring only."""
        if self.enabled:
            self._ring.append(Span(name, int(start_ns), int(dur_ns),
                                   self._tid(), len(self._stack()),
                                   args or None))

    def set_enabled(self, on: bool):
        """Turn the ring on or off, and with it the collector's hook."""
        self.enabled = bool(on)
        hooked = self._on_gc in gc.callbacks
        if self.enabled and not hooked:
            gc.callbacks.append(self._on_gc)
        elif not self.enabled and hooked:
            gc.callbacks.remove(self._on_gc)

    def _on_gc(self, phase: str, info: dict):
        """``gc.callbacks`` hook: one ``gc`` span a collection."""
        if phase == "start":
            self._gc_start = time.perf_counter_ns()
            if _profiling():
                self._gc_rf = _mirror("gc")
            return
        end = time.perf_counter_ns()
        if self._gc_rf is not None:
            self._gc_rf.__exit__(None, None, None)
            self._gc_rf = None
        self.record("gc", self._gc_start, end - self._gc_start,
                    generation=info.get("generation"),
                    collected=info.get("collected"))

    def spans(self) -> List[Span]:
        return list(self._ring)

    def span_types(self) -> Set[str]:
        return {s.name for s in self.spans()}

    def clear(self):
        self._ring.clear()

    def to_chrome_trace(self) -> dict:
        base = profiler_base_ns()
        # a snapshot: the collector's hook and other threads append while
        # the events are built
        return {"traceEvents": [s.to_event(base) for s in self.spans()],
                "displayTimeUnit": "ms", "baseTimeNanoseconds": base}

    def write_chrome_trace(self, path: str) -> bool:
        """Best-effort write (observability must never kill a run)."""
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(self.to_chrome_trace(), f)
                f.write("\n")
            return True
        except OSError:
            return False


def validate_chrome_trace(obj) -> List[str]:
    """Schema problems in a Chrome trace dict ([] = Perfetto-loadable)."""
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be a dict with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not a dict")
            continue
        for key in ("ph", "name", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        if ev.get("ph") == "X" and "dur" not in ev:
            problems.append(f"event {i}: complete event missing 'dur'")
        for key in ("ts", "dur"):
            if key in ev and not isinstance(ev[key], (int, float)):
                problems.append(f"event {i}: {key!r} not numeric")
    return problems


# -- module singleton ------------------------------------------------------
# ROC_OBS=1 arms tracing at import, so an entry point without a Config
# records too; Config mirrors the same variable into cfg.obs and the
# trainer calls enable() for the CLI path.

_TRACER = SpanTracer()
_TRACER.set_enabled(os.environ.get("ROC_OBS", "") == "1")


def get_tracer() -> SpanTracer:
    return _TRACER


def span(name: str, **args) -> _SpanCtx:
    return _TRACER.span(name, **args)


def enable(on: bool = True):
    _TRACER.set_enabled(on)


def enabled() -> bool:
    return _TRACER.enabled
