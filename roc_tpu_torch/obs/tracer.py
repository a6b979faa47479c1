"""Host-side span tracer: a ring of closed spans, monotonic clocks, Chrome
trace export (roc_tpu/obs/tracer.py).

    with obs.span("epoch", epoch=3) as sp:
        ...
    wall = sp.dur_s

A span always measures (the driver's epoch times are span durations,
tracing on or off); it is recorded into the ring only when tracing is
enabled: ``ROC_OBS=1`` in the environment, ``-obs`` on the CLI, or
``enable()``.  A disabled span costs two ``perf_counter_ns`` calls and a
list append and pop.

Export is Chrome trace-event JSON (``{"traceEvents": [{"ph": "X", ...}]}``,
timestamps and durations in microseconds), which Perfetto and
chrome://tracing load, beside the device trace that ``-profile`` writes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional, Set

DEFAULT_CAPACITY = 65536  # spans kept; old ones fall off the ring


class Span:
    """One closed span.  ``start_ns`` is `time.perf_counter_ns` (monotonic,
    process-local — NOT wall time); ``depth`` is the nesting level within
    its thread at open time (0 = top level)."""

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

    def to_event(self) -> dict:
        """Chrome trace-event "complete" ("X") event, microsecond units."""
        ev = {"ph": "X", "name": self.name, "cat": "roc",
              "ts": self.start_ns / 1e3, "dur": self.dur_ns / 1e3,
              "pid": os.getpid(), "tid": self.tid}
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
    tracer's ring only when tracing is enabled at close time."""

    __slots__ = ("_tracer", "name", "args", "start_ns", "dur_ns", "depth")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.start_ns = 0
        self.dur_ns = 0
        self.depth = 0

    def __enter__(self) -> "_SpanCtx":
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_ns = time.perf_counter_ns() - self.start_ns
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        t = self._tracer
        if t.enabled:
            t._ring.append(Span(self.name, self.start_ns, self.dur_ns,
                                threading.get_ident(), self.depth,
                                self.args or None))
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

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **args) -> _SpanCtx:
        return _SpanCtx(self, name, args)

    def spans(self) -> List[Span]:
        return list(self._ring)

    def span_types(self) -> Set[str]:
        return {s.name for s in self._ring}

    def clear(self):
        self._ring.clear()

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": [s.to_event() for s in self._ring],
                "displayTimeUnit": "ms"}

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
_TRACER.enabled = os.environ.get("ROC_OBS", "") == "1"


def get_tracer() -> SpanTracer:
    return _TRACER


def span(name: str, **args) -> _SpanCtx:
    return _TRACER.span(name, **args)


def enable(on: bool = True):
    _TRACER.enabled = bool(on)


def enabled() -> bool:
    return _TRACER.enabled
