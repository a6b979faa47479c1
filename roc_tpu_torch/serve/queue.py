"""Microbatched request queue (roc_tpu/serve/queue.py): accumulate node
queries into one window.

A window opens when the first request lands and drains when either the
accumulated query count reaches ``batch`` or ``wait_ms`` has passed since it
opened.  The worker thread hands the window's concatenated ids to the serve
function in one call, so a window costs one device round trip however many
requests rode it.  Futures are stamped at submit, at drain (taken into a
window) and at completion on the host's monotonic clock, which prices the
queueing delay into each request's latency.

The worker's timeline is spans (obs/tracer.py): ``queue_idle`` while it is
blocked with nothing pending, ``queue_fill`` from a window's open to its
drain (with ``late_us``, how far past the batching deadline the worker
woke, when the wait ran out), the engine's ``serve_window``, and
``queue_resolve`` over the futures and the ``on_window`` hook.  With the
ring on, each drained request adds a ``request_queued`` span from its
submit to its drain.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np

from roc_tpu_torch import obs
from roc_tpu_torch.analysis import witness as _witness


class Overloaded(RuntimeError):
    """The queue refused or dropped a request to bound its memory and
    latency (depth cap at submit, or the request's deadline passed before
    its window drained).  The client should back off, not report a bug."""


class Closed(RuntimeError):
    """The request raced a deliberate shutdown (submit after ``close()``,
    or closed before its window drained)."""


class ServeFuture:
    """One request's pending result (numpy [k, C] logits)."""

    __slots__ = ("ids", "_event", "_value", "_error", "t_submit", "t_drain",
                 "t_done", "deadline")

    def __init__(self, ids, deadline_s: Optional[float] = None):
        self.ids = ids
        self._event = threading.Event()
        self._value = None
        self._error = None
        self.t_submit = time.perf_counter()
        self.t_drain = 0.0
        self.t_done = 0.0
        self.deadline = None if deadline_s is None \
            else self.t_submit + float(deadline_s)

    def _resolve(self, value=None, error=None):
        self._value, self._error = value, error
        self.t_done = time.perf_counter()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serve request not completed in time")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_s(self) -> float:
        """Submit-to-completion wall seconds (queue wait + serve)."""
        return max(self.t_done - self.t_submit, 0.0)


class MicrobatchQueue:
    """Batch node-query requests into serve windows (one worker thread).

    ``serve_fn(ids) -> np.ndarray [len(ids), C]`` serves one drained window;
    ``on_window(latencies)`` (optional) receives each window's per-request
    latencies.  ``queue_max`` bounds the pending requests (0 = unbounded):
    past it ``submit`` sheds with :class:`Overloaded`.  A request whose
    ``deadline_s`` passes before its window drains resolves with
    :class:`Overloaded` instead of being served.
    """

    def __init__(self, serve_fn: Callable, batch: int = 64,
                 wait_ms: float = 2.0, on_window: Optional[Callable] = None,
                 queue_max: int = 0):
        if batch < 1 or wait_ms < 0.0 or queue_max < 0:
            raise ValueError(f"need batch >= 1, wait_ms >= 0, queue_max >= "
                             f"0; got {batch}, {wait_ms}, {queue_max}")
        self._serve_fn = serve_fn
        self._batch = int(batch)
        self._wait_s = float(wait_ms) / 1e3
        self._on_window = on_window
        self._queue_max = int(queue_max)
        self._pending: deque = deque()
        self._cv = _witness.trace("MicrobatchQueue._cv",
                                  threading.Condition())
        self._closed = False
        self.windows = 0
        self.served = 0
        self.shed = 0      # submits refused at the depth cap
        self.expired = 0   # requests dropped at drain (deadline passed)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="roc-torch-serve-queue")
        self._worker.start()

    # -- client side ------------------------------------------------------
    def submit(self, node_ids: Sequence[int],
               deadline_s: Optional[float] = None) -> ServeFuture:
        """Enqueue one request; returns a future resolving to [k, C]."""
        # roclint: allow(host-sync) request ingress, host list to host array, nothing device-resident
        ids = np.asarray(node_ids, np.int32).reshape(-1)
        if ids.size < 1:
            raise ValueError("empty query")
        fut = ServeFuture(ids, deadline_s=deadline_s)
        with self._cv:
            if self._closed:
                raise Closed("queue closed")
            if self._queue_max and len(self._pending) >= self._queue_max:
                self.shed += 1
                raise Overloaded(
                    f"serve queue at capacity ({self._queue_max} pending "
                    f"requests); shedding — retry with backoff")
            self._pending.append(fut)
            self._cv.notify()
        return fut

    def query(self, node_ids: Sequence[int], timeout: float = 60.0):
        """Blocking submit: the request's [k, C] logits."""
        return self.submit(node_ids).result(timeout)

    def depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def close(self):
        """Drain what is queued, stop the worker, and fail any future the
        worker could not serve with :class:`Closed`."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)
        with self._cv:
            leftover = list(self._pending)
            self._pending.clear()
        err = Closed("serve queue closed before this request was served")
        for f in leftover:
            if not f.done():
                f._resolve(error=err)

    # -- worker side ------------------------------------------------------
    def _drain(self) -> List[ServeFuture]:
        """One window: block for the first request, then accumulate until
        ``batch`` queries or ``wait_ms`` from window open."""
        with self._cv:
            while not self._pending and not self._closed:
                with obs.span("queue_idle"):
                    self._cv.wait(timeout=0.1)
            if not self._pending:
                return []
            with obs.span("queue_fill") as fill:
                # roclint: allow(raw-timing) the batching window's deadline on the condition variable, not a measurement
                t0 = time.perf_counter()
                timed_out = False
                while not self._closed:
                    n = sum(f.ids.size for f in self._pending)
                    if n >= self._batch:
                        break
                    remaining = self._wait_s - (time.perf_counter() - t0)
                    if remaining <= 0:
                        timed_out = True
                        break
                    self._cv.wait(timeout=remaining)
                window, expired, total = [], [], 0
                now = time.perf_counter()
                if timed_out:
                    fill.args["late_us"] = (now - t0 - self._wait_s) * 1e6
                while self._pending and total < self._batch:
                    f = self._pending.popleft()
                    f.t_drain = now
                    if f.deadline is not None and now > f.deadline:
                        expired.append(f)
                        continue
                    window.append(f)
                    total += f.ids.size
        if obs.enabled():
            tracer = obs.get_tracer()
            for f in window:
                tracer.record("request_queued", int(f.t_submit * 1e9),
                              int((now - f.t_submit) * 1e9))
        for f in expired:
            self.expired += 1
            f._resolve(error=Overloaded(
                "request deadline expired before its serve window drained; "
                "dropped unserved"))
        return window

    def _run(self):
        while True:
            window = self._drain()
            if not window:
                if self._closed:
                    return
                continue
            try:
                ids = np.concatenate([f.ids for f in window])
                out = self._serve_fn(ids)
                with obs.span("queue_resolve", requests=len(window)):
                    off = 0
                    for f in window:
                        f._resolve(value=out[off:off + f.ids.size])
                        off += f.ids.size
                    self.windows += 1
                    self.served += len(window)
                    if self._on_window is not None:
                        self._on_window([f.latency_s for f in window])
            except Exception as e:  # resolve the window, keep the worker
                for f in window:
                    if not f.done():
                        f._resolve(error=e)
