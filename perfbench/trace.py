"""The device trace of a traced run (``--trace 1``): torch.profiler over
the measured window, reduced to the device's busy time, each kernel's
total time, the longest device operations and the longest idle gaps named
by what the host was doing in them."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Optional

import torch

WINDOW = "bench.window"
NAME_CHARS = 160   # a kernel's name in the breakdown, cut


class DeviceTrace:
    """``with DeviceTrace(on) as tr: ...`` profiles the block when ``on``;
    after it, ``tr.summary`` holds the reduction (None when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.summary: Optional[dict] = None
        self._prof = None
        self._mark = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._mark = torch.profiler.record_function(WINDOW)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if exc[0] is None:
            self.summary = reduce_events(
                self._prof.profiler.kineto_results.events())
        self._prof = None
        return False


def label(name: str):
    """A host span in the trace (``bench.<name>``), or nothing when no
    profiler is on."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function("bench." + name)
    return contextlib.nullcontext()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """busy_s, window_s, each device operation's total seconds, and the
    ``breakdown`` of the result line."""
    dev, host = [], []
    w0 = w1 = None
    for e in events:
        kind = e.device_type()
        s, d = e.start_ns(), e.duration_ns()
        if kind == torch.autograd.DeviceType.CUDA:
            # a host span mirrored on the device's timeline is no work
            if not e.is_user_annotation():
                dev.append((s, s + d, e.name()))
        elif e.name() == WINDOW:
            w0, w1 = s, s + d
        else:
            host.append((s, s + d, e.name()))
    if w0 is None:
        raise RuntimeError("the traced window has no marker")
    totals = defaultdict(float)
    spans = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            totals[name] += (e - s) / 1e9
            spans.append((s, e))
    busy = _merge(spans)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = []
    prev = w0
    for s, e in busy:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = e
    if w1 > prev:
        gaps.append((w1 - prev, prev, w1))
    gaps.sort(reverse=True)
    named = []
    for length, s, e in gaps[:10]:
        mid = (s + e) // 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
            else "host (no recorded op)"
        named.append([name, length / 1e9])
    top = [[k[:NAME_CHARS], v] for k, v in
           sorted(totals.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e9,
            "kernels": dict(totals),
            "breakdown": {"device_ops": top,
                          "idle_gaps": named}}
