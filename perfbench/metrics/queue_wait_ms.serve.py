"""Median of the port's ``request_queued`` spans in the window: each
request's wait in the queue, from its submit to the worker's taking it
into a window, in ms."""

import statistics

from perfbench import spans


def read(run):
    waits = [s.dur_ns / 1e6 for s in spans.named(run, "request_queued")]
    return statistics.median(waits) if waits else None
