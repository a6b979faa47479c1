"""Median of the port's ``delta_lock_wait`` spans in the window: a delta
install's wait for the plan lock, which the serve worker holds for a
whole window, in ms."""

import statistics

from perfbench import spans


def read(run):
    ms = [s.dur_ns / 1e6 for s in spans.named(run, "delta_lock_wait")]
    return statistics.median(ms) if ms else None
