"""Median of the port's ``delta_batch`` spans in the window: a whole
``DeltaManager.apply`` call (the wait for the mutation lock, classify,
journal, the host store's commit, rewrite and install), in ms."""

import statistics

from perfbench import spans


def read(run):
    ms = [s.dur_ns / 1e6 for s in spans.named(run, "delta_batch")]
    return statistics.median(ms) if ms else None
