"""Median over the window's applied batches of ``DeltaManager.last_patch``
(classify, journal, rewrite and install seconds), in ms."""

import statistics


def read(run):
    if run["kind"] != "serve" or not run.get("patch_s"):
        return None
    return statistics.median(run["patch_s"]) * 1e3
