"""The whole forward's model operations (perfbench/counts.py) over the
traced window's seconds and the card's 67 TFLOP/s fp32 peak, in %."""

from perfbench.counts import PEAK_FLOPS, step_counts


def read(run):
    if run["kind"] != "serve" or not run["trace"]:
        return None
    count = run["forwards"]
    if not count:
        return None
    c = step_counts(run["cfg"], run["nodes"], run["edges"],
                    train=False)
    return 100.0 * c["flops"] * count / run["trace"]["window_s"] / PEAK_FLOPS
