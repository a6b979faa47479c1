"""The sum functions' least time over their device time, in %: the
least time (perfbench/counts.py) of every sum call a step, times the
steps in the traced window, over the window's device seconds in the
sum kernels (SUM_KERNELS)."""

from perfbench.counts import SUM_KERNELS, kernel_seconds, step_counts


def read(run):
    if run["kind"] != "train" or not run["trace"]:
        return None
    busy = kernel_seconds(run["trace"], SUM_KERNELS)
    count = run["steps"]
    c = step_counts(run["cfg"], run["nodes"], run["edges"],
                    train=True)
    if busy <= 0 or not count or c["sum_least_s"] <= 0:
        return None
    return 100.0 * c["sum_least_s"] * count / busy
