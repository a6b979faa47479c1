"""The GAT forward's least time over its device time, in %: the least time
(perfbench/counts.py) of each layer's source score and attention forward,
at that layer's heads and head width, times the steps in the traced
window, over the window's device seconds in the forward's kernels (the
score, the forward, and the fp32 plane staged for a single head of a
width that is not a multiple of 4)."""

from perfbench.counts import (_widths, gat_fwd_call, gat_score_call,
                              kernel_seconds, least_s)

KERNELS = r"gat_score_rows|gat_fwd_rows|stage_kernel_f32"


def read(run):
    if run["kind"] != "train" or not run["trace"] or \
            run["cfg"]["model"] != "gat" or not run["steps"]:
        return None
    busy = kernel_seconds(run["trace"], KERNELS)
    n, e = run["nodes"], run["edges"]
    least = sum(least_s(*gat_score_call(n, k, f))
                + least_s(*gat_fwd_call(n, e, k, f))
                for _, _, k, f in _widths(run["cfg"],
                                       int(run["cfg"]["heads"])))
    if busy <= 0:
        return None
    return 100.0 * least * run["steps"] / busy
