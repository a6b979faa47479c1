"""The GAT backward's least time over its device time, in %: the least
time (perfbench/counts.py) of each layer's attention backward, at that
layer's heads and head width, times the steps in the traced window, over
the window's device seconds in the backward's two kernels (the source
rows' gather, then the destination rows' sum of the score gradients)."""

from perfbench.counts import _widths, gat_bwd_call, kernel_seconds, least_s

KERNELS = r"gat_bwd_src_rows|gat_bwd_dst_rows"


def read(run):
    if run["kind"] != "train" or not run["trace"] or \
            run["cfg"]["model"] != "gat" or not run["steps"]:
        return None
    busy = kernel_seconds(run["trace"], KERNELS)
    n, e = run["nodes"], run["edges"]
    least = sum(least_s(*gat_bwd_call(n, e, k, f))
                for _, _, k, f in _widths(run["cfg"],
                                       int(run["cfg"]["heads"])))
    if busy <= 0:
        return None
    return 100.0 * least * run["steps"] / busy
