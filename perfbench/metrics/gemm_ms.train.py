"""Device ms a step in cuBLAS GEMM kernels (torch.profiler)."""

from perfbench.counts import GEMM_KERNELS, kernel_seconds


def read(run):
    if run["kind"] != "train" or not run["trace"] or not run["steps"]:
        return None
    s = kernel_seconds(run["trace"], GEMM_KERNELS)
    return s / run["steps"] * 1e3 if s > 0 else None
