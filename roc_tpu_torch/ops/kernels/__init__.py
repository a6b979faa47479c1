"""Loaders and wrappers of the hand-written CUDA kernels (sources in
roc_tpu_torch/csrc/).  Importing this package builds nothing: each kernel
is compiled at its first launch, or all of them at once by
:func:`build_all`."""

from concurrent.futures import ThreadPoolExecutor

from roc_tpu_torch.ops.kernels import aggregate_linear, aggregate_sum

KERNELS = {"aggregate_sum": aggregate_sum.aggregate_sum,
           "aggregate_linear": aggregate_linear.aggregate_linear,
           "aggregate_linear_bwd": aggregate_linear.aggregate_linear_bwd}

LIBRARIES = (aggregate_sum.LIBRARY, aggregate_linear.LIBRARY)


def build_all() -> None:
    """Build and load every kernel library, one ``nvcc`` per source, all
    started together."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for fut in [pool.submit(lib.load) for lib in LIBRARIES]:
            fut.result()


__all__ = ["KERNELS", "LIBRARIES", "aggregate_linear", "aggregate_sum",
           "build_all"]
