"""Loaders and wrappers of the hand-written CUDA kernels (sources in
roc_tpu_torch/csrc/).  Importing this package builds nothing: each kernel
is compiled at its first launch, or all of them at once by
:func:`build_all`."""

from concurrent.futures import ThreadPoolExecutor

from roc_tpu_torch.ops.kernels import (aggregate_linear, aggregate_sum,
                                       dropout, gat, xlayer)

KERNELS = {"aggregate_sum": aggregate_sum.aggregate_sum,
           "stage_plane": aggregate_sum.stage_plane,
           "aggregate_linear": aggregate_linear.aggregate_linear,
           "aggregate_linear_bwd": aggregate_linear.aggregate_linear_bwd,
           "stage_cotangent": aggregate_linear.stage_cotangent,
           "gat_score": gat.gat_score,
           "gat_stage": gat.gat_stage,
           "gat_forward": gat.gat_forward,
           "gat_bwd_dst": gat.gat_bwd_dst,
           "gat_bwd_src": gat.gat_bwd_src,
           "xlayer_fwd": xlayer.xlayer_fwd,
           "xlayer_bwd": xlayer.xlayer_bwd,
           "dropout": dropout.dropout}

LIBRARIES = (aggregate_sum.LIBRARY, aggregate_linear.LIBRARY, gat.LIBRARY,
             xlayer.LIBRARY, dropout.LIBRARY)


def build_all() -> None:
    """Build and load every kernel library, one ``nvcc`` per source, all
    started together."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for fut in [pool.submit(lib.load) for lib in LIBRARIES]:
            fut.result()


__all__ = ["KERNELS", "LIBRARIES", "aggregate_linear", "aggregate_sum",
           "build_all", "dropout", "gat", "xlayer"]
