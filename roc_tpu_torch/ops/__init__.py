from roc_tpu_torch.ops.activation import apply_activation, elu, relu, sigmoid
from roc_tpu_torch.ops.aggregate import (DeviceCsr, _unfused_region,
                                         divide_by_degree, region_linear,
                                         scatter_gather, scatter_gather_linear,
                                         scatter_gather_plain)
from roc_tpu_torch.ops.dropout import dropout
from roc_tpu_torch.ops.edge import edge_softmax, gat_attend, gat_attend_kernel
from roc_tpu_torch.ops.element import add, mul
from roc_tpu_torch.ops.init import glorot_uniform
from roc_tpu_torch.ops.linear import linear
from roc_tpu_torch.ops.norm import indegree_norm
from roc_tpu_torch.ops.softmax import (PerfMetrics, format_metrics,
                                       masked_softmax_cross_entropy,
                                       perf_metrics)

__all__ = [
    "DeviceCsr", "scatter_gather", "scatter_gather_plain",
    "scatter_gather_linear", "region_linear", "_unfused_region",
    "divide_by_degree", "edge_softmax", "gat_attend",
    "gat_attend_kernel", "indegree_norm", "linear",
    "relu", "sigmoid", "elu", "apply_activation", "add", "mul", "dropout",
    "glorot_uniform", "PerfMetrics", "masked_softmax_cross_entropy",
    "perf_metrics", "format_metrics",
]
