"""The one roofline (roc_tpu/obs/roofline.py): peak constants and an
epoch's FLOPs and bytes walked from the op IR, priced for the card.

The JAX package's peaks are a TPU's (197 TFLOP/s bf16, 819 GB/s); the
port's are an NVIDIA H100 SXM's data sheet, as PERF.md §3's device row
gives them: 67 TFLOP/s fp32 outside the tensor cores and 3.35 TB/s HBM3.
The memory estimator prices a linear's recompute here.

Accounting convention (standard MFU; roofline.py:17-36): matmul and
aggregation terms only.  Per op, for one training epoch:

  linear Fin->Fout:  6*N*Fin*Fout FLOPs, 3*(N*Fin + N*Fout)*b bytes
  aggregate at F:    4*E*F FLOPs, 2*(E*F*b + N*F*b + E*4) bytes
  gat (K heads, D):  the projection Fin -> K*D plus the sweep at K*D

b = 2 under "fast" (one bf16 rounding of features), 4 under "exact".
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BW", "itemsize_for",
           "model_flops_bytes", "forward_flops_bytes", "roofline_time",
           "mfu", "roofline_frac"]


# The card the peaks describe, NVIDIA H100 80GB HBM3 (SXM, 700 W): the
# fp32 rate outside the tensor cores and the HBM3 rate, from its data sheet.
PEAK_FLOPS = 67e12
PEAK_BW = 3.35e12


def itemsize_for(precision: str = "fast") -> int:
    """Feature-stream element width under the aggregation precision."""
    return 2 if precision == "fast" else 4


def _walk(model, num_nodes: int, num_edges: int, precision: str,
          lin_f: float, lin_b: float, agg_f: float, agg_b: float):
    n, e = float(num_nodes), float(num_edges)
    b = itemsize_for(precision)
    dims = {model.input.id: model.input.dim}
    flops = nbytes = 0.0
    for op in model.ops:
        a = dims[op.inputs[0]]
        if op.kind == "linear":
            out = int(op.attrs["out_dim"])
            flops += lin_f * n * a * out
            nbytes += lin_b * (n * a * b + n * out * b)
        elif op.kind == "gat":
            out = int(op.attrs["heads"]) * int(op.attrs["head_dim"])
            flops += lin_f * n * a * out + agg_f * e * out
            nbytes += lin_b * (n * a * b + n * out * b)
            nbytes += agg_b * (e * out * b + n * out * b + e * 4)
        elif op.kind == "aggregate":
            out = a
            flops += agg_f * e * out
            nbytes += agg_b * (e * out * b + n * out * b + e * 4)
        else:
            out = a          # elementwise: O(N*F) noise, not counted
        dims[op.out] = out
    return flops, nbytes


def model_flops_bytes(model, num_nodes: int, num_edges: int,
                      precision: str = "fast"):
    """(FLOPs, least HBM bytes) of one training epoch (forward, backward)."""
    return _walk(model, num_nodes, num_edges, precision, 6.0, 3.0, 4.0, 2.0)


def forward_flops_bytes(model, num_nodes: int, num_edges: int,
                        precision: str = "fast"):
    """(FLOPs, least HBM bytes) of one inference forward."""
    return _walk(model, num_nodes, num_edges, precision, 2.0, 1.0, 2.0, 1.0)


def roofline_time(flops: float, nbytes: float, n_dev: int = 1,
                  peak_flops: float = None, peak_bw: float = None) -> float:
    """Least epoch seconds: the larger of the compute and memory bounds."""
    pf = PEAK_FLOPS if peak_flops is None else peak_flops
    pb = PEAK_BW if peak_bw is None else peak_bw
    return max(flops / (n_dev * pf), nbytes / (n_dev * pb))


def mfu(flops: float, seconds: float, n_dev: int = 1,
        peak_flops: float = None):
    """Achieved FLOP/s over the peak; None when unmeasurable."""
    pf = PEAK_FLOPS if peak_flops is None else peak_flops
    if seconds <= 0.0 or pf <= 0.0:
        return None
    return flops / seconds / (n_dev * pf)


def roofline_frac(flops: float, nbytes: float, seconds: float,
                  n_dev: int = 1, peak_flops: float = None,
                  peak_bw: float = None):
    """roofline_time over the measured seconds; 1.0 = at the roofline."""
    if seconds <= 0.0:
        return None
    return roofline_time(flops, nbytes, n_dev, peak_flops, peak_bw) / seconds
