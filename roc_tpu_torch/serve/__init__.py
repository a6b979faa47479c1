"""Inference serving path (roc_tpu/serve/): microbatched node queries over
frozen params.

  queue.py    MicrobatchQueue + ServeFuture: requests into windows
  engine.py   ServeEngine: one full-graph forward per graph install, a row
              gather per dispatch
  parity.py   max_ulp_diff: the <= 32 ULP served-vs-eval gate
  loadgen.py  open-loop QPS generator

``python -m roc_tpu_torch.serve --selftest`` is the end-to-end smoke.
"""

from roc_tpu_torch.serve.engine import ServeEngine, bucket_sizes
from roc_tpu_torch.serve.loadgen import run_load
from roc_tpu_torch.serve.parity import max_ulp_diff
from roc_tpu_torch.serve.queue import (Closed, MicrobatchQueue, Overloaded,
                                       ServeFuture)

__all__ = ["ServeEngine", "MicrobatchQueue", "Overloaded", "Closed",
           "ServeFuture", "bucket_sizes", "max_ulp_diff", "run_load"]
