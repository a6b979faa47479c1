"""Dense layer (roc_tpu/ops/linear.py): ``x @ w`` with no bias, then the
optional activation.

fp32 inputs multiply in full fp32, matching the JAX package's
``precision="highest"``: the call sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (a process-wide flag),
because TF32 keeps about three decimal digits.  bf16 inputs take the
tensor cores' bf16 x bf16 -> fp32 route with one rounding of the product
back to bf16, as roc_tpu's ``preferred_element_type=float32`` then
``astype(bf16)``: the call also sets
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False``, which would let cuBLAS round partial sums to bf16.  The GEMM itself is
``torch.matmul``: the JAX package leaves it to XLA, and it is no TPU kernel.
"""

from __future__ import annotations

import torch

from roc_tpu_torch.ops.activation import apply_activation


def linear(x: torch.Tensor, w: torch.Tensor,
           activation: str = "none") -> torch.Tensor:
    """x: [N, in_dim]; w: [in_dim, out_dim]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = torch.matmul(x, w.to(x.dtype))
    return apply_activation(out, activation)
