"""Standalone activations (roc_tpu/ops/activation.py).

``relu`` is the JAX package's ``jnp.maximum(x, 0.0)`` with that function's
VJP: the cotangent times 1 where x > 0, 0.5 at a tie (x == 0, either
sign), 0 elsewhere (NaN included), as ``jax.lax.max``'s balanced rule
gives it.  ``torch.clamp_min``'s own backward passes the whole cotangent
at x == 0.  The fused megakernel and region paths keep their ``y > 0``
mask (the Pallas kernels' rule), so they pass 0 at a tie.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _Relu(torch.autograd.Function):
    """max(x, 0), NaN passing through; backward g * (1, 0.5 or 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        slope = torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))
        return g * slope.to(g.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return _Relu.apply(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)


def apply_activation(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "none":
        return x
    if mode == "relu":
        return relu(x)
    if mode == "sigmoid":
        return sigmoid(x)
    if mode == "elu":
        return elu(x)
    raise ValueError(f"unknown activation {mode!r}")
