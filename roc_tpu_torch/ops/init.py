"""Glorot-uniform initialization (roc_tpu/ops/init.py): uniform in
±sqrt(6 / (fan_in + fan_out)), drawn from a jax.random key with the JAX
package's bits (ops/prng.py), so the port starts from roc_tpu's
parameters."""

from __future__ import annotations

import torch

from roc_tpu_torch.ops import prng


def glorot_uniform(key: prng.Key, in_dim: int, out_dim: int,
                   device=None) -> torch.Tensor:
    """[in_dim, out_dim] float32, drawn on the CPU and placed on
    ``device``."""
    scale = (6.0 / (in_dim + out_dim)) ** 0.5
    w = prng.uniform(key, (in_dim, out_dim), -scale, scale)
    return w if device is None else w.to(device)
