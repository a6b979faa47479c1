"""Inverted dropout (roc_tpu/ops/dropout.py) with an explicit PRNG key.

Keep with probability 1 - rate and scale by 1 / (1 - rate); the identity
at eval or rate 0.  The masks are jax.random's bits for the same key
(ops/prng.py), drawn on the card by ``csrc/dropout.cu``: a run draws the
masks roc_tpu draws, on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.kernels import dropout as _kernel


def dropout(x: torch.Tensor, rate: float, train: bool,
            key: Optional[prng.Key] = None) -> torch.Tensor:
    if not train or rate == 0.0:
        return x
    if key is None:
        raise ValueError("training dropout needs a PRNG key")
    return _kernel.dropout(x, rate, key)
