"""ULP distance between served and eval logits (roc_tpu/serve/parity.py).

Scale-free: reinterpret the float32 bits as integers ordered like the
floats and take the largest difference.
"""

from __future__ import annotations

import numpy as np
import torch


def _lex_int(x: np.ndarray) -> np.ndarray:
    """float32 bit patterns -> integers ordered like the floats (adjacent
    floats differ by 1; -0.0 and +0.0 coincide)."""
    b = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(b < 0, np.int64(-(2 ** 31)) - b, b)


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    # roclint: allow(host-sync) off-request-path parity gate; the host pull is its job
    return np.asarray(a, np.float32)


def max_ulp_diff(a, b) -> int:
    """Largest elementwise ULP distance between two float arrays or tensors
    (compared in float32).  An unmatched NaN counts as the maximum
    distance."""
    a, b = _host_f32(a), _host_f32(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    if (nan_a != nan_b).any():
        return int(np.iinfo(np.int64).max)
    ok = ~nan_a
    if not ok.any():
        return 0
    d = np.abs(_lex_int(a[ok]) - _lex_int(b[ok]))
    return int(d.max()) if d.size else 0
