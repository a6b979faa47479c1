"""The host-store allocator of the streaming tier (roc_tpu/stream/host.py).

Every host array the executor stages to the card (shard tables, boundary
activation and cotangent stores, the shards' CSRs) comes from
:func:`alloc` / :func:`to_store`.  With a CUDA device the store is a
``torch.empty(..., pin_memory=True)`` tensor handed out as a NumPy view of
the same memory, so the ring's host-to-device copies and the cotangent
pulls run from page-locked memory, asynchronously.  The view is trusted
only when its data pointer is the tensor's; anything else (no CUDA, an
allocation the driver refuses) falls back to plain NumPy memory, counted
in :func:`stats`.  The fallback is what runs on the CPU; on the card
``chip_smoke.py`` checks that it never happened.

bf16 stores are ``np.uint16`` arrays of the raw bf16 words (NumPy has no
bf16; ``torch_view`` views them as torch.bfloat16).

``STREAM_BW_BYTES_S`` is the assumed host-device streaming rate for the
predicted transfer seconds (``ROC_STREAM_BW_BYTES`` overrides it).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

__all__ = ["alloc", "to_store", "torch_view", "pinned_supported", "stats",
           "reset_stats", "STREAM_BW_BYTES_S", "BF16"]

# the NumPy dtype of a bf16 store: the raw 16-bit words
BF16 = np.dtype(np.uint16)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


# Assumed sustained host<->device rate (bytes/s) for the predicted
# transfer seconds; ROC_STREAM_BW_BYTES calibrates a host.
STREAM_BW_BYTES_S = _env_float("ROC_STREAM_BW_BYTES", 10e9)

# Pinned tensors whose NumPy views are live stores: the tensor owns the
# memory, so it must outlive the view.
_KEEPALIVE: list = []

_pinned_bytes = 0
_fallback_bytes = 0
_warned = False


def pinned_supported() -> bool:
    """True when page-locked host memory can be had (a CUDA device)."""
    return torch.cuda.is_available()


def _warn_once(msg: str) -> None:
    global _warned
    if not _warned:
        _warned = True
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def torch_view(arr: np.ndarray) -> torch.Tensor:
    """A store as a tensor over the same memory (bf16 words as bf16)."""
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if arr.dtype == BF16 else t


def _pinned_view(shape, dtype: np.dtype):
    """A writable NumPy view of a zeroed pinned tensor, or None when the
    aliasing cannot be proven."""
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    t = torch.zeros(n, dtype=torch.uint8, pin_memory=True)
    arr = t.numpy().view(dtype).reshape(shape)
    if arr.__array_interface__["data"][0] != t.data_ptr() \
            or not arr.flags.writeable:
        return None
    _KEEPALIVE.append(t)
    return arr


def alloc(shape, dtype) -> np.ndarray:
    """A zeroed host store, pinned when the machine has a CUDA device."""
    global _pinned_bytes, _fallback_bytes
    dtype = np.dtype(dtype)
    if pinned_supported():
        try:
            arr = _pinned_view(shape, dtype)
        except (RuntimeError, TypeError) as e:
            _warn_once(f"pinned allocation failed ({e!r}); stream stores "
                       "fall back to pageable memory")
            arr = None
        if arr is not None:
            _pinned_bytes += arr.nbytes
            return arr
    arr = np.zeros(shape, dtype)
    _fallback_bytes += arr.nbytes
    return arr


def to_store(src, dtype=None) -> np.ndarray:
    """``src`` copied into a fresh store (pinned when possible)."""
    src = np.asarray(src)
    arr = alloc(src.shape, src.dtype if dtype is None else dtype)
    arr[...] = src
    return arr


def stats() -> dict:
    """Allocation accounting for the records and the fallback test."""
    return {"pinned": pinned_supported(),
            "pinned_bytes": int(_pinned_bytes),
            "fallback_bytes": int(_fallback_bytes)}


def reset_stats() -> None:
    global _pinned_bytes, _fallback_bytes, _warned
    _pinned_bytes = 0
    _fallback_bytes = 0
    _warned = False
    _KEEPALIVE.clear()
