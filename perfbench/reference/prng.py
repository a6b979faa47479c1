"""A frozen copy of the arithmetic of roc_tpu's random streams, so the
reference draws the dropout masks the port draws, without importing it.

jax.random's threefry-2x32 (20 rounds) with ``jax_threefry_partitionable``:
the run's key is ``PRNGKey(seed)`` = (0, low 32 bits of the seed); epoch
e's key is ``fold_in(key, e)`` and dropout slot s draws from
``fold_in(epoch_key, s)``; element i (row-major) is kept when the float in
[0, 1) made from the top 23 of its 32 bits lies below ``float32(1 -
rate)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[int, int]
_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rounds_int(k0: int, k1: int, x0: int, x1: int) -> Key:
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & _M, (x1 + k1) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def _rounds(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M
    x1 = (x1 + k1) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = (((x1 << r) & _M) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M
    return x0, x1


def key(seed: int) -> Key:
    return 0, int(seed) & _M


def fold_in(k: Key, data: int) -> Key:
    return _rounds_int(k[0], k[1], 0, int(data) & _M)


_BLOCK = 1 << 24


def keep_mask(k: Key, shape, rate: float, device) -> torch.Tensor:
    """The bool mask of elements dropout keeps, in blocks of 2^24 elements
    (the int64 words of a whole Reddit feature matrix would take 5 GB)."""
    n = 1
    for d in shape:
        n *= int(d)
    p = torch.tensor(1.0 - rate, dtype=torch.float32, device=device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    for lo in range(0, n, _BLOCK):
        idx = torch.arange(lo, min(lo + _BLOCK, n), dtype=torch.int64,
                           device=device)
        y0, y1 = _rounds(k[0], k[1], idx >> 32, idx & _M)
        bits = ((y0 ^ y1) >> 9) | 0x3F800000
        u = bits.to(torch.int32).view(torch.float32) - 1.0
        out[lo:lo + idx.numel()] = u < p
    return out.view(*shape)


def dropout(x: torch.Tensor, rate: float, k: Key) -> torch.Tensor:
    keep = keep_mask(k, tuple(x.shape), rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
