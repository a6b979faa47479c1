"""The JAX package's random streams, bit for bit: jax.random's threefry
PRNG as roc_tpu draws from it (``jax_threefry_partitionable``, jax's
default).

roc_tpu seeds one key per run, ``PRNGKey(seed)``; its Glorot init draws
parameter i from ``fold_in(key, i)`` (models/model.py:449-472); its
dropout draws the masks of epoch e, dropout slot s from
``fold_in(fold_in(key, e), s)`` (train/driver.py:917, models/model.py:527),
``bernoulli(k, 1 - rate, shape)``.  The same keys, counters and float
construction here give the same parameters and masks on any device, so a
curve measured with the JAX package on one backend (docs/GOLDEN.md) is the
port's curve on the CPU and on the card, up to float reassociation.

Keys are pairs of Python ints (uint32 words).  ``threefry2x32`` runs on
int64 tensors holding uint32 values (the counters of a draw: the
row-major index of each element, split into its high and low words).  The card draws dropout masks in
``csrc/dropout.cu`` with the same rounds.
"""

from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[int, int]
_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (jax's ``threefry2x32_p``) of the key
    words (k0, k1) over counter words held as int64 tensors of uint32
    values; returns the two output words (new tensors)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0).bitwise_and_(_M)
    x1 = (x1 + k1).bitwise_and_(_M)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M)
            torch.bitwise_right_shift(x1, 32 - r, out=t)
            x1.bitwise_left_shift_(r).bitwise_and_(_M).bitwise_or_(t) \
                .bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M)
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as roc_tpu makes it (64-bit types off):
    the seed's low 32 bits."""
    return 0, int(seed) & _M


def _threefry2x32_int(k0: int, k1: int, x0: int, x1: int) -> Key:
    """:func:`threefry2x32` on one counter pair of Python ints: the keys
    of every step are derived on the host, and tensor ops there would cost
    a fraction of a millisecond a key."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & _M, (x1 + k1) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    return _threefry2x32_int(key[0], key[1], 0, int(data) & _M)


def random_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """The 32 random bits of each of ``n`` elements, as int64 [n]
    (``jax.random.bits``): threefry over the counter (hi, lo) of each
    element's row-major index, the two output words xor'ed."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & _M)
    return y0 ^ y1


def _unit_floats(key: Key, shape, device=None) -> torch.Tensor:
    """Floats in [0, 1): the top 23 of each element's bits as the mantissa
    of a float in [1, 2), minus 1 (jax.random.uniform's construction)."""
    n = 1
    for d in shape:
        n *= int(d)
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.  XLA
    contracts ``f * (maxval - minval) + minval`` into one fused
    multiply-add.  In float64 that sum is exact (f is a multiple of 2^-23
    below 1, and the width and minval are float32), so one rounding to
    float32 gives the fused result's bits."""
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    f = _unit_floats(key, shape, device).to(torch.float64)
    fused = (f * (hi - lo).to(torch.float64)
             + lo.to(torch.float64)).to(torch.float32)
    return torch.maximum(lo, fused)


def bernoulli(key: Key, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: uniform floats below the
    float32 ``p``."""
    return _unit_floats(key, shape, device) < torch.tensor(
        p, dtype=torch.float32, device=device)
