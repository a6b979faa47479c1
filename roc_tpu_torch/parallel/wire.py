"""The wire codec of the feature exchanges (roc_tpu/parallel/spmd.py:704-768,
``_wire_down``, ``_wire_up``, ``_sr_bf16``).

Every vertex-mode exchange that moves features (the halo send buffer, the
allgather table) goes through this encode/decode pair.  ``-bf16-storage``
halves the bytes: the encode rounds fp32 to bf16, to nearest even or
stochastically (``-bf16-rounding stochastic``: add 16 random low bits to
the fp32 word and truncate, unbiased, with a straight-through gradient);
``-bf16-exchange compensated`` sends a (hi, lo) bf16 pair concatenated on
the feature axis, fp32's bytes again.  The decode at the aggregation
boundary returns to the compute dtype, so all accumulation stays fp32.
The cotangents that the backward sends back over the same wire take the
bf16 encode's dtype, as AD of roc_tpu's exchange gives them.

The stochastic bits are roc_tpu's: ``jax.random.bits(fold_in(PRNGKey(
0x0b16), position), shape, uint16)`` for the mesh position that sends,
which under jax's partitionable threefry is the low 16 bits of each
element's 32-bit draw (ops/prng.py).  The key does not change with the
step or the layer, so a position draws the same bits for every send
buffer of one shape: they are drawn once per (size, position, device)
and kept.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from roc_tpu_torch.ops import prng

SR_SEED = 0x0b16    # roc_tpu's fixed fold-in base
_CHUNK = 1 << 24    # elements a draw or a rounding computes at once (its
                    # uint32 arithmetic runs in int64)
_BITS: Dict[Tuple[int, int, str], torch.Tensor] = {}

Xch = Tuple[str, str, str]     # (dtype, rounding, exchange)
FP32_WIRE: Xch = ("fp32", "nearest", "plain")


def sr_bits(n: int, position: int, device) -> torch.Tensor:
    """The 16 random bits of each of ``n`` elements that mesh position
    ``position`` adds before truncating, kept as int16 words [n] (read
    back as ``& 0xFFFF``)."""
    device = torch.device(device)
    key = (n, int(position), str(device))
    bits = _BITS.get(key)
    if bits is None:
        k = prng.fold_in(prng.prng_key(SR_SEED), position)
        bits = torch.empty(n, dtype=torch.int16, device=device)
        for lo in range(0, n, _CHUNK):
            hi = min(n, lo + _CHUNK)
            idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
            y0, y1 = prng.threefry2x32(k[0], k[1], idx >> 32,
                                       idx & 0xFFFFFFFF)
            bits[lo:hi] = ((y0 ^ y1) & 0xFFFF).to(torch.int16)
        _BITS[key] = bits
    return bits


def clear_bits() -> None:
    """Drop the kept stochastic bits (they are a run's device memory)."""
    _BITS.clear()


class _SrBf16(torch.autograd.Function):
    """fp32 -> bf16 by stochastic rounding, ``_CHUNK`` elements at a time
    (the uint32 arithmetic runs in int64); the gradient passes straight
    through (the rounding is zero-mean, its derivative 1 almost
    everywhere)."""

    @staticmethod
    def forward(ctx, x, bits):
        words = x.contiguous().view(-1).view(torch.int32)
        out = torch.empty(words.numel(), dtype=torch.bfloat16,
                          device=x.device)
        for lo in range(0, words.numel(), _CHUNK):
            hi = min(words.numel(), lo + _CHUNK)
            u = words[lo:hi].to(torch.int64) & 0xFFFFFFFF
            u = (u + (bits[lo:hi].to(torch.int64) & 0xFFFF)) & 0xFFFF0000
            u = torch.where(u >= 1 << 31, u - (1 << 32), u)
            # the low 16 bits are 0: the cast to bf16 is exact
            out[lo:hi] = u.to(torch.int32).view(torch.float32)
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.float32), None


def sr_bf16(x: torch.Tensor, position: int) -> torch.Tensor:
    """``_sr_bf16`` on mesh position ``position``."""
    return _SrBf16.apply(x, sr_bits(x.numel(), position, x.device))


def wire_down(x: torch.Tensor, xch: Xch, position: int) -> torch.Tensor:
    """Encode a sender position's features for the exchange; fp32 (the
    default), or an already-bf16 compute dtype, is the identity."""
    dtype, rounding, exchange = xch
    if dtype != "bf16" or x.dtype != torch.float32:
        return x
    if exchange == "compensated":
        hi = x.to(torch.bfloat16)
        lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
        return torch.cat([hi, lo], dim=-1)
    if rounding == "stochastic":
        return sr_bf16(x, position)
    return x.to(torch.bfloat16)


def wire_up(y: torch.Tensor, xch: Xch, dtype: torch.dtype,
            H: int) -> torch.Tensor:
    """Decode a :func:`wire_down` encoding back to the compute ``dtype``;
    ``H`` is the width before the encode (it tells the compensated 2H-wide
    pair from a pass-through)."""
    if xch[2] == "compensated" and y.shape[-1] == 2 * H:
        return y[..., :H].to(dtype) + y[..., H:].to(dtype)
    return y.to(dtype)


def is_identity(xch: Xch, dtype: torch.dtype) -> bool:
    """Whether the codec moves the features unchanged."""
    return xch[0] != "bf16" or dtype != torch.float32
