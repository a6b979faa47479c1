"""Inverted dropout with the JAX package's masks: the CUDA kernel, its
loader and its plain version.

``dropout(x, rate, key)`` keeps each element with probability
``1 - rate`` and divides the kept ones by ``1 - rate``; element i is kept
when the uniform float jax.random draws for it from ``key`` (ops/prng.py)
lies below ``float32(1 - rate)``: roc_tpu's ``ops.dropout`` bit for bit.
A bf16 ``x`` keeps the same masks and divides as roc_tpu's
``x / (1.0 - rate)`` does with a weak-typed Python float: by
``bf16(1 - rate)``, the quotient formed in fp32 and rounded once to bf16.
On a CUDA tensor the wrapper launches ``csrc/dropout.cu`` (forward, and
the same launch on the cotangent for the backward, the mask recomputed
from the key); on a CPU tensor it runs :func:`dropout_plain`.
``dropout.launches`` counts the kernel's launches, fp32 and bf16.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.kernels.build import CudaLibrary


def _bind(lib: ctypes.CDLL) -> None:
    p, ll, u, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, \
        ctypes.c_float
    for fn in (lib.roc_dropout, lib.roc_dropout_bf16):
        fn.argtypes = [p, p, ll, u, u, f, f, p]
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("dropout.cu", _bind)


def divisor(rate: float, dtype: torch.dtype) -> float:
    """What the kept elements are divided by: ``1 - rate`` as the Python
    float (taken as float32 by the fp32 division), or ``bf16(1 - rate)``
    for a bf16 x, as jax converts a weak-typed scalar to the array's
    dtype."""
    d = 1.0 - rate
    if dtype != torch.bfloat16:
        return d
    # float32(d) rounded to bf16 from its bits, ties to even: a constant
    # worked out on the host with no tensor made per call
    (b,) = struct.unpack("<I", struct.pack("<f", d))
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", b))[0]


def dropout_plain(x: torch.Tensor, rate: float, key: prng.Key) -> torch.Tensor:
    """The plain PyTorch version on any device: roc_tpu's
    ``jnp.where(bernoulli(key, 1 - rate, x.shape), x / (1 - rate), 0)``;
    on a bf16 x the quotient ``f32(x) / f32(bf16(1 - rate))`` is rounded
    once to bf16."""
    keep = prng.bernoulli(key, 1.0 - rate, tuple(x.shape), x.device)
    if x.dtype == torch.bfloat16:
        q = x.to(torch.float32) / divisor(rate, x.dtype)
        return torch.where(keep, q, torch.zeros_like(q)).to(x.dtype)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _run(x: torch.Tensor, rate: float, key: prng.Key) -> torch.Tensor:
    x = x.contiguous()
    if x.data_ptr() % 16:   # the kernel moves 16-byte packs
        x = x.clone()       # a fresh tensor is aligned
    out = torch.empty_like(x)
    LIBRARY.launch(dropout, "roc_dropout_bf16" if x.dtype == torch.bfloat16
                   else "roc_dropout", x.device, x.data_ptr(),
                   out.data_ptr(), x.numel(), key[0], key[1], 1.0 - rate,
                   divisor(rate, x.dtype))
    return out


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, key):
        ctx.rate, ctx.key = rate, key
        return _run(x, rate, key)

    @staticmethod
    def backward(ctx, g):
        return _run(g, ctx.rate, ctx.key), None, None


def dropout(x: torch.Tensor, rate: float, key: prng.Key) -> torch.Tensor:
    """Training dropout of ``x`` with the masks of ``key``; differentiable.
    Launches the CUDA kernel for a float32 or bfloat16 CUDA tensor (or
    raises for another dtype), runs :func:`dropout_plain` for a CPU
    tensor."""
    if x.device.type == "cpu":
        return dropout_plain(x, rate, key)
    if x.device.type != "cuda" or x.dtype not in (torch.float32,
                                                  torch.bfloat16):
        raise ValueError(f"dropout runs on float32/bfloat16 cuda tensors or "
                         f"on cpu tensors, got {x.dtype} on {x.device}")
    return _Dropout.apply(x, rate, key)


dropout.launches = 0
