"""Inverted dropout with the JAX package's masks: the CUDA kernel, its
loader and its plain version.

``dropout(x, rate, key)`` keeps each element with probability
``1 - rate`` and divides the kept ones by ``1 - rate``; element i is kept
when the uniform float jax.random draws for it from ``key`` (ops/prng.py)
lies below ``float32(1 - rate)``: roc_tpu's ``ops.dropout`` bit for bit.
On a CUDA tensor the wrapper launches ``csrc/dropout.cu`` (forward, and
the same launch on the cotangent for the backward, the mask recomputed
from the key); on a CPU tensor it runs :func:`dropout_plain`.
``dropout.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.kernels.build import CudaLibrary


def _bind(lib: ctypes.CDLL) -> None:
    p, ll, u, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, \
        ctypes.c_float
    fn = lib.roc_dropout
    fn.argtypes = [p, p, ll, u, u, f, f, p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("dropout.cu", _bind)


def dropout_plain(x: torch.Tensor, rate: float, key: prng.Key) -> torch.Tensor:
    """The plain PyTorch version on any device: roc_tpu's
    ``jnp.where(bernoulli(key, 1 - rate, x.shape), x / (1 - rate), 0)``."""
    keep = prng.bernoulli(key, 1.0 - rate, tuple(x.shape), x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _launch(x: torch.Tensor, rate: float, key: prng.Key) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    keep = 1.0 - rate
    with torch.cuda.device(x.device):
        err = LIBRARY.load().roc_dropout(
            x.data_ptr(), out.data_ptr(), x.numel(), key[0], key[1], keep,
            keep, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout kernel launch failed: CUDA error {err}")
    dropout.launches += 1
    return out


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, key):
        ctx.rate, ctx.key = rate, key
        return _launch(x, rate, key)

    @staticmethod
    def backward(ctx, g):
        return _launch(g, ctx.rate, ctx.key), None, None


def dropout(x: torch.Tensor, rate: float, key: prng.Key) -> torch.Tensor:
    """Training dropout of ``x`` with the masks of ``key``; differentiable.
    Launches the CUDA kernel for a float32 CUDA tensor (or raises for
    another dtype), runs :func:`dropout_plain` for a CPU tensor."""
    if x.device.type == "cpu":
        return dropout_plain(x, rate, key)
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"dropout runs on float32 cuda tensors or on cpu "
                         f"tensors, got {x.dtype} on {x.device}")
    return _Dropout.apply(x, rate, key)


dropout.launches = 0
