"""The cross-process exchange of ``-multihost``: what ``shard_map``'s
collectives and ``jax.experimental.multihost_utils`` do for roc_tpu
(roc_tpu/parallel/spmd.py, roc_tpu/graph/shard_load.py:61-91).

One process drives one device and holds ``P / W`` mesh positions on it (W
the world size).  :func:`init_process_group` reads torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and starts ``torch.distributed`` with ``nccl`` for a CUDA
device and ``gloo`` for the CPU (roc_tpu runs gloo on CPU hosts,
tests/multihost_worker.py).  There is no fallback: if NCCL cannot start,
the run fails.

Each collective that moves features is a small ``torch.autograd.Function``
whose backward is the transposed collective, as AD transposes roc_tpu's:

  all_to_all      equal splits along dim 0; its transpose is itself
  all_gather      [n, ...] -> [W*n, ...] in rank order; its transpose is a
                  summing reduce-scatter
  reduce_scatter  [W*n, ...] -> this rank's summed [n, ...]; its transpose
                  is the all-gather
  ring_hop        send to rank + 1, receive from rank - 1
                  (``batch_isend_irecv``); its transpose is the hop the
                  other way.  gloo cannot pair a rank with itself, so a
                  gloo world of one moves the block with
                  ``all_to_all_single``; NCCL pairs the send and the
                  receive to the same rank inside the batch

``all_reduce_max`` carries no gradient (roc_tpu stops the gradient before
``pmax``), and ``all_reduce_sum_`` (the loss, the gradients, the eval
counts) runs outside autograd.  Every rank must call the same collectives
in the same order with the same shapes; the callers build every argument
from shapes all ranks agree on (the allgathered floors).

``launches()`` counts each collective this process ran, by backend and
name, where it calls ``torch.distributed``.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT_S = 600     # a collective that waits longer fails the run

_LAUNCHES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the world."""
    rank: int
    world: int
    local_rank: int
    backend: str            # nccl | gloo
    device: torch.device


_GROUP: Optional[Group] = None


def launches() -> dict:
    """``{"<backend>:<collective>": count}`` since the last reset."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    _LAUNCHES.clear()


def _note(name: str) -> None:
    _LAUNCHES[f"{_GROUP.backend}:{name}"] += 1


def env_info() -> dict:
    """torchrun's variables; a missing one exits naming it."""
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise SystemExit(
            f"error: -multihost reads torchrun's environment; "
            f"{', '.join(missing)} not set (run under torchrun "
            f"--nproc-per-node N, or set {', '.join(ENV)})")
    return {k: os.environ[k] for k in ENV}


def process_device(device=None) -> str:
    """The device a ``-multihost`` process drives: ``cuda:{LOCAL_RANK}``
    for the default (None or a bare "cuda"), else the one named."""
    if device is None or str(device) == "cuda":
        return f"cuda:{int(env_info()['LOCAL_RANK'])}"
    return str(device)


def init_process_group(device) -> Group:
    """Start (once) the process group of this run on ``device``: nccl for
    CUDA, gloo for the CPU."""
    global _GROUP
    device = torch.device(device)
    if _GROUP is not None:
        if _GROUP.device != device:
            raise RuntimeError(f"the process group drives {_GROUP.device}, "
                               f"not {device}")
        return _GROUP
    env = env_info()
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
            f"{env['MASTER_PORT']}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _GROUP = Group(rank=rank, world=world,
                   local_rank=int(env["LOCAL_RANK"]), backend=backend,
                   device=device)
    return _GROUP


def group() -> Optional[Group]:
    """The running group, or None outside ``-multihost``."""
    return _GROUP


def destroy_process_group() -> None:
    global _GROUP
    if _GROUP is not None and dist.is_initialized():
        dist.destroy_process_group()
    _GROUP = None


# -- the feature exchanges (autograd Functions) ------------------------------

def _a2a(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    _note("all_to_all")
    dist.all_to_all_single(out, x.contiguous())
    return out


# the single-tensor collectives' names in this torch (newer releases
# rename all_gather_into_tensor / reduce_scatter_tensor)
_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _gather(x: torch.Tensor) -> torch.Tensor:
    out = x.new_empty((_GROUP.world * x.shape[0],) + tuple(x.shape[1:]))
    _note("all_gather")
    _GATHER(out, x.contiguous())
    return out


def _scatter_sum(x: torch.Tensor) -> torch.Tensor:
    out = x.new_empty((x.shape[0] // _GROUP.world,) + tuple(x.shape[1:]))
    _note("reduce_scatter")
    _SCATTER(out, x.contiguous())
    return out


def _hop(x: torch.Tensor, step: int) -> torch.Tensor:
    """Send ``x`` to rank + step, receive the block of rank - step."""
    W, r = _GROUP.world, _GROUP.rank
    x = x.contiguous()
    out = torch.empty_like(x)
    _note("ring_hop")
    if W == 1 and _GROUP.backend == "gloo":
        dist.all_to_all_single(out, x)
        return out
    ops = [dist.P2POp(dist.isend, x, (r + step) % W),
           dist.P2POp(dist.irecv, out, (r - step) % W)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _a2a(x)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scatter_sum(x)

    @staticmethod
    def backward(ctx, g):
        return _gather(g)


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _hop(x, 1)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, -1)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Chunk d of ``x`` (W equal chunks along dim 0) goes to rank d; the
    result's chunk s came from rank s."""
    return _AllToAll.apply(x)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order along dim 0."""
    return _AllGather.apply(x)


def reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x``'s chunk ``rank`` (W equal chunks)."""
    return _ReduceScatter.apply(x)


def ring_hop(x: torch.Tensor) -> torch.Tensor:
    """The block of rank - 1 (this rank's goes to rank + 1)."""
    return _RingHop.apply(x)


# -- outside autograd -----------------------------------------------------------

def gather_raw(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_gather` without a gradient (inside a hand-derived
    backward)."""
    return _gather(x)


def scatter_sum_raw(x: torch.Tensor) -> torch.Tensor:
    """:func:`reduce_scatter` without a gradient."""
    return _scatter_sum(x)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ranks; no gradient."""
    out = x.detach().clone()
    _note("all_reduce_max")
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def all_reduce_sum_(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over ranks in place (no gradient); returns it."""
    _note("all_reduce_sum")
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def barrier() -> None:
    _note("barrier")
    if _GROUP.backend == "nccl":
        dist.barrier(device_ids=[_GROUP.device.index])
    else:
        dist.barrier()


def allgather_np(x: np.ndarray) -> np.ndarray:
    """``[W, *x.shape]`` of every rank's host array, process-major
    (shard_load's allgather contract).  int64 crosses as int64: no
    narrowing at any size."""
    x = np.ascontiguousarray(x)
    t = torch.from_numpy(x.reshape(-1).copy()).to(_GROUP.device)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    out = _gather(t)
    return out.cpu().numpy().astype(x.dtype, copy=False).reshape(
        (_GROUP.world,) + x.shape)
