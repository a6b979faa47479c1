"""The parts' mesh (roc_tpu/parallel/mesh.py).

roc_tpu lays its parts on a 1-D ``jax.sharding.Mesh`` along the 'parts'
axis.  Here a mesh is a list of torch devices, one per mesh position, and
the parts sit on the positions as roc_tpu lays them out: one part per
position when ``num_parts <= len(devices)`` (a mesh over the first
num_parts positions), else ``k = num_parts / len(devices)`` parts stacked
per position, in part order (the reference's parts-per-GPU overcommit,
gnn.cc:61-63).

The default mesh is the run's one device, so ``-parts 4`` on one card is
k = 4: the layout that lets a single card run the multi-part code paths
for real.  A caller may name the same device several times (``[cpu] * 8``
or ``[cuda:0] * 4``) to get roc_tpu's k = 1 layout on that one device,
which the balancer, the halo-overlap split, the ring and edge sharding
need.  Several devices are one process each on ``torch.distributed``
(``-multihost``, parallel/collectives.py): :func:`make_process_mesh` gives
one process its P / W consecutive positions, all on its one device, the
counterpart of roc_tpu's ``len(jax.local_devices())`` positions per
process.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

PARTS_AXIS = "parts"


def make_mesh(num_parts: int,
              devices: Sequence[torch.device]) -> List[torch.device]:
    """The mesh positions for ``num_parts`` parts over ``devices`` (the
    mesh roc_tpu's ``make_mesh`` builds over the same device list)."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    if len(set(devices)) != 1:
        raise ValueError(
            f"mesh over distinct devices {sorted(set(map(str, devices)))}: "
            "one process places parts on one device; several devices are "
            "one process each on torch.distributed (-multihost, "
            "make_process_mesh)")
    if num_parts <= len(devices):
        return devices[:num_parts]
    assert num_parts % len(devices) == 0, (
        f"num_parts={num_parts} must be a multiple of the device count "
        f"({len(devices)}) for parts-per-device overcommit")
    return devices


def make_process_mesh(num_parts: int, device,
                      world: int) -> List[torch.device]:
    """This process's positions of a ``num_parts`` mesh spread over
    ``world`` processes, one device each: P / W positions on ``device``
    (k = 1; overcommit is single-process only, as in roc_tpu)."""
    if num_parts % world:
        raise SystemExit(
            f"error: -parts {num_parts} must be a multiple of the "
            f"{world} -multihost processes (each holds -parts / W mesh "
            f"positions)")
    return [torch.device(device)] * (num_parts // world)
