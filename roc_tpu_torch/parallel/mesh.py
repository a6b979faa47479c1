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
which the balancer and the halo-overlap split need.  Several distinct
devices mean one process each on ``torch.distributed``; this module does
not place parts across devices.
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
            "one process each on torch.distributed (-multihost), which "
            "the port does not have yet")
    if num_parts <= len(devices):
        return devices[:num_parts]
    assert num_parts % len(devices) == 0, (
        f"num_parts={num_parts} must be a multiple of the device count "
        f"({len(devices)}) for parts-per-device overcommit")
    return devices
