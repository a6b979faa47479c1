"""Per-step metrics (roc_tpu/obs/channel.py): the norms the trainer reports
once per epoch.  roc_tpu computes them inside its jitted step; here they
are tensors on the device, read after the epoch's timed window."""

from __future__ import annotations

from typing import Dict

import torch


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over every tensor of a dict (fp32 accumulation)."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros(())
    total = sum(torch.sum(torch.square(t.to(torch.float32))) for t in leaves)
    return torch.sqrt(total)
