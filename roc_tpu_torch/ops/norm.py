"""In-degree normalization (roc_tpu/ops/norm.py): ``x / sqrt(in_degree)``.

Applied before and after aggregation it gives the symmetric
D^-1/2 A D^-1/2 GCN propagation.  Degrees are >= 1 by construction
(self-edges), so there is no zero guard.  A bf16 x (-bf16) times the fp32
scale promotes to fp32, as jax promotes it: from GCN's first norm on, a
-bf16 run computes in fp32.
"""

from __future__ import annotations

import torch


def indegree_norm(x: torch.Tensor, in_degree: torch.Tensor) -> torch.Tensor:
    """x: [N, H]; in_degree: [N] float32."""
    return x * torch.rsqrt(in_degree)[:, None]
