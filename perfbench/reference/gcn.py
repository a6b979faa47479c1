"""GCN (Kipf and Welling 2017) as ROC's test.sh trains it, in plain fp32
PyTorch.  Per layer i: dropout (slot i-1), x W, D^-1/2 A D^-1/2 with A the
in-edge sum including self edges, relu on every layer but the last.  In
"fast" precision the sum's input is staged in bfloat16 (``Graph``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference import prng


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, graph, cfg,
            key: Optional[prng.Key] = None) -> torch.Tensor:
    """Logits [N, C].  ``key`` is the step's key (training, with
    dropout); None runs the eval forward."""
    layers = cfg["layers"]
    rate = float(cfg["dropout"])
    stage = cfg["precision"] == "fast"
    scale = torch.rsqrt(graph.deg)[:, None]
    t = x
    for i in range(1, len(layers)):
        if key is not None and rate > 0:
            t = prng.dropout(t, rate, prng.fold_in(key, i - 1))
        t = t @ params[f"linear_{i - 1}"]
        t = graph.aggregate(t * scale, stage) * scale
        if i != len(layers) - 1:
            t = torch.relu(t)
    return t
