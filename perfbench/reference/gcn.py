"""GCN (Kipf and Welling 2017) as ROC's test.sh trains it, in plain fp32
PyTorch.  Per layer i: dropout (slot i-1), x W, D^-1/2 A D^-1/2 with A the
in-edge sum including self edges, relu on every layer but the last.  In
"fast" precision the sum's input is staged in bfloat16 (``Graph``).

It is the port's ``gcn-chain`` at any depth, and its ``gcn`` of two
layers: a deeper ``gcn`` adds a residual linear a layer, which this
model lacks, so its leaves are not the port's and set-up stops."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.counts import _widths, gemm_flops, least_s, step_totals, \
    sum_call
from perfbench.reference import prng


def leaves(cfg):
    """(name, shape, Glorot fan-in, fan-out) of each leaf in draw order:
    ``linear_i`` [in, out] a layer."""
    layers = [int(v) for v in cfg["layers"]]
    return [(f"linear_{i - 1}", (layers[i - 1], layers[i]), layers[i - 1],
             layers[i]) for i in range(1, len(layers))]


def counts(cfg, n: int, e: int, train: bool) -> dict:
    """One GEMM a layer, and the in-edge sum at the layer's output width:
    forward, and over the transpose in training."""
    widths = _widths(cfg, heads=1)
    sums = sum_least = 0.0
    for _, dout, _, _ in widths:
        for _ in range(2 if train else 1):
            ops, nbytes = sum_call(n, e, dout)
            sums += ops
            sum_least += least_s(ops, nbytes)
    return step_totals(gemm_flops(widths, n, train), sum_flops=sums,
                       sum_least_s=sum_least)


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
