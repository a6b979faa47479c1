"""GraphSAGE-mean (roc_tpu/models/sage.py).  Per layer:

    t      = dropout(t)
    self_  = W_self t
    neigh  = W_neigh (aggr over in-edges of t)   # avg by default; the graph
                                                 # has self edges, so the
                                                 # mean includes v itself
    t      = self_ + neigh          (+ relu except on the output layer)
"""

from __future__ import annotations

from typing import Sequence

from roc_tpu_torch.models.model import Model


def build_sage(layers: Sequence[int], dropout_rate: float = 0.5,
               aggr: str = "avg") -> Model:
    if len(layers) < 2:
        raise ValueError(f"layers={list(layers)}: need in_dim and classes")
    model = Model(in_dim=layers[0])
    t = model.input
    for i in range(1, len(layers)):
        t = model.dropout(t, dropout_rate)
        self_ = model.linear(t, layers[i])
        neigh = model.scatter_gather(t, aggr)
        neigh = model.linear(neigh, layers[i])
        t = model.add(self_, neigh)
        if i != len(layers) - 1:
            t = model.relu(t)
        model.end_layer()
    model.softmax_cross_entropy(t)
    return model
