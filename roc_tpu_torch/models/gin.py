"""GIN-0 with degree normalization (roc_tpu/models/gin.py).  Per layer:

    t = dropout(t)
    t = sum over in-edges of t      # the self edge supplies (1 + eps) x_v,
                                    # eps = 0
    t = W2 relu(W1 t)               # the MLP
    t = t / sqrt(in_degree)
    (+ relu except on the output layer)
"""

from __future__ import annotations

from typing import Sequence

from roc_tpu_torch.models.model import Model


def build_gin(layers: Sequence[int], dropout_rate: float = 0.5) -> Model:
    if len(layers) < 2:
        raise ValueError(f"layers={list(layers)}: need in_dim and classes")
    model = Model(in_dim=layers[0])
    t = model.input
    for i in range(1, len(layers)):
        t = model.dropout(t, dropout_rate)
        t = model.scatter_gather(t, "sum")
        t = model.linear(t, layers[i], activation="relu")
        t = model.linear(t, layers[i])
        t = model.indegree_norm(t)
        if i != len(layers) - 1:
            t = model.relu(t)
        model.end_layer()
    model.softmax_cross_entropy(t)
    return model
