"""Graph Attention Network (roc_tpu/models/gat.py; Velickovic et al.,
ICLR'18) on the op IR.

Per hidden layer:
    t = dropout(t)
    t = gat(t, head_dim, heads)   # multi-head, concatenated
    t = elu(t)
Output layer: dropout, then a single head sized to num_classes, then the
softmax cross-entropy.
"""

from __future__ import annotations

from typing import Sequence

from roc_tpu_torch.models.model import Model


def build_gat(layers: Sequence[int], dropout_rate: float = 0.5,
              heads: int = 8, slope: float = 0.2) -> Model:
    """layers = [in_dim, hidden..., num_classes]; hidden widths are per head
    (a hidden layer's output is heads * width)."""
    if len(layers) < 2:
        raise ValueError(f"layers={list(layers)}: need in_dim and classes")
    model = Model(in_dim=layers[0])
    t = model.input
    for i in range(1, len(layers)):
        last = i == len(layers) - 1
        t = model.dropout(t, dropout_rate)
        t = model.gat(t, layers[i], heads=1 if last else heads, slope=slope)
        if not last:
            t = model.elu(t)
        model.end_layer()
    model.softmax_cross_entropy(t)
    return model
