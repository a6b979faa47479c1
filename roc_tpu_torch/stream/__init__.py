"""The out-of-core streaming executor (roc_tpu/stream): full-graph training
and serving for a graph whose data does not fit the card.

Shards live in host memory (pinned where a card is present) and rotate
through ``-stream-slots`` fixed device slots; the prefetch ring copies
shard i+1 to the card on a side CUDA stream while shard i computes.

  segments.py  the op IR split at its aggregations
  host.py      the pinned host-store allocator
  spill.py     the CRC'd memmap stores of -stream-spill
  ring.py      the prefetch ring
  executor.py  ``StreamTrainer``: the sweeps, the host stores, the slots

``incore_resident_bytes`` is the ``-stream-budget`` gate's estimate; the
memory planner's OFFLOAD verdict executes under ``-stream``.
"""

from __future__ import annotations

from roc_tpu_torch.stream.ring import PrefetchRing
from roc_tpu_torch.stream.segments import Segment, split_segments

__all__ = ["PrefetchRing", "Segment", "split_segments",
           "incore_resident_bytes", "StreamTrainer"]


def incore_resident_bytes(dataset) -> int:
    """What the in-core path keeps placed for ``dataset``: fp32 features,
    one-hot labels, mask and in-degree per node, and two int32 arrays per
    edge (stream/__init__.py:31-42).  Activations and parameters are left
    out, so the gate is a floor."""
    g = dataset.graph
    n, e = int(g.num_nodes), int(g.num_edges)
    per_node = 4 * dataset.in_dim + 4 * dataset.num_classes + 4 + 4
    return n * per_node + 8 * e


def __getattr__(name):
    if name == "StreamTrainer":
        from roc_tpu_torch.stream.executor import StreamTrainer
        return StreamTrainer
    raise AttributeError(name)
