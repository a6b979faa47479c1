"""The op IR split at its aggregations, for shard streaming
(roc_tpu/stream/segments.py).

Every op but ``aggregate`` and ``gat`` is row-local: row r of its output
depends on row r of its input only, so it runs on one shard's rows alone.
The two aggregation kinds read a *source table* indexed by edge sources,
under streaming the ``[S + P*K]`` local+halo table the executor gathers
from the host stores.  A *segment* is one optional aggregation head and
the row-local ops up to the next head; segment 0 has no head.  The
executor runs each segment once per shard, and keeps its boundary outputs
in host stores between sweeps.

``split_segments`` and ``predicted_epoch_bytes`` are roc_tpu's, unchanged;
``run_segment`` dispatches as the port's ``Model.apply`` does, its head
through the CUDA sum and GAT kernels on the card (their plain versions on
the CPU) over the shard's rectangular CSR: S rows over S + P*K sources.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from roc_tpu_torch import ops
from roc_tpu_torch.memory.estimator import _op_out_dims
from roc_tpu_torch.models.model import Model, OpNode
from roc_tpu_torch.ops import prng

__all__ = ["Segment", "split_segments", "run_segment",
           "predicted_epoch_bytes"]

_HEAD_KINDS = ("aggregate", "gat")


@dataclasses.dataclass(frozen=True)
class Segment:
    """One streamable slice of the op IR.

    ``table_tid`` is the tensor the head reads through the local+halo
    table (-1 when headless); ``own_in_tids`` are earlier-produced
    tensors the body reads row-locally (only this shard's rows are
    needed); ``out_tids`` are tensors produced here that any later
    segment consumes — the executor persists exactly these to host."""

    index: int
    head: Optional[OpNode]
    body: Tuple[OpNode, ...]
    table_tid: int
    own_in_tids: Tuple[int, ...]
    out_tids: Tuple[int, ...]
    is_last: bool
    out_dims: Dict[int, int]


def split_segments(model: Model) -> List[Segment]:
    ops_list = list(model.ops)
    dims = _op_out_dims(model)
    head_pos = [i for i, op in enumerate(ops_list) if op.kind in _HEAD_KINDS]
    starts = [0] + head_pos
    ends = head_pos + [len(ops_list)]

    raw = []  # (head, body) per segment
    for k, (lo, hi) in enumerate(zip(starts, ends)):
        if k == 0:
            raw.append((None, tuple(ops_list[lo:hi])))
        else:
            raw.append((ops_list[lo], tuple(ops_list[lo + 1:hi])))

    produced = []
    for head, body in raw:
        p = {op.out for op in body}
        if head is not None:
            p.add(head.out)
        produced.append(p)

    # tid -> set of segment indices that consume it (as table or row-local)
    consumers: Dict[int, set] = {}
    for k, (head, body) in enumerate(raw):
        tids = set()
        if head is not None:
            tids.add(head.inputs[0])
        for op in body:
            tids.update(op.inputs)
        for t in tids:
            consumers.setdefault(t, set()).add(k)

    segs = []
    n = len(raw)
    for k, (head, body) in enumerate(raw):
        for op in body:
            assert op.kind not in _HEAD_KINDS, "aggregation op in segment body"
        own_in = sorted(
            t for op in body for t in op.inputs if t not in produced[k])
        outs = sorted(
            t for t in produced[k]
            if any(c > k for c in consumers.get(t, ())))
        touched = produced[k] | set(own_in)
        if head is not None:
            touched.add(head.inputs[0])
        segs.append(Segment(
            index=k,
            head=head,
            body=body,
            table_tid=head.inputs[0] if head is not None else -1,
            own_in_tids=tuple(dict.fromkeys(own_in)),
            out_tids=tuple(outs),
            is_last=(k == n - 1),
            out_dims={t: dims[t] for t in touched},
        ))
    return segs


def predicted_epoch_bytes(segments: List[Segment], parts: int,
                          shard_nodes: int, shard_edges: int, halo_k: int,
                          num_classes: int, *, act_itemsize: int = 4,
                          esrc_itemsize: int = 4,
                          edst_itemsize: int = 4) -> int:
    """Analytic bytes the executor's ``_fetch`` ships in one training
    epoch: the sweep schedule ((nseg-1) fwd + nseg bwd), each sweep
    rotating all ``parts`` shards, priced from the same store shapes
    ``_fetch`` slices.  ``act_itemsize`` is the streamed storage dtype's
    width (2 under -bf16-storage) and covers every float wire — tables,
    own rows, labels, and the cotangent fetch; in-degrees stay fp32 and
    the mask int32.  The edge wire is roc_tpu's two index arrays; the
    port ships each shard's CSR instead, which
    ``StreamTrainer.predicted_epoch_xfer_bytes`` prices beside this."""
    n = len(segments)
    P, S, E, K = int(parts), int(shard_nodes), int(shard_edges), int(halo_k)
    sweeps = [("fwd", k) for k in range(n - 1)] + \
             [("bwd", k) for k in range(n - 1, -1, -1)]
    total = 0
    for phase, k in sweeps:
        seg = segments[k]
        b = E * (esrc_itemsize + edst_itemsize) + S * 4  # edges + indeg f32
        if seg.head is not None:
            b += (S + P * K) * seg.out_dims[seg.table_tid] * act_itemsize
        for t in seg.own_in_tids:
            b += S * seg.out_dims[t] * act_itemsize
        if seg.is_last:
            b += S * (num_classes * act_itemsize + 4)  # labels + mask i32
        if phase == "bwd" and not seg.is_last:
            for t in seg.out_tids:
                b += S * seg.out_dims[t] * act_itemsize
        total += b * P
    return int(total)


def run_segment(seg: Segment, params, table, own: Dict[int, object], csr,
                indeg, key, train: bool, backend: str = "kernel",
                precision: str = "fast"):
    """Run one segment for one shard, as ``Model.apply`` dispatches.

    ``table`` is the ``[S + P*K, d]`` source table (None for a headless
    segment), ``own`` maps tid -> this shard's ``[S, d]`` rows, ``csr`` the
    shard's ``ops.DeviceCsr`` (S rows over the table's rows; its transpose
    and edge map where a backward needs them), ``indeg`` the rows'
    in-degrees.  ``backend`` "kernel" runs the CUDA kernels on a CUDA
    tensor (their plain versions on the CPU) at ``precision``, "xla" the
    plain fp32 versions.  Returns every tid's value."""
    vals = dict(own)
    rows = indeg.shape[0]
    if seg.head is not None:
        op = seg.head
        if op.kind == "aggregate":
            if backend == "xla":
                out = ops.scatter_gather_plain(table, csr, op.attrs["aggr"],
                                               "exact")
            else:
                out = ops.scatter_gather(table, csr, op.attrs["aggr"],
                                         precision)
        else:  # gat
            name = op.attrs["param"]
            kk, fd = op.attrs["heads"], op.attrs["head_dim"]
            h_tab = ops.linear(table, params[name + "_w"]).reshape(-1, kk, fd)
            h = h_tab[:rows]
            if backend == "xla":
                dst = torch.repeat_interleave(
                    torch.arange(rows, device=h.device),
                    torch.diff(csr.row_ptr))
                out = ops.gat_attend(h, h_tab, csr.col_idx, dst, rows,
                                     params[name + "_asrc"],
                                     params[name + "_adst"],
                                     op.attrs["slope"])
            else:
                out = ops.gat_attend_kernel(h, h_tab, params[name + "_asrc"],
                                            params[name + "_adst"], csr,
                                            op.attrs["slope"], precision)
            out = out.reshape(rows, kk * fd)
        vals[op.out] = out

    for op in seg.body:
        a = vals[op.inputs[0]]
        if op.kind == "dropout":
            live = train and op.attrs["rate"] != 0.0
            k = (prng.fold_in(key, op.attrs["slot"])
                 if live and key is not None else None)
            out = ops.dropout(a, op.attrs["rate"], train, k)
        elif op.kind == "linear":
            out = ops.linear(a, params[op.attrs["param"]],
                             op.attrs["activation"])
        elif op.kind == "norm":
            out = ops.indegree_norm(a, indeg)
        elif op.kind == "activation":
            out = ops.apply_activation(a, op.attrs["mode"])
        elif op.kind == "add":
            out = ops.add(a, vals[op.inputs[1]])
        else:  # split_segments keeps heads out of bodies
            raise ValueError(f"unstreamable op kind {op.kind!r}")
        vals[op.out] = out
    return vals
