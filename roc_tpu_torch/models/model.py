"""Op-graph model builder (roc_tpu/models/model.py, the reference's Model
class).

The builder API emits a small op IR (``OpNode``s over ``TensorRef`` ids);
``apply`` runs it over tensors.  Aggregation goes through
``GraphCtx.aggregate``, which hides the graph data and the backend, and
graph attention through ``GraphCtx.attend``.  A ``GraphCtx.fuse_linear``
hook runs each :func:`mega_matches` layer chain as the whole-layer
megakernel, and a ``GraphCtx.fuse_region`` hook each :func:`mega_regions`
chain of such layers (a cross-layer fusion region, ``-fusion-depth``) as
one region kernel.

Every op is stamped, as roc_tpu stamps it for its memory planner
(model.py:355-373), with its layer, a stable checkpoint name ``ckpt``
(``L<layer>.<kind><out>``) and ``ckpt_save``: whether a kept layer saves
its output under an active memory plan (``CKPT_SAVE_KINDS``, and the layer
boundary).  :meth:`Model.units` is the dispatch order ``apply`` runs (an
op, or a fused megakernel or region chain answering for its ``final``
op); ``memory/policy.py`` cuts it at the saved tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from roc_tpu_torch import ops
from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.switches import (mega_bwd_killed, megafuse_killed,
                                        xlayer_killed)

# Op kinds whose outputs a kept layer saves under an active memory plan
# (model.py:40): expensive to recompute.  Elementwise outputs (dropout,
# norm, activation, add) are recomputed (memory/estimator.py).
CKPT_SAVE_KINDS = frozenset({"linear", "aggregate", "gat"})


class GraphCtx(NamedTuple):
    """Everything an op needs to know about the graph."""
    aggregate: Callable[[torch.Tensor, str], torch.Tensor]  # x, aggr -> out
    in_degree: torch.Tensor  # [N] float32, >= 1
    # whole-layer megakernel hook: (x, w, activation, aggr, fold) -> out.
    # When set, ``apply`` hands each ``mega_matches`` chain to it instead
    # of running the chain's ops one by one.
    fuse_linear: Optional[Callable] = None
    # graph attention: (h [N, K, F], a_src, a_dst, slope) -> [N, K, F]
    attend: Optional[Callable] = None
    # cross-layer fusion-region hook: (x, ws, activations, fold) -> out.
    # When set and fusion_depth != 1, ``apply`` hands each ``mega_regions``
    # chain (its weights and activations, head to tail) to it before the
    # per-layer ``fuse_linear`` match at the same op index.
    fuse_region: Optional[Callable] = None
    # region-length cap: 1 = off, 2 = chains of at most two layers, ...,
    # 0 = unlimited
    fusion_depth: int = 1
    # training dropout hook: (x, rate, key, slot) -> out, given the step's
    # key unfolded.  When set, it draws the masks in place of ``ops.dropout``
    # over ``fold_in(key, slot)`` (the SPMD trainer draws one mask per mesh
    # position, as roc_tpu's shard_map body does).
    dropout: Optional[Callable] = None


class Unit(NamedTuple):
    """One step of ``apply``'s dispatch: a single op (``fused`` None), or
    a ``mega_matches`` chain (``fused`` "match") or ``mega_regions`` chain
    ("region") dispatched at the op index ``index``.  It reads ``inputs``
    and produces ``final.out``; ``record`` is the fused chain's record."""
    index: int
    op: "OpNode"
    final: "OpNode"
    inputs: tuple
    fused: Optional[str] = None
    record: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """Symbolic handle returned by builder methods (the reference's Tensor)."""
    id: int
    dim: int


@dataclasses.dataclass(frozen=True)
class OpNode:
    kind: str                 # dropout|linear|norm|aggregate|gat|
                              # activation|add
    inputs: tuple             # input tensor ids
    out: int                  # output tensor id
    attrs: dict               # op-specific attributes


def mega_matches(model: "Model") -> Dict[int, dict]:
    """Megakernel-eligible layer chains in the op IR (model.py:89-191).

    Two shapes match.  The direct ``aggregate -> linear (-> relu)`` chain
    is keyed by the aggregate's op index.  The GCN chain ``linear -> norm
    -> aggregate -> norm (-> relu)`` is keyed by the linear's op index and
    carries ``fold=True``: ``indegree_norm`` is a positive diagonal row
    scale, so D^-1/2 A D^-1/2 (x W) = D^-1/2 (A ((D^-1/2 x) W)); the hook
    pre-scales the layer input, runs the fused kernel and post-scales, and
    relu commutes with the positive scale.

    Each record holds the matched ``aggregate`` and ``linear`` nodes, the
    activation ("none" or "relu"), ``final`` (the node whose output the
    fused op takes over), the op indices to ``skip``, ``fold``, and
    ``gone`` (the tensor ids that never materialize under fusion).

    Eligibility is structural: every intermediate feeds exactly one op in
    the same builder layer, the aggregate is sum or avg, the linear's own
    activation is none or relu (none for the folded shape), a trailing
    single-consumer relu folds into the epilogue, and no interior
    intermediate is the logits tensor.

    ``ROC_NO_MEGAFUSE=1`` (``ops.switches.megafuse_killed``) finds none,
    as roc_tpu's hook declines every layer (binned.py:2477).
    """
    if megafuse_killed():
        return {}
    consumers: Dict[int, List[int]] = {}
    for i, op in enumerate(model.ops):
        for t in op.inputs:
            consumers.setdefault(t, []).append(i)
    logits_id = model.logits.id if model.logits is not None else -1

    def sole(out_id, layer):
        """The single same-layer consumer of tensor ``out_id``, or None."""
        cons = consumers.get(out_id, [])
        if len(cons) != 1:
            return None, -1
        nxt = model.ops[cons[0]]
        if nxt.attrs.get("layer") != layer:
            return None, -1
        return nxt, cons[0]

    def trailing_relu(out_id, layer):
        """(relu node, its index) when ``out_id`` feeds only a relu."""
        nxt, ni = sole(out_id, layer)
        if (nxt is not None and nxt.kind == "activation"
                and nxt.attrs.get("mode") == "relu"):
            return nxt, ni
        return None, -1

    found: Dict[int, dict] = {}
    for i, op in enumerate(model.ops):
        if op.kind != "aggregate" or op.attrs.get("aggr") not in ("sum",
                                                                  "avg"):
            continue
        if op.out == logits_id:
            continue
        layer = op.attrs.get("layer")
        lin, li = sole(op.out, layer)
        if (lin is None or lin.kind != "linear"
                or lin.attrs.get("activation") not in ("none", "relu")):
            continue
        activation, skip, final = lin.attrs["activation"], [li], lin
        if activation == "none" and lin.out != logits_id:
            relu, ri = trailing_relu(lin.out, layer)
            if relu is not None:
                activation, final = "relu", relu
                skip.append(ri)
        found[i] = {"aggregate": op, "linear": lin,
                    "activation": activation, "final": final,
                    "skip": tuple(skip), "fold": False,
                    "gone": (op.out,) + ((lin.out,)
                                         if final is not lin else ())}
    for i, op in enumerate(model.ops):
        if (op.kind != "linear" or op.attrs.get("activation") != "none"
                or op.out == logits_id):
            continue
        layer = op.attrs.get("layer")
        n1, i1 = sole(op.out, layer)
        if n1 is None or n1.kind != "norm" or n1.out == logits_id:
            continue
        agg, ia = sole(n1.out, layer)
        if (agg is None or agg.kind != "aggregate"
                or agg.attrs.get("aggr") not in ("sum", "avg")
                or agg.out == logits_id):
            continue
        n2, i2 = sole(agg.out, layer)
        if n2 is None or n2.kind != "norm":
            continue
        activation, skip, final = "none", [i1, ia, i2], n2
        if n2.out != logits_id:
            relu, ri = trailing_relu(n2.out, layer)
            if relu is not None:
                activation, final = "relu", relu
                skip.append(ri)
        found[i] = {"aggregate": agg, "linear": op,
                    "activation": activation, "final": final,
                    "skip": tuple(skip), "fold": True,
                    "gone": (op.out, agg.out) + ((n2.out,)
                                                 if final is not n2 else ())}
    return found


def mega_regions(model: "Model", max_depth: int = 0,
                 train: bool = False) -> Dict[int, dict]:
    """Chain ``mega_matches`` records into multi-layer fusion regions
    (model.py:219-337): aggregate -> linear (-> relu) -> aggregate ->
    linear ..., keyed by the first member's head-op index (the index
    ``apply`` dispatches on).

    A link exists when member l's ``final`` output reaches member l+1's
    head op through single-consumer identity dropouts only (rate 0, or any
    rate when ``train`` is False).  Every member aggregates with ``sum``
    (avg's division runs outside the kernel), ``fold`` is the same across
    members, and no member's ``final`` output is the logits tensor: the
    classifier layer never joins a region.

    ``max_depth``: 1 disables chaining ({}), N caps chains at N members, 0
    means unlimited.  Chains are maximal under the cap and greedy from the
    earliest head, so the partition is deterministic.

    Each record holds ``members`` (the ordered per-layer match records),
    ``final`` (the last member's final node), ``skip`` (every op index the
    region replaces except the dispatch head), ``fold``, and ``gone`` (the
    members' ``gone`` tensors plus the interior boundaries and dropout
    outputs that never materialize).

    ``ROC_XLAYER=0`` finds none, and so does ``ROC_MEGA_BWD=0``: roc_tpu's
    region declines without the fused backward (binned.py:3618), leaving
    the per-layer megakernels (``ops/switches.py``).
    """
    if max_depth == 1 or xlayer_killed() or mega_bwd_killed():
        return {}
    matches = mega_matches(model)
    if not matches:
        return {}
    consumers: Dict[int, List[int]] = {}
    for i, op in enumerate(model.ops):
        for t in op.inputs:
            consumers.setdefault(t, []).append(i)
    logits_id = model.logits.id if model.logits is not None else -1

    def eligible(m):
        return (m["aggregate"].attrs.get("aggr") == "sum"
                and m["final"].out != logits_id)

    # next-link map: head index -> (next head index, interstitial op
    # indices, interstitial output tensor ids)
    nxt: Dict[int, tuple] = {}
    for i, m in matches.items():
        if not eligible(m):
            continue
        tid, inter_ops, inter_outs = m["final"].out, [], []
        while True:
            cons = consumers.get(tid, [])
            if len(cons) != 1:
                break
            ci = cons[0]
            op = model.ops[ci]
            if op.inputs[0] != tid:
                break
            if ci in matches and eligible(matches[ci]):
                nxt[i] = (ci, tuple(inter_ops), tuple(inter_outs))
                break
            if op.kind == "dropout" and (op.attrs.get("rate") == 0.0
                                         or not train):
                inter_ops.append(ci)
                inter_outs.append(op.out)
                tid = op.out
                continue
            break

    # greedy maximal chains in ascending head order: links only run forward
    # in the (topologically ordered) op list
    preds = {j: i for i, (j, _, _) in nxt.items()}
    found: Dict[int, dict] = {}
    used: set = set()
    for h in sorted(set(nxt) | set(preds)):
        if h in used:
            continue
        p = preds.get(h)
        if p is not None and p not in used:
            continue
        fold = matches[h]["fold"]
        chain, i = [h], h
        while i in nxt and (max_depth == 0 or len(chain) < max_depth):
            j = nxt[i][0]
            if j in used or matches[j]["fold"] != fold:
                break
            chain.append(j)
            i = j
        used.update(chain)
        if len(chain) < 2:
            continue
        members = tuple(matches[k] for k in chain)
        skip: List[int] = list(members[0]["skip"])
        gone: List[int] = list(members[0]["gone"])
        for k_prev, k in zip(chain, chain[1:]):
            _, inter_ops, inter_outs = nxt[k_prev]
            skip.extend(inter_ops)
            gone.extend(inter_outs)
            gone.append(matches[k_prev]["final"].out)
            skip.append(k)
            skip.extend(matches[k]["skip"])
            gone.extend(matches[k]["gone"])
        found[h] = {"members": members, "final": members[-1]["final"],
                    "fold": fold, "skip": tuple(skip),
                    "gone": tuple(dict.fromkeys(gone))}
    return found


class Model:
    """Builder + applier for a GNN op graph over node tensors."""

    def __init__(self, in_dim: int):
        self._next_id = 1
        self.input = TensorRef(0, in_dim)
        self.ops: List[OpNode] = []
        self.logits: Optional[TensorRef] = None
        self.num_linear = 0
        self.num_dropout = 0
        self._cur_layer = 0

    # -- builder API (names mirror the reference's Model methods) ---------
    def _new(self, dim: int) -> TensorRef:
        t = TensorRef(self._next_id, dim)
        self._next_id += 1
        return t

    def _emit(self, op: OpNode) -> None:
        """Append ``op`` stamped with its layer index, its checkpoint name
        and whether a kept layer saves its output under a memory plan."""
        op.attrs["layer"] = self._cur_layer
        op.attrs["ckpt"] = f"L{self._cur_layer}.{op.kind}{op.out}"
        op.attrs["ckpt_save"] = op.kind in CKPT_SAVE_KINDS
        self.ops.append(op)

    def end_layer(self) -> None:
        """Close the current GNN layer: the last emitted op becomes the
        layer boundary (always saved under an active plan: it is the next
        layer's input), and the next layer index starts."""
        if self.ops and self.ops[-1].attrs["layer"] == self._cur_layer:
            self.ops[-1].attrs["ckpt_boundary"] = True
            self.ops[-1].attrs["ckpt_save"] = True
        self._cur_layer += 1

    @property
    def num_layers(self) -> int:
        return max(self._cur_layer, 1)

    def dropout(self, t: TensorRef, rate: float) -> TensorRef:
        out = self._new(t.dim)
        self._emit(OpNode("dropout", (t.id,), out.id,
                          {"rate": rate, "slot": self.num_dropout}))
        self.num_dropout += 1
        return out

    def linear(self, t: TensorRef, out_dim: int,
               activation: str = "none") -> TensorRef:
        out = self._new(out_dim)
        self._emit(OpNode("linear", (t.id,), out.id,
                          {"in_dim": t.dim, "out_dim": out_dim,
                           "activation": activation,
                           "param": f"linear_{self.num_linear}"}))
        self.num_linear += 1
        return out

    def indegree_norm(self, t: TensorRef) -> TensorRef:
        out = self._new(t.dim)
        self._emit(OpNode("norm", (t.id,), out.id, {}))
        return out

    def scatter_gather(self, t: TensorRef, aggr: str = "sum") -> TensorRef:
        out = self._new(t.dim)
        self._emit(OpNode("aggregate", (t.id,), out.id, {"aggr": aggr}))
        return out

    def gat(self, t: TensorRef, head_dim: int, heads: int = 1,
            slope: float = 0.2) -> TensorRef:
        """Multi-head graph-attention layer: the W projection, then
        attention aggregation, heads concatenated."""
        out = self._new(head_dim * heads)
        self._emit(OpNode("gat", (t.id,), out.id,
                          {"in_dim": t.dim, "head_dim": head_dim,
                           "heads": heads, "slope": slope,
                           "param": f"gat_{self.num_linear}"}))
        self.num_linear += 1
        return out

    def relu(self, t: TensorRef) -> TensorRef:
        return self._activation(t, "relu")

    def sigmoid(self, t: TensorRef) -> TensorRef:
        return self._activation(t, "sigmoid")

    def elu(self, t: TensorRef) -> TensorRef:
        return self._activation(t, "elu")

    def _activation(self, t: TensorRef, mode: str) -> TensorRef:
        out = self._new(t.dim)
        self._emit(OpNode("activation", (t.id,), out.id, {"mode": mode}))
        return out

    def add(self, a: TensorRef, b: TensorRef) -> TensorRef:
        if a.dim != b.dim:
            raise ValueError(f"add of widths {a.dim} and {b.dim}")
        out = self._new(a.dim)
        self._emit(OpNode("add", (a.id, b.id), out.id, {}))
        return out

    def softmax_cross_entropy(self, t: TensorRef) -> TensorRef:
        """Marks ``t`` as the logits tensor."""
        self.logits = t
        return t

    # -- parameters -------------------------------------------------------
    def init_params(self, key: prng.Key,
                    device=None) -> Dict[str, torch.Tensor]:
        """Glorot-uniform, roc_tpu's parameters bit for bit
        (model.py:449-472): the i-th linear or gat op draws from
        ``fold_in(key, i)``; a linear op its ``[in, out]`` weight, a gat op
        its ``_w`` ``[in, K*F]``, then ``_asrc`` and ``_adst`` ``[K, F]``
        from ``fold_in(k, 1)`` and ``fold_in(k, 2)`` (each drawn as a
        ``[K*F, 1]`` Glorot matrix)."""
        params = {}
        i = 0
        for op in self.ops:
            a = op.attrs
            if op.kind == "linear":
                params[a["param"]] = ops.glorot_uniform(
                    prng.fold_in(key, i), a["in_dim"], a["out_dim"],
                    device=device)
                i += 1
            elif op.kind == "gat":
                k = prng.fold_in(key, i)
                kf = a["heads"] * a["head_dim"]
                params[a["param"] + "_w"] = ops.glorot_uniform(
                    k, a["in_dim"], kf, device=device)
                for j, suffix in enumerate(("_asrc", "_adst")):
                    params[a["param"] + suffix] = ops.glorot_uniform(
                        prng.fold_in(k, j + 1), kf, 1,
                        device=device).reshape(a["heads"], a["head_dim"])
                i += 1
        return params

    # -- execution --------------------------------------------------------
    def units(self, fuse_linear: bool = False, fuse_region: bool = False,
              fusion_depth: int = 1, train: bool = False) -> List[Unit]:
        """``apply``'s dispatch order: with ``fuse_region`` and a fusion
        depth other than 1 each ``mega_regions`` chain is one unit, with
        ``fuse_linear`` each remaining ``mega_matches`` chain, and every
        other op its own."""
        matches = mega_matches(self) if fuse_linear else {}
        regions = (mega_regions(self, fusion_depth, train)
                   if fuse_region and fusion_depth != 1 else {})
        out: List[Unit] = []
        skipped: set = set()
        for idx, op in enumerate(self.ops):
            if idx in skipped:
                continue
            for kind, found in (("region", regions), ("match", matches)):
                if idx in found:
                    r = found[idx]
                    out.append(Unit(idx, op, r["final"], op.inputs[:1],
                                    kind, r))
                    skipped.update(r["skip"])
                    break
            else:
                out.append(Unit(idx, op, op, op.inputs))
        return out

    def gctx_units(self, gctx: GraphCtx, train: bool) -> List[Unit]:
        return self.units(gctx.fuse_linear is not None,
                          gctx.fuse_region is not None, gctx.fusion_depth,
                          train)

    def run_unit(self, u: Unit, vals: Dict[int, torch.Tensor],
                 params: Dict[str, torch.Tensor], gctx: GraphCtx,
                 key: Optional[prng.Key], train: bool) -> torch.Tensor:
        """One unit's output from the tensors in ``vals``."""
        op = u.op
        a = vals[op.inputs[0]]
        if u.fused == "region":
            r = u.record
            return gctx.fuse_region(
                a, tuple(params[m["linear"].attrs["param"]]
                         for m in r["members"]),
                tuple(m["activation"] for m in r["members"]), r["fold"])
        if u.fused == "match":
            m = u.record
            return gctx.fuse_linear(
                a, params[m["linear"].attrs["param"]], m["activation"],
                m["aggregate"].attrs["aggr"], m["fold"])
        if op.kind == "dropout":
            live = train and op.attrs["rate"] != 0.0
            if live and gctx.dropout is not None:
                if key is None:
                    raise ValueError("training dropout needs a PRNG key")
                return gctx.dropout(a, op.attrs["rate"], key,
                                    op.attrs["slot"])
            k = (prng.fold_in(key, op.attrs["slot"])
                 if live and key is not None else None)
            return ops.dropout(a, op.attrs["rate"], train, k)
        if op.kind == "linear":
            return ops.linear(a, params[op.attrs["param"]],
                              op.attrs["activation"])
        if op.kind == "norm":
            return ops.indegree_norm(a, gctx.in_degree)
        if op.kind == "aggregate":
            return gctx.aggregate(a, op.attrs["aggr"])
        if op.kind == "gat":
            if gctx.attend is None:
                raise ValueError("this GraphCtx has no attention")
            name, k, f = (op.attrs["param"], op.attrs["heads"],
                          op.attrs["head_dim"])
            h = ops.linear(a, params[name + "_w"]).reshape(-1, k, f)
            return gctx.attend(h, params[name + "_asrc"],
                               params[name + "_adst"],
                               op.attrs["slope"]).reshape(-1, k * f)
        if op.kind == "activation":
            return ops.apply_activation(a, op.attrs["mode"])
        if op.kind == "add":
            return ops.add(a, vals[op.inputs[1]])
        raise ValueError(f"unknown op kind {op.kind!r}")

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
              gctx: GraphCtx, key: Optional[prng.Key] = None,
              train: bool = False) -> torch.Tensor:
        """Run the op list; returns logits [N, C].  Training dropout slot s
        draws its mask from ``fold_in(key, s)``, as roc_tpu's does.  With
        ``gctx.fuse_region`` set and a fusion depth other than 1, each
        ``mega_regions`` chain runs through that hook; with
        ``gctx.fuse_linear`` set, each remaining ``mega_matches`` chain
        runs through its own (model.py:486-523)."""
        if self.logits is None:
            raise ValueError("call softmax_cross_entropy() last")
        vals: Dict[int, torch.Tensor] = {0: x}
        for u in self.gctx_units(gctx, train):
            vals[u.final.out] = self.run_unit(u, vals, params, gctx, key,
                                              train)
        return vals[self.logits.id]

    def loss(self, params, x, labels, mask, gctx,
             key: Optional[prng.Key] = None,
             train: bool = True) -> torch.Tensor:
        """The masked softmax cross-entropy (a sum over train rows) of the
        model's logits."""
        logits = self.apply(params, x, gctx, key=key, train=train)
        return ops.masked_softmax_cross_entropy(logits, labels, mask)
