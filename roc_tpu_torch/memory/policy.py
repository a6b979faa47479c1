"""A MemPlan as activation checkpointing (roc_tpu/memory/policy.py, whose
``jax.checkpoint`` with ``save_only_these_names`` becomes
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``).

The contract is roc_tpu's:
  * an all-KEEP plan wraps nothing: ``loss_fn`` returns ``model.loss``;
  * under an active plan only the saved outputs of KEEP layers
    (``ckpt_save``: linear, aggregate and gat outputs and the layer
    boundary) live from the forward to the backward, and everything else
    is recomputed from the nearest kept tensor.

The design, in PyTorch's idiom: :meth:`Model.units` (the dispatch order,
fused chains included) is cut after every unit whose output a KEEP layer
saves and at every layer's end, and each run of units between two cuts is
one checkpointed function whose inputs are the earlier tensors it reads
and whose outputs are the tensors later units read.  A REMAT layer is
thus one segment, recomputed whole in the backward.  Recomputation
re-draws the dropout masks from their keys and the kernels use no
atomics, so a planned run's gradients equal the unplanned run's bit for
bit (the kernels' launch counters count the recomputed launches).

Where PyTorch keeps more than the plan's saved set, :func:`crossing_tids`
names it: a checkpoint holds its inputs, so a segment's input that no
KEEP layer saves (a REMAT layer's boundary feeding the next layer, SAGE's
dropout output read by both of its branches) stays alive too.  The
estimator reports those bytes beside the plan's
(``estimator.port_resident_bytes`` is the other port-side term).

OFFLOAD layers run as REMAT, unless ``offload_to_host``: then they run
unwrapped under ``torch.autograd.graph.save_on_cpu`` (pinned on a card),
so their residuals wait in host memory for the backward.  roc_tpu sets
``offload_to_host`` only under ``-stream``, whose trainer never calls
``loss_fn``; the port keeps that, and ``MemPlan.offload_executes_as``
labels it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from roc_tpu_torch import ops
from roc_tpu_torch.memory.planner import KEEP, OFFLOAD, MemPlan


def _saved(model, plan: MemPlan, decisions) -> Set[int]:
    layers = {i for i, d in enumerate(plan.decisions) if d in decisions}
    return {op.out for op in model.ops
            if op.attrs.get("layer") in layers and op.attrs.get("ckpt_save")}


def segments(model, plan: MemPlan, units, offload_to_host: bool = False
             ) -> List[Tuple[list, bool]]:
    """The unit runs the plan checkpoints, in order: ``(units, wrapped)``;
    ``wrapped`` False for an OFFLOAD layer's units under
    ``offload_to_host``."""
    keep = (KEEP, OFFLOAD) if offload_to_host else (KEEP,)
    saved = _saved(model, plan, keep)
    decision = dict(enumerate(plan.decisions))
    out: List[Tuple[list, bool]] = []
    cur: list = []
    for j, u in enumerate(units):
        layer = u.final.attrs.get("layer", 0)
        cur.append(u)
        nxt = units[j + 1].final.attrs.get("layer", 0) \
            if j + 1 < len(units) else None
        if u.final.out in saved or nxt != layer:
            out.append((cur, not (offload_to_host
                                  and decision.get(layer) == OFFLOAD)))
            cur = []
    return out


def _reads(units) -> List[int]:
    made: Set[int] = set()
    reads: List[int] = []
    for u in units:
        for t in u.inputs:
            if t not in made and t not in reads:
                reads.append(t)
        made.add(u.final.out)
    return reads


def crossing_tids(model, plan: MemPlan, units) -> Set[int]:
    """Tensors a checkpoint keeps as its input that the plan does not save
    (and that are not the model input x)."""
    saved = _saved(model, plan, (KEEP,))
    out: Set[int] = set()
    for run, wrapped in segments(model, plan, units):
        if wrapped:
            out.update(t for t in _reads(run) if t not in saved and t != 0)
    return out


def planned_apply(model, plan: MemPlan, params: Dict[str, torch.Tensor],
                  x: torch.Tensor, gctx, key=None, train: bool = True,
                  offload_to_host: bool = False) -> torch.Tensor:
    """``model.apply`` with the plan's checkpointing: the logits."""
    units = model.gctx_units(gctx, train)
    runs = segments(model, plan, units, offload_to_host)
    later: Dict[int, int] = {}
    for r, (run, _) in enumerate(runs):
        for t in _reads(run):
            later[t] = r
    vals: Dict[int, torch.Tensor] = {0: x}
    logits = model.logits.id
    for r, (run, wrapped) in enumerate(runs):
        ins = _reads(run)
        outs = [u.final.out for u in run
                if later.get(u.final.out, -1) > r or u.final.out == logits]

        def fn(*tensors, run=run, ins=ins, outs=outs):
            local = dict(zip(ins, tensors))
            for u in run:
                local[u.final.out] = model.run_unit(u, local, params, gctx,
                                                    key, train)
            return tuple(local[t] for t in outs)

        args = [vals[t] for t in ins]
        if wrapped:
            res = checkpoint(fn, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            with torch.autograd.graph.save_on_cpu(
                    pin_memory=x.device.type == "cuda"):
                res = fn(*args)
        vals.update(zip(outs, res))
    return vals[logits]


def loss_fn(model, plan: Optional[MemPlan], offload_to_host: bool = False):
    """``model.loss`` under the plan: the model's own loss when the plan
    keeps everything (the program unplanned runs have), else the
    checkpointed forward then the masked softmax cross-entropy."""
    if plan is None or not plan.any_remat():
        return model.loss

    def planned_loss(params, x, labels, mask, gctx, key=None, train=True):
        logits = planned_apply(model, plan, params, x, gctx, key, train,
                               offload_to_host)
        return ops.masked_softmax_cross_entropy(logits, labels, mask)

    return planned_loss
