"""Exact DP over per-layer retention decisions (roc_tpu/memory/planner.py,
ROC's Algorithm 2): KEEP, REMAT or OFFLOAD per layer, the least predicted
step time under a per-device byte budget.  Pure Python, roc_tpu's bit for
bit (its JSON too); only the two device probes at the end are the port's.

  peak(d) = fixed + sum_{keep} saved_i + max_{remat} full_i
  time(d) = base                                  if no layer remats
          = base + sum_{keep} cheap_i
                 + sum_{remat} full_i             otherwise

For a plan with at least one remat, order the layers by (bytes_full,
index) descending: the first remat in that order fixes the transient term
and forces everything before it to KEEP, and the rest is a 0/1 knapsack,
solved exactly with Pareto-pruned states.  Past ``DP_MAX_LAYERS`` layers
a density-greedy pack takes over.

OFFLOAD marks a remat whose saved bytes round-trip to host memory faster
than its layer recomputes.  It executes only under ``-stream``
(``MemPlan.offload_executes_as``: "stream-host", or "stream-spill" under
``-stream-spill``); without ``-stream`` it runs as remat, and the plan says
"remat".
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

from roc_tpu_torch.memory.estimator import ModelEstimate

KEEP = "keep"
REMAT = "remat"
OFFLOAD = "offload"     # host round-trip beats recompute; executes as
                        # stream-host residency under -stream, as REMAT
                        # otherwise (MemPlan.offload_executes_as says which)

# Beyond this many layers the exact DP (L knapsacks, Pareto states) gives
# way to the greedy pack.  GNNs in this repo are 2-8 layers.
DP_MAX_LAYERS = 16
# Host-DMA round-trip bandwidth used only to flag offload candidates
# (PCIe-class; deliberately conservative).
OFFLOAD_BYTES_PER_S = 5e10
# NVMe-class round-trip bandwidth for the spill tier (-stream-spill):
# when boundary stores live on disk, an OFFLOAD verdict's bytes pay the
# slower device, so fewer layers clear the recompute-beats-transfer bar.
SPILL_BYTES_PER_S = 3e9


@dataclasses.dataclass(frozen=True)
class MemPlan:
    """A compiled retention plan plus its predicted costs."""

    mode: str                       # keep | remat | auto (the -mem-plan ask)
    budget_bytes: int               # 0 = unbounded
    decisions: Tuple[str, ...]      # per layer: keep | remat | offload
    layer_names: Tuple[str, ...]
    predicted_peak_bytes: int
    predicted_step_s: float
    keep_peak_bytes: int            # all-KEEP baseline
    keep_step_s: float
    remat_peak_bytes: int           # all-REMAT baseline
    remat_step_s: float
    planner: str                    # fixed | dp | greedy
    feasible: bool                  # predicted peak <= budget (or no budget)
    # how an OFFLOAD verdict executes in this run: "stream-host" when the
    # stream executor is active, "remat" otherwise (the honest default)
    offload_executes_as: str = REMAT

    def any_remat(self) -> bool:
        return any(d != KEEP for d in self.decisions)

    def any_offload(self) -> bool:
        return any(d == OFFLOAD for d in self.decisions)

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "budget_bytes": self.budget_bytes,
            "decisions": list(self.decisions),
            "layer_names": list(self.layer_names),
            # roclint: allow(unledgered-prediction) serialized plan field (roc_tpu's key in the plan's JSON), not a new prediction site
            "predicted_peak_bytes": self.predicted_peak_bytes,
            # roclint: allow(unledgered-prediction) serialized plan field (roc_tpu's key in the plan's JSON), not a new prediction site
            "predicted_step_s": round(self.predicted_step_s, 9),
            "keep_peak_bytes": self.keep_peak_bytes,
            "keep_step_s": round(self.keep_step_s, 9),
            "remat_peak_bytes": self.remat_peak_bytes,
            "remat_step_s": round(self.remat_step_s, 9),
            "planner": self.planner,
            "feasible": self.feasible,
            "offload_executes_as": self.offload_executes_as,
        }

    def to_json(self) -> str:
        """Deterministic serialization: the same plan, the same bytes."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")) + "\n"

    def summary(self) -> str:
        dec = " ".join(f"{n}={d}" for n, d in zip(self.layer_names,
                                                  self.decisions))
        off = ""
        if self.any_offload():
            off = f" (offload executes-as-{self.offload_executes_as})"
        return (f"mem-plan[{self.mode}/{self.planner}] {dec} "
                f"peak={self.predicted_peak_bytes / 1e6:.1f}MB"
                f"{'' if self.feasible else ' OVER-BUDGET'} "
                f"(keep={self.keep_peak_bytes / 1e6:.1f}MB) "
                f"step=+{(self.predicted_step_s / max(self.keep_step_s, 1e-12) - 1) * 100:.1f}%"
                f"{off}")


def predict_peak(est: ModelEstimate, decisions: Sequence[str]) -> int:
    """Predicted per-device peak bytes under a decision vector."""
    kept = sum(l.bytes_saved for l, d in zip(est.layers, decisions)
               if d == KEEP)
    remat = [l.bytes_full for l, d in zip(est.layers, decisions)
             if d != KEEP]
    if not remat:   # all-KEEP runs unwrapped: full residuals stay live
        return est.fixed_bytes + est.total_full_bytes()
    return est.fixed_bytes + kept + max(remat)


def predict_time(est: ModelEstimate, decisions: Sequence[str]) -> float:
    """Predicted step seconds under a decision vector."""
    if not any(d != KEEP for d in decisions):
        return est.base_step_s
    extra = sum(l.recompute_full_s if d != KEEP else l.recompute_cheap_s
                for l, d in zip(est.layers, decisions))
    return est.base_step_s + extra


def feasible(est: ModelEstimate, decisions: Sequence[str],
             budget_bytes: int) -> bool:
    return budget_bytes <= 0 or predict_peak(est, decisions) <= budget_bytes


def _knapsack(items, budget: int):
    """Exact 0/1 knapsack: items [(weight, value, idx)], weights/budget in
    bytes.  Returns (best_value, chosen idx frozenset).  Pareto-pruned
    state list — exact, and small in practice (layer counts <= 16)."""
    states = [(0, 0.0, frozenset())]       # (weight, value, chosen)
    for w, v, idx in items:
        merged = dict()
        for weight, value, chosen in states:
            for nw, nv, nc in ((weight, value, chosen),
                               (weight + w, value + v, chosen | {idx})):
                if nw > budget:
                    continue
                cur = merged.get(nw)
                # deterministic tie-break: higher value, then fewer kept,
                # then lexicographically smallest index set
                cand = (nv, -len(nc), tuple(sorted(nc)))
                if cur is None or (cand[0], cand[1], cand[2]) > \
                        (cur[1], -len(cur[2]), tuple(sorted(cur[2]))):
                    merged[nw] = (nw, nv, nc)
        # Pareto prune: increasing weight must strictly increase value
        pruned = []
        best = -1.0
        for wgt in sorted(merged):
            st = merged[wgt]
            if st[1] > best:
                pruned.append(st)
                best = st[1]
        states = pruned
    return max(states, key=lambda s: (s[1], -s[0]))[1:]


def _plan_auto(est: ModelEstimate, budget_bytes: int):
    """Minimize predict_time subject to predict_peak <= budget.  Returns
    (decisions list, planner name)."""
    L = len(est.layers)
    all_keep = [KEEP] * L
    if feasible(est, all_keep, budget_bytes):
        return all_keep, "dp"     # base time is the global minimum
    if L > DP_MAX_LAYERS:
        return _plan_greedy(est, budget_bytes), "greedy"
    # Order by (bytes_full, index) desc; candidate k = first rematted
    # layer in this order (fixes the transient term, forces 0..k-1 KEEP).
    order = sorted(range(L), key=lambda i: (-est.layers[i].bytes_full, i))
    best = None    # (time, decisions)
    for k in range(L):
        lk = est.layers[order[k]]
        head = budget_bytes - est.fixed_bytes - lk.bytes_full - \
            sum(est.layers[order[j]].bytes_saved for j in range(k))
        if head < 0:
            continue
        free = order[k + 1:]
        items = [(est.layers[i].bytes_saved,
                  est.layers[i].recompute_full_s
                  - est.layers[i].recompute_cheap_s, i) for i in free]
        _, chosen = _knapsack(items, head)
        decisions = list(all_keep)
        decisions[order[k]] = REMAT
        for i in free:
            if i not in chosen:
                decisions[i] = REMAT
        t = predict_time(est, decisions)
        if feasible(est, decisions, budget_bytes) and \
                (best is None or t < best[0] - 1e-15):
            best = (t, decisions)
    if best is None:
        # even all-REMAT is over budget: ship it anyway (least-peak plan)
        # and let the caller surface the infeasibility
        return [REMAT] * L, "dp"
    return best[1], "dp"


def _plan_greedy(est: ModelEstimate, budget_bytes: int):
    """Density-greedy fallback for deep models: start all-REMAT, re-KEEP
    layers by avoided-recompute per saved byte while the budget holds."""
    L = len(est.layers)
    decisions = [REMAT] * L
    order = sorted(
        range(L),
        key=lambda i: (-(est.layers[i].recompute_full_s
                         - est.layers[i].recompute_cheap_s)
                       / max(est.layers[i].bytes_saved, 1), i))
    for i in order:
        trial = list(decisions)
        trial[i] = KEEP
        if feasible(est, trial, budget_bytes):
            decisions = trial
    return decisions


def _mark_offload(est: ModelEstimate, decisions,
                  bytes_per_s: float = OFFLOAD_BYTES_PER_S):
    """Relabel remats whose round-trip to the offload tier (host DMA by
    default, NVMe under the spill tier) would beat recomputing."""
    out = []
    for l, d in zip(est.layers, decisions):
        if d == REMAT:
            transfer = 2.0 * l.bytes_saved / bytes_per_s
            if transfer < l.recompute_full_s - l.recompute_cheap_s:
                d = OFFLOAD
        out.append(d)
    return out


def plan_memory(est: ModelEstimate, mode: str = "auto",
                budget_bytes: int = 0,
                offload_executed: bool = False,
                offload_spills: bool = False) -> MemPlan:
    """Compile a :class:`MemPlan` for the given estimates.

    ``mode="keep"`` / ``"remat"`` pin every layer (budget ignored);
    ``"auto"`` runs the DP under ``budget_bytes`` (0 = unbounded, which
    makes all-KEEP optimal by construction).  ``offload_executed`` records
    whether this run's executor actually moves OFFLOAD bytes to host
    (the stream executor does; the in-core ones execute them as remat).
    ``offload_spills`` prices the round-trip at the NVMe tier
    (-stream-spill: boundary stores live on disk, so OFFLOAD's bytes ride
    the slower device and must beat recompute at SPILL_BYTES_PER_S).
    """
    L = len(est.layers)
    if mode == "keep":
        decisions, planner = [KEEP] * L, "fixed"
    elif mode == "remat":
        decisions, planner = [REMAT] * L, "fixed"
    elif mode == "auto":
        decisions, planner = _plan_auto(est, int(budget_bytes))
    else:
        raise ValueError(f"mem plan mode {mode!r}: must be keep|remat|auto")
    decisions = _mark_offload(
        est, decisions,
        SPILL_BYTES_PER_S if offload_spills else OFFLOAD_BYTES_PER_S)
    all_keep, all_remat = [KEEP] * L, [REMAT] * L
    return MemPlan(
        mode=mode, budget_bytes=int(budget_bytes),
        decisions=tuple(decisions),
        layer_names=tuple(l.name for l in est.layers),
        predicted_peak_bytes=predict_peak(est, decisions),
        predicted_step_s=predict_time(est, decisions),
        keep_peak_bytes=predict_peak(est, all_keep),
        keep_step_s=predict_time(est, all_keep),
        remat_peak_bytes=predict_peak(est, all_remat) if L else 0,
        remat_step_s=predict_time(est, all_remat),
        planner=planner,
        feasible=feasible(est, decisions, int(budget_bytes)),
        offload_executes_as=("stream-spill" if offload_executed
                             and offload_spills else
                             "stream-host" if offload_executed else REMAT),
    )


def device_budget_bytes(device=None) -> int:
    """The card's own memory on ``device`` (the current CUDA device when
    None); 0 on the CPU, where there is no device budget."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0
    return int(torch.cuda.get_device_properties(dev).total_memory)


def measured_peak_bytes(device=None) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` on ``device``; None on the CPU,
    which keeps no allocator statistics."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated(dev))
