"""The comparison that decides ``correct``: the numbers each kind of cell
compares with the plain reference, and their limits
(``perfbench/limits/<cell>.json``; PERF.md gives the readings each limit
was set from)."""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict


LIMITS_DIR = Path(__file__).resolve().parent / "limits"

# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam: left out of the change
STILL_LEAF = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys) -> list:
    """Each leaf's gap of norms, against the larger of that leaf's
    reference norm and the median leaf's."""
    med = statistics.median(ref[k] for k in ref)
    out = []
    for k in keys:
        den = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / den if den > 0 else abs(prog[k])
        out.append(gap if math.isfinite(gap) else math.inf)
    return out


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` hold ``losses`` (a list), ``grad1`` and
    ``change`` (a norm a leaf).

    Compared: the first step's loss, the worst leaf's first gradient, and
    the median leaf's change after the steps.  The later steps' losses and
    the worst leaf's change are worked out too (``loss2_gap``, ...,
    ``change_worst``) but not compared: the loss falls many times over in
    the first steps, so a later step's gap is the first step's rounding
    amplified, and a small leaf's change is Adam's sign noise on a few
    dozen elements; both swing from seed to seed (PERF.md gives the
    readings)."""
    out = {}
    for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"]), 1):
        gap = abs(p - r) / abs(r) if r else abs(p)
        out[f"loss{i}_gap"] = gap if math.isfinite(gap) else math.inf
    med = statistics.median(ref["grad1"].values())
    moving = [k for k in ref["change"]
              if ref["grad1"][k] >= STILL_LEAF * med]
    out["grad_gap"] = max(_leaf_gaps(prog["grad1"], ref["grad1"],
                                     ref["grad1"]))
    change = _leaf_gaps(prog["change"],
                        {k: ref["change"][k] for k in moving}, moving)
    out["change_gap"] = statistics.median(change)
    out["change_worst"] = max(change)
    return out


def limits_for(cell: str) -> Dict[str, float]:
    return json.loads((LIMITS_DIR / f"{cell}.json").read_text())["limits"]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [{name, value, limit}]) in the limits' order: every
    compared number has to be finite and within its limit."""
    rows, ok = [], True
    for name, lim in limits.items():
        val = numbers.get(name, math.inf)
        good = math.isfinite(val) and val <= lim
        ok = ok and good
        rows.append({"name": name, "value": val, "limit": lim})
    return ok, rows
