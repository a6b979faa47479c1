"""Refit: re-solve the launch model's rates from trial records
(roc_tpu/tune/refit.py:60-185 retargeted).

The analytic model prices a sum launch as

    t = byte_s * byte_col + row_s * row_col

(``surrogate.analytic_seconds``: the gathered bytes over the lane use, and
the lane-group rows), so recovering the rates is a two-column linear
least squares, weighted by 1/t (the noise is a fraction of each total),
over knob-default sum trials (two edges in flight: the priors would
contaminate the solve) outside the ``+fuse`` variants, non-negative (a
rate the solve puts below 0 is fixed at 0 and the other refit: on Reddit
the card's row column came out negative, the model not seeing the
transpose's L2 locality).  When the sweep's
PROBE records are present they are the whole calibration set: the
halving's survivors cluster, the probes are designed to pull the two
columns apart (``search.REFIT_PROBES``).

On the CI surrogate the recovered rates land within 5 % of the generating
constants (``surrogate.CONSTANTS``), which proves sweep -> ledger records
-> refit closes the loop.  On the card the same solve gives the card's
rates; ``to_measured_table`` carries them with the card's name and power
limit, and ``update`` writes them to the port's own table beside the tuned
store (``measured_path``), never to ``tools/kernel_budgets.json``, and
refuses a table from the surrogate.  ``load_measured`` reads it back for
the memory estimator's and the balancer's priors
(``memory/estimator.py:agg_s_per_edge_column``).
"""

from __future__ import annotations

import json
import os
import subprocess

import numpy as np

from roc_tpu_torch.tune.surrogate import CONSTANTS

MEASURED_FILE = "measured_cuda.json"
_NAMES = ("byte_s", "row_s")
_MODELS = ("tune_trial", "tune_confirm", "tune_probe")
# path -> ((mtime_ns, size), table or None)
_CACHE: dict = {}


def _fields(tr):
    """A TrialRecord or a ledger measurement dict as the solve's inputs;
    None when the record lacks the columns."""
    if isinstance(tr, dict):
        if tr.get("model") not in _MODELS or "byte_col" not in tr:
            return None
        return {"t": float(tr["value"]), "byte_col": float(tr["byte_col"]),
                "row_col": float(tr["row_col"]),
                "kernel": str(tr.get("kernel", "")),
                "default_knobs": bool(tr.get("default_knobs", False)),
                "stage": str(tr.get("stage", "")),
                "variant": str(tr.get("variant", "")),
                "shape": str(tr.get("shape", "")),
                "label": str(tr.get("key", ""))}
    return {"t": tr.trial_s, "byte_col": tr.byte_col, "row_col": tr.row_col,
            "kernel": tr.kernel, "default_knobs": tr.default_knobs,
            "stage": tr.stage, "variant": tr.variant, "shape": tr.shape,
            "label": tr.label}


def refit_rates(trials) -> dict:
    """Solve ``byte_s`` and ``row_s`` from trial records (TrialRecords or
    ledger measurement dicts).  Returns {byte_s, row_s, n, vs_constants:
    {name: refit / generating}}; a rate is None when no eligible record
    identifies it."""
    rows = []
    for tr in trials:
        f = _fields(tr)
        if (f is None or f["kernel"] != "sum" or not f["default_knobs"]
                or "+fuse" in f["variant"]):
            continue
        rows.append(f)
    probes = [f for f in rows if f["stage"] == "probe"]
    if probes:
        rows = probes
    out = {"byte_s": None, "row_s": None, "n": len(rows)}
    if rows:
        cols = [[f["byte_col"] for f in rows], [f["row_col"] for f in rows]]
        keep = [i for i, c in enumerate(cols) if any(v != 0 for v in c)]
        b = np.asarray([f["t"] for f in rows], dtype=np.float64)
        w = 1.0 / np.maximum(b, 1e-15)
        while keep:
            A = np.asarray([cols[i] for i in keep], dtype=np.float64).T
            sol, *_ = np.linalg.lstsq(A * w[:, None], b * w, rcond=None)
            if min(sol) >= 0 or len(keep) == 1:
                break
            # a negative rate is no rate: its column is fixed at 0 and the
            # other refit (non-negative least squares over two columns)
            keep = [i for i, v in zip(keep, sol) if v > 0]
            for i in set(range(len(cols))) - set(keep):
                out[_NAMES[i]] = 0.0
        for i, v in zip(keep, sol):
            out[_NAMES[i]] = float(v)
    out["vs_constants"] = {k: out[k] / CONSTANTS[k] for k in _NAMES
                           if out[k] is not None}
    return out


def card_identity() -> tuple:
    """(name, power limit) as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them, or ("", "") without the tool."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "", ""
    name, _, limit = out.rpartition(",")
    return name.strip(), limit.strip()


def to_measured_table(trials, interpret: bool, name: str = "",
                      power_limit: str = "") -> dict:
    """Trial records -> the port's measured table: the refit rates, each
    shape's confirmed and default sum launches, the card's name and power
    limit, and ``interpret`` (a surrogate table is never read back as
    rates)."""
    rates = refit_rates(trials)
    shapes: dict = {}
    for tr in trials:
        f = _fields(tr)
        if f is None or f["stage"] not in ("confirm", "default"):
            continue
        shapes.setdefault(f["shape"] or "swept", {})[
            f"{f['stage']}/{f['label']}"] = f["t"]
    return {"interpret": bool(interpret),
            "device": {"name": name, "power_limit": power_limit},
            "source": "roc_tpu_torch.tune refit",
            "rates": {k: rates[k] for k in _NAMES}, "n": rates["n"],
            "shapes": shapes}


def measured_path() -> str:
    """The measured table's path: beside the tuned store; '' when the
    store is off."""
    from roc_tpu_torch.tune.store import tuned_store_path
    p = tuned_store_path()
    return os.path.join(os.path.dirname(os.path.abspath(p)),
                        MEASURED_FILE) if p else ""


def update(table: dict, path: str = "") -> str:
    """Write ``table`` to the port's measured table (``measured_path``
    unless ``path``): atomic, sorted keys.  Refuses a surrogate
    (interpret) table."""
    from roc_tpu_torch.fault.durable import fsync_replace
    if table.get("interpret", True):
        raise SystemExit(
            "tune.refit: refusing to write an interpret/surrogate table "
            "as measured rates (the measured-table contract)")
    path = path or measured_path()
    if not path:
        raise SystemExit("tune.refit: the tuned store is off "
                         "(ROC_NO_TUNED/ROC_PLAN_CACHE=0); name a path")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    fsync_replace(tmp, path)
    _CACHE.pop(path, None)
    return path


def load_measured(path: str = ""):
    """The card's measured table, or None: no file, unreadable, a
    surrogate table, or no positive byte rate.  Cached per (path, mtime,
    size)."""
    path = path or measured_path()
    if not path:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    ck = (st.st_mtime_ns, st.st_size)
    hit = _CACHE.get(path)
    if hit is not None and hit[0] == ck:
        return hit[1]
    table = None
    try:
        with open(path, encoding="utf-8") as f:
            table = json.load(f)
    except (OSError, ValueError):
        table = None
    rates = table.get("rates") if isinstance(table, dict) else None
    if (not isinstance(rates, dict) or table.get("interpret", True)
            or not all(isinstance(rates.get(k), float) for k in _NAMES)
            or not rates["byte_s"] > 0):
        table = None
    _CACHE[path] = (ck, table)
    return table
