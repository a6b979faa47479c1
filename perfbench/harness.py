"""One run of one cell: ``--workload <name> --seed <n> --seconds <s>
--trace <0|1>``.  Prints the compared numbers beside their limits as the
last lines of standard error, and one JSON object as the last line of
standard output.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (``perfbench/metrics/*.py``, each
left out where it finds nothing to read)."""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time

# a library that imports JAX by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")

from perfbench import check, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "roc_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a traffic kind's ``run`` reads: the cell, the seed, the window
    and the device, with the device's sync and memory counters."""

    def __init__(self, cell, seed, seconds, trace, t_start, device):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_start = t_start
        self.device = device

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.cuda:
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        if self.cuda:
            import torch
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0


def run_cell(cell, seed, seconds, trace, t_start, device):
    """The traffic kind's result for one run (no output)."""
    kind = importlib.import_module(f"perfbench.{cell.traffic['kind']}_run")
    return kind.run(Context(cell, seed, seconds, trace, t_start, device))


def _num(v):
    """A number for the line: a non-finite one (a failure's latency, a
    comparison that could not be made) as a string, which strict JSON
    readers accept."""
    v = float(v)
    return v if math.isfinite(v) else str(v)


def metrics_of(cell, res, trace: bool) -> dict:
    out = {}
    if not trace:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        for name, unit in units.items():
            out[name] = {"value": _num(res["end_to_end"][name]),
                         "unit": unit}
        return out
    for m in cell.per_layer:
        val = spec.metric_reader(m["name"])(res["layer"])
        if val is not None and math.isfinite(val):
            out[m["name"]] = {"value": val, "unit": m["unit"]}
    return out


def result_line(cell, res, trace: bool, device_info: dict) -> dict:
    ok, rows = check.verdict(res["numbers"], check.limits_for(cell.name))
    line = {"correct": bool(ok and res["failed"] == 0),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics_of(cell, res, trace),
            "device": device_info}
    if trace:
        tr = res["layer"]["trace"]
        line["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = tr["breakdown"]
    line["checks"] = {r["name"]: {"value": _num(r["value"]),
                                  "limit": r["limit"]} for r in rows}
    return line


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="perfbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = spec.cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = run_cell(cell, a.seed, a.seconds, bool(a.trace), t_start, device)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = result_line(cell, res, bool(a.trace), info)
    if res.get("notes"):
        print(f"notes {json.dumps(res['notes'])}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line, allow_nan=False))
    return 0
