"""Plan-dump CLI: the deterministic memory-plan JSON of a named
configuration (roc_tpu/memory/__main__.py, same arguments and defaults).

    python -m roc_tpu_torch.memory [--model gcn] [--layers 100-256-256-47]
                                   [--rows N] [--edges E] [--budget 8g]
                                   [--mode auto] [--stream]

Analytic: it builds the op IR and runs the estimator and the DP, and
places no tensor.  The same configuration prints the same bytes.  The
recompute seconds are the card's (memory/estimator.py), so the step-time
fields differ from ``python -m roc_tpu.memory``'s; the byte fields and,
where the prices agree on the order, the decisions do not."""

from __future__ import annotations

import argparse
import sys

from roc_tpu_torch.memory import estimator, planner
from roc_tpu_torch.models import build_model
from roc_tpu_torch.train.config import parse_size


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="roc_tpu_torch.memory")
    p.add_argument("--model", default="gcn",
                   choices=["gcn", "sage", "gin", "gat"])
    p.add_argument("--layers", default="100-256-256-47",
                   help="dash-separated widths incl. input and classes")
    p.add_argument("--rows", type=int, default=612_258,
                   help="per-device node rows (default: products/4)")
    p.add_argument("--edges", type=int, default=31_250_000,
                   help="per-device edges (default: products/4)")
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--budget", default="8g",
                   help="per-device byte budget (k/m/g/t suffixes)")
    p.add_argument("--mode", default="auto",
                   choices=["auto", "keep", "remat"])
    p.add_argument("--stream", action="store_true",
                   help="plan for a -stream run: OFFLOAD verdicts execute "
                        "as host residency, not remat")
    ns = p.parse_args(argv)
    layers = [int(x) for x in ns.layers.split("-")]
    model = build_model(ns.model, layers, heads=ns.heads)
    fixed = estimator.fixed_bytes_for(model, ns.rows, layers[0], layers[-1],
                                      ns.edges)
    est = estimator.estimate_model(model, ns.rows, ns.edges,
                                   fixed_bytes=fixed)
    plan = planner.plan_memory(est, mode=ns.mode,
                               budget_bytes=parse_size(ns.budget),
                               offload_executed=ns.stream)
    sys.stdout.write(plan.to_json())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
