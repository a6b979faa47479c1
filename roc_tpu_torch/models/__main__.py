"""Region-plan dump CLI (roc_tpu/models/__main__.py): the fusion-region
planner's partition of a model as canonical JSON.

    python -m roc_tpu_torch.models [--model gcn-chain] [--layers
                                   100-256-256-47] [--depth 0] [--heads 4]

Prints which per-layer megakernel matches exist, how ``mega_regions``
chains them at the depth cap, and which tensors each region skips and
drops.  The op IR alone, no tensors: its output is byte-equal to
``python -m roc_tpu.models`` for the same arguments.
"""

from __future__ import annotations

import argparse
import json
import sys

from roc_tpu_torch.models import build_model
from roc_tpu_torch.models.model import mega_matches, mega_regions


def region_plan_json(model_name: str, layers, depth: int,
                     heads: int = 4) -> str:
    """Canonical (sorted-key, fixed-separator) region-plan JSON."""
    model = build_model(model_name, layers, dropout_rate=0.0, heads=heads)
    regs = mega_regions(model, depth)
    plan = {
        "model": model_name,
        "layers": list(layers),
        "fusion_depth": depth,
        "matches": sorted(mega_matches(model)),
        "regions": {
            str(head): {
                "depth": len(r["members"]),
                "fold": bool(r["fold"]),
                "members": [
                    {"param": m["linear"].attrs["param"],
                     "in_dim": m["linear"].attrs["in_dim"],
                     "out_dim": m["linear"].attrs["out_dim"],
                     "activation": m["activation"]}
                    for m in r["members"]],
                "final_out": int(r["final"].out),
                "skip": sorted(int(t) for t in r["skip"]),
                "gone": sorted(int(t) for t in r["gone"]),
            }
            for head, r in regs.items()},
    }
    return json.dumps(plan, sort_keys=True, separators=(",", ":"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="roc_tpu_torch.models")
    p.add_argument("--model", default="gcn-chain",
                   choices=["gcn", "gcn-chain", "sage", "gin", "gat"])
    p.add_argument("--layers", default="100-256-256-47",
                   help="dash-separated widths incl. input and classes")
    p.add_argument("--depth", type=int, default=0,
                   help="fusion-region depth cap (0 = full, 1 = disabled)")
    p.add_argument("--heads", type=int, default=4)
    ns = p.parse_args(argv)
    layers = [int(x) for x in ns.layers.split("-")]
    sys.stdout.write(region_plan_json(ns.model, layers, ns.depth,
                                      heads=ns.heads) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
