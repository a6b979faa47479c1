#!/usr/bin/env python3
"""Compare this checkout with another one on one NVIDIA GPU, in one call.

    git archive <commit> | tar -x -C chip_check/parent     # a gitignored dir
    python3 chip_ab.py chip_check/parent

Each run is a process of its own, in the order other, this, this, other,
and measures on the Reddit graph:

  gcn_megafuse  GCN 602-256-41 with -megafuse, fast, 10 epochs
                (chip_smoke.py's train phase of that checkout): the median
                epoch of epochs 3-10 and the peak device memory of a step,
                with nothing else live in the process
  chain_depth1  gcn-chain 602-256-256-256-41, -megafuse -fusion-depth 1
                (chip_smoke.py's train_chain phase): the same
  chain_depth2  the same at -fusion-depth 2 (one region of the two
                256-wide layers)
  chain_depth0  the same at -fusion-depth 0 (one region of the three
                hidden layers)
  score         the GAT source score at K=4, F=64 and K=1, F=41 beside
                torch.einsum: the CUDA-event time of one launch (median of
                50) and the time per launch over runs of 100 launches
                (median of 5 runs); a lone launch of a small kernel also
                holds the host's work of launching it

One JSON line per run, then the card's name and power limit as nvidia-smi
gives them.  Exits non-zero without CUDA or when a run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = r'''
import json, os, statistics, sys
root = sys.argv[1]
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as C
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.ops.kernels import gat as G
dev = torch.device("cuda", 0)
ds = datasets.get("reddit", seed=C.SEED)
out = {"checkout": root}
for name, phase in (("gcn_megafuse", lambda: C.phase_train(ds, dev, True)),
                    *((f"chain_depth{d}",
                       lambda d=d: C.phase_train_chain(ds, dev, d))
                      for d in (1, 2, 0))):
    rec = phase()
    out[name] = {"median_epoch_ms_3_on": rec["median_epoch_ms_3_on"],
                 "peak_mem_bytes": rec["peak_mem_bytes"]}
gen = torch.Generator(device=dev).manual_seed(C.SEED)
for k, f in ((4, 64), (1, 41)):
    x = torch.randn((ds.graph.num_nodes, k * f), generator=gen, device=dev)
    a = torch.randn((k, f), generator=gen, device=dev)
    for name, fn in (("kernel", lambda: G.gat_score(x, a)),
                     ("einsum", lambda: torch.einsum(
                         "tkf,kf->tk", x.view(-1, k, f), a))):
        runs = []
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(100):
                fn()
            e1.record()
            e1.synchronize()
            runs.append(e0.elapsed_time(e1) / 100)
        out[f"score_K{k}_F{f}_{name}"] = {
            "one_launch_ms": C.time_ms(fn, reps=50, warmup=5),
            "per_launch_ms_over_100": statistics.median(runs)}
print("AB " + json.dumps(out), flush=True)
'''


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(sys.argv[1])
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, "-c", RUN, root],
                              capture_output=True, text=True, timeout=900)
        lines = [ln[3:] for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps(json.loads(lines[-1])), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
