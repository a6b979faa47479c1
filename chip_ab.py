#!/usr/bin/env python3
"""Compare this checkout with another one on one NVIDIA GPU, in one call.

    git archive <commit> | tar -x -C chip_check/parent     # a gitignored dir
    python3 chip_ab.py chip_check/parent

Each run is a process of its own, in the order other, this, this, other,
and measures on the Reddit graph:

  gcn_unfused   GCN 602-256-41, fast, 10 epochs (chip_smoke.py's train
                phase of that checkout): the median epoch of epochs 3-10
                and the peak device memory of a step, with nothing else
                live in the process
  gcn_megafuse  the same with -megafuse
  chain_depth1  gcn-chain 602-256-256-256-41, -megafuse -fusion-depth 1
                (chip_smoke.py's train_chain phase): the same
  chain_depth2  the same at -fusion-depth 2 (one region of the two
                256-wide layers)
  chain_depth0  the same at -fusion-depth 0 (one region of the three
                hidden layers)
  serve_gcn     GCN 602-256-41 served (chip_smoke.py's serve phase): p50
                and p99 request latency and peak memory
  gat_train     GAT 602-64-41, 4 heads, fast, 10 epochs (chip_smoke.py's
                train_gat phase): the median epoch and the peak memory
  serve_gat     GAT 602-64-41 served, 40 requests: p50, p99, peak memory
  digests       SHA-256 of the outputs of aggregate_sum (over the CSR and
                its transpose, H = 41, 256, 602) and aggregate_linear
                (602->256 relu, 256->41, 256->256 relu), both precisions,
                and of the GAT kernels at K=4, F=64 and K=1, F=41, both
                precisions: the score, gat_forward's out, m, z and the backward's
                dtable, dast, dadl, on Gaussian inputs from one seed: equal digests
                in two checkouts mean equal bits
  xlayer_ptxas  the region kernels' registers and spill bytes, from the
                build's ptxas report (empty where the library was already
                built)
  score         the GAT source score at K=4, F=64 and K=1, F=41 beside
                torch.einsum: the CUDA-event time of one launch (median of
                50) and the time per launch over runs of 100 launches
                (median of 5 runs); a lone launch of a small kernel also
                holds the host's work of launching it

One JSON line per run, then one line saying which digests differ between
the two checkouts (other vs this, first runs), then the card's name and
power limit as nvidia-smi gives them.  Exits non-zero without CUDA or when
a run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = r'''
import hashlib, json, os, statistics, sys
root = sys.argv[1]
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as C
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.ops import DeviceCsr
from roc_tpu_torch.ops.kernels import aggregate_linear as KL
from roc_tpu_torch.ops.kernels import aggregate_sum as KS
from roc_tpu_torch.ops.kernels import gat as G
dev = torch.device("cuda", 0)
ds = datasets.get("reddit", seed=C.SEED)
out = {"checkout": root}
csr = DeviceCsr.from_csr(ds.graph, dev)
gen = torch.Generator(device=dev).manual_seed(C.SEED + 21)
dig, n = {}, ds.graph.num_nodes


def digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


for h in (41, 256, 602):
    x = torch.randn((n, h), generator=gen, device=dev)
    for prec in ("fast", "exact"):
        for d, rp, ci in (("fwd", csr.row_ptr, csr.col_idx),
                          ("transposed", csr.t_row_ptr, csr.t_col_idx)):
            dig[f"aggregate_sum_{d}_H{h}_{prec}"] = digest(
                KS.aggregate_sum(x, rp, ci, prec))
for hi, ho, act in ((602, 256, "relu"), (256, 41, "none"), (256, 256, "relu")):
    x = torch.randn((n, hi), generator=gen, device=dev)
    w = torch.randn((hi, ho), generator=gen, device=dev)
    for prec in ("fast", "exact"):
        dig[f"aggregate_linear_{hi}_{ho}_{act}_{prec}"] = digest(
            KL.aggregate_linear(x, w, csr.row_ptr, csr.col_idx, prec, act))
gcsr = DeviceCsr.from_csr(ds.graph, dev, edge_map=True)
gen = torch.Generator(device=dev).manual_seed(C.SEED + 22)
for k, f in ((4, 64), (1, 41)):
    gx, a_src, a_dst = (torch.randn(s, generator=gen, device=dev)
                       for s in ((n, k * f), (k, f), (k, f)))
    du = torch.randn((n, k * f), generator=gen, device=dev)
    dz = torch.randn((n, k), generator=gen, device=dev)
    as_, ad = G.gat_score_plain(gx, a_src), G.gat_score_plain(gx, a_dst)
    dig[f"gat_score_K{k}_F{f}"] = digest(G.gat_score(gx, a_src))
    for prec in ("fast", "exact"):
        tag = f"K{k}_F{f}_{prec}"
        o, m, z = G.gat_forward(gx, as_, ad, gcsr.row_ptr, gcsr.col_idx, 0.2,
                                prec)
        for name, t in (("out", o), ("m", m), ("z", z)):
            dig[f"gat_forward_{name}_{tag}"] = digest(t)
        node = (gx, as_, ad, m, du, dz)
        dtable, dast, dq = G.gat_bwd_src(*node, gcsr.t_row_ptr,
                                         gcsr.t_col_idx, 0.2, prec)
        dadl = G.gat_bwd_dst(dq, gcsr.t_pos, gcsr.row_ptr, gcsr.col_idx)
        del dq
        for name, t in (("dtable", dtable), ("dast", dast), ("dadl", dadl)):
            dig[f"gat_bwd_{name}_{tag}"] = digest(t)
        del o, m, z, dtable, dast, dadl
    del gx, du, dz, as_, ad
del gcsr
out["digests"] = dig
from roc_tpu_torch.ops.kernels import xlayer as KX
KX.LIBRARY.load()
out["xlayer_ptxas"] = {k: v for k, v in C.ptxas_report(
    KX.LIBRARY.info.get("log", "")).items() if "xlayer_" in k}
del x, w, csr
torch.cuda.empty_cache()
for name, phase in (("gcn_unfused", lambda: C.phase_train(ds, dev, False)),
                    ("gcn_megafuse", lambda: C.phase_train(ds, dev, True)),
                    *((f"chain_depth{d}",
                       lambda d=d: C.phase_train_chain(ds, dev, d))
                      for d in (1, 2, 0))):
    rec = phase()
    out[name] = {"median_epoch_ms_3_on": rec["median_epoch_ms_3_on"],
                 "peak_mem_bytes": rec["peak_mem_bytes"]}
rec = C.phase_train(ds, dev, False, model="gat")
out["gat_train"] = {"median_epoch_ms_3_on": rec["median_epoch_ms_3_on"],
                    "peak_mem_bytes": rec["peak_mem_bytes"]}
rec = C.phase_serve(ds, dev)
out["serve_gcn"] = {k: rec[k] for k in ("p50_ms", "p99_ms", "peak_mem_bytes")}
rec = C.phase_serve(ds, dev, "gat", n_requests=40)
out["serve_gat"] = {k: rec[k] for k in ("p50_ms", "p99_ms", "peak_mem_bytes")}
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
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, "-c", RUN, root],
                              capture_output=True, text=True, timeout=900)
        lines = [ln[3:] for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1]))
        print(json.dumps(runs[-1]), flush=True)
    a, b = runs[0]["digests"], runs[1]["digests"]
    print(json.dumps({"digests_compared": len(a),
                      "digests_differ": sorted(k for k in a
                                               if a[k] != b.get(k))}),
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
