"""The rate sweep behind a serve cell's fixed rate: ``python3
perfbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates
r1,r2,...``.  One engine, warmed once; first queries one at a time (the
unloaded latency), then each rate open-loop with the cell's mix and
deltas.  Prints one JSON line a rate: offered and achieved rate, the
latency percentiles, the median latency of the first and last quarter of
the queries (a queue that grows shows as the last above the first), and
the batches' p95.  The knee is the highest rate whose achieved rate is
within 1 % of the offer, whose queue does not grow and whose p95 is at
most 5 times the unloaded p95."""

import argparse
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from perfbench import inputs, loadgen, spec  # noqa: E402
from perfbench.serve_run import Collector, build_engine, phase  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--rates", required=True)
    a = p.parse_args()
    cell = spec.cell(a.workload)
    cfg, traffic = cell.config, dict(cell.traffic)
    dev = torch.device("cuda", 0)
    deltas = traffic.get("deltas")
    jdir = tempfile.mkdtemp(prefix="perfbench_sweep_") if deltas else None
    try:
        eng, ds = build_engine(
            cfg, traffic, a.seed, dev,
            journal=(jdir + "/deltas.wal") if jdir else None)
        n = ds.graph.num_nodes
        rates = [float(r) for r in a.rates.split(",")]
        n_b = int(math.ceil(a.seconds / deltas["every_s"])) if deltas else 0
        batches = inputs.delta_batches(
            traffic, a.seed, n_b * (len(rates) + 1), ds.graph.row_ptr,
            ds.graph.col_idx) if deltas else []
        one = []
        rng = torch.Generator().manual_seed(a.seed)
        for i in range(200):
            k = int(traffic["sizes"][i % len(traffic["sizes"])])
            ids = torch.randint(0, n, (k,), generator=rng).numpy()
            t = time.perf_counter()
            eng.submit(ids).result(60)
            one.append(time.perf_counter() - t)
        base = loadgen.percentile(one, 0.95)
        print(json.dumps({"workload": a.workload, "unloaded_p50_ms":
                          statistics.median(one) * 1e3,
                          "unloaded_p95_ms": base * 1e3}), flush=True)
        for j, rate in enumerate(rates):
            traffic["qps"] = rate
            q = inputs.query_schedule(traffic, a.seed, 100 + j, a.seconds, n)
            b = [(i * deltas["every_s"], x) for i, x in
                 enumerate(batches[j * n_b:(j + 1) * n_b])] if deltas else []
            patch = []
            fwd0 = eng.forwards
            with Collector(False):
                t0, sent, dsent = phase(eng, q, b, patch)
            lat = [loadgen.latency_s(o, "t_done") for o in sent]
            done = [o.result.t_done for o in sent if o.error is None]
            quarter = max(1, len(lat) // 4)
            rec = {"offered_qps": rate,
                   "achieved_qps": len(done) / max(max(done) - t0, 1e-9),
                   "failed": sum(o.error is not None for o in sent),
                   "p50_ms": loadgen.percentile(lat, 0.5) * 1e3,
                   "p95_ms": loadgen.percentile(lat, 0.95) * 1e3,
                   "p99_ms": loadgen.percentile(lat, 0.99) * 1e3,
                   "first_quarter_p50_ms":
                       statistics.median(lat[:quarter]) * 1e3,
                   "last_quarter_p50_ms":
                       statistics.median(lat[-quarter:]) * 1e3,
                   "requests_per_forward":
                       len(done) / max(eng.forwards - fwd0, 1)}
            if dsent:
                rec["delta_p95_ms"] = loadgen.percentile(
                    [loadgen.latency_s(o) for o in dsent], 0.95) * 1e3
            print(json.dumps(rec), flush=True)
        eng.close()
    finally:
        if jdir:
            shutil.rmtree(jdir, ignore_errors=True)


if __name__ == "__main__":
    main()
