"""Open-loop load generator for the serving engine
(roc_tpu/serve/loadgen.py).

Requests are offered at a target QPS on a fixed schedule however fast the
answers come back: a closed loop slows its own offer rate exactly when the
engine falls behind, which hides queueing collapse from the tail latency.
Request sizes cycle through a mix so a run exercises every bucket.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sequence."""
    if not sorted_vals:
        return 0.0
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return float(sorted_vals[i])


def run_load(engine, n_requests: int, qps: float,
             sizes: Sequence[int] = (1, 3, 8),
             rng: Optional[np.random.Generator] = None,
             timeout: float = 120.0) -> dict:
    """Offer ``n_requests`` at ``qps`` (open loop); return latency stats.
    Request i queries ``sizes[i % len(sizes)]`` random node ids."""
    if n_requests < 1 or qps <= 0:
        raise ValueError("need n_requests >= 1 and qps > 0")
    rng = rng or np.random.default_rng(0)
    nn = engine.bundle.num_nodes
    futures = []
    # roclint: allow(raw-timing) open-loop offer schedule anchor; the submit side must never sync
    t0 = time.perf_counter()
    for i in range(n_requests):
        delay = t0 + i / qps - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        k = int(sizes[i % len(sizes)])
        futures.append(engine.submit(rng.integers(0, nn, size=k)))
    for f in futures:
        f.result(timeout)
    wall = time.perf_counter() - t0
    lats: List[float] = sorted(f.latency_s for f in futures)
    return {
        "n": n_requests,
        "qps_offered": round(qps, 3),
        "qps_achieved": round(n_requests / max(wall, 1e-9), 3),
        "p50_s": round(percentile(lats, 0.50), 6),
        "p99_s": round(percentile(lats, 0.99), 6),
        "mean_s": round(float(np.mean(lats)), 6),
    }
