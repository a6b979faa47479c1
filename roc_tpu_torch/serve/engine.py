"""ServeEngine: frozen-parameter node-query serving
(roc_tpu/serve/engine.py).

The serving hot path is the training hot path run forward-only: the engine
loads a checkpoint through ``train.frozen.load_frozen`` (weights only),
builds the graph data through the same backend resolution as training, and
answers node-level queries with one full-graph eval forward followed by an
``index_select`` of the queried rows.  On CUDA every aggregation of that
forward is a launch of the hand-written sum-aggregation kernel, and every
attention layer one launch each of the GAT score and forward kernels.

Shape discipline: a chunk of queries is padded to a power-of-two bucket
capped at ``serve_batch``, so the query gather sees at most
``len(buckets)`` shapes.  Each dispatched chunk pays exactly one host sync
(the copy of its rows to the host).  Dynamic-graph deltas, the streaming
branch and the calibration ledger are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from roc_tpu_torch.graph.datasets import Dataset
from roc_tpu_torch.models.model import Model
from roc_tpu_torch.serve.queue import MicrobatchQueue, ServeFuture
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.frozen import FrozenBundle, load_frozen


def bucket_sizes(batch: int):
    """The padded-shape ladder: powers of two up to ``batch`` (inclusive,
    ``batch`` itself always last even when not a power of two)."""
    out, b = [], 1
    while b < batch:
        out.append(b)
        b *= 2
    out.append(int(batch))
    return out


class ServeEngine:
    """Microbatched node-query engine over frozen params, on one device
    (CUDA unless ``device="cpu"``)."""

    def __init__(self, config: Config, dataset: Dataset, model: Model,
                 checkpoint_path: Optional[str] = None,
                 start_queue: bool = True, device=None):
        self.config = config
        self.dataset = dataset
        self.model = model
        self.buckets = bucket_sizes(config.serve_batch)
        self._lock = threading.Lock()
        self.forwards = 0
        self.dispatches = {b: 0 for b in self.buckets}
        t0 = time.perf_counter()
        self.bundle: FrozenBundle = load_frozen(
            config, dataset, model, checkpoint_path, device=device)
        self.device = self.bundle.device
        # one forward on the smallest bucket before the first request
        # lands: on CUDA it builds and loads the kernels
        self._serve_rows(np.zeros(1, np.int32))
        self.cold_start_stats = {
            "cold_start_s": round(time.perf_counter() - t0, 6),
            "buckets": list(self.buckets),
        }
        self.queue = None
        if start_queue:
            self.queue = MicrobatchQueue(
                self._serve_rows, batch=config.serve_batch,
                wait_ms=config.serve_wait_ms,
                queue_max=config.serve_queue_max)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _serve_rows(self, ids: np.ndarray) -> np.ndarray:
        """Serve one drained window: [k] node ids -> [k, C] logits.  Chunks
        larger than the top bucket split across dispatches; each dispatch
        is one full-graph forward and one host sync."""
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            return np.zeros((0, self.dataset.num_classes), np.float32)
        nn = self.bundle.num_nodes
        if ids.min() < 0 or ids.max() >= nn:
            raise IndexError(f"query ids must be in [0, {nn})")
        parts = []
        cap = self.buckets[-1]
        with self._lock:
            for lo in range(0, ids.size, cap):
                chunk = ids[lo:lo + cap]
                b = self.bucket_for(chunk.size)
                qidx = np.zeros(b, np.int64)
                qidx[:chunk.size] = chunk
                logits = self.bundle.predict_logits()
                res = logits.index_select(
                    0, torch.as_tensor(qidx, device=self.device))
                self.forwards += 1
                self.dispatches[b] += 1
                parts.append(res.cpu().numpy()[:chunk.size])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    # -- request API ------------------------------------------------------
    def _require_queue(self) -> MicrobatchQueue:
        if self.queue is None:
            raise RuntimeError("engine built with start_queue=False")
        return self.queue

    def submit(self, node_ids: Sequence[int],
               deadline_s: Optional[float] = None) -> ServeFuture:
        return self._require_queue().submit(node_ids, deadline_s=deadline_s)

    def query(self, node_ids: Sequence[int], timeout: float = 60.0):
        return self._require_queue().query(node_ids, timeout)

    def warmup(self):
        """Run every bucket once, so the first real request stream finds
        each query shape already served."""
        for b in self.buckets:
            self._serve_rows(np.zeros(b, np.int32))

    def stats(self) -> dict:
        q = self.queue
        return {
            "cold_start": dict(self.cold_start_stats),
            "windows": q.windows if q else 0,
            "requests": q.served if q else 0,
            "forwards": self.forwards,
            "dispatches": dict(self.dispatches),
        }

    # -- lifecycle --------------------------------------------------------
    def close(self):
        if self.queue is not None:
            self.queue.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
