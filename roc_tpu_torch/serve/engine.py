"""ServeEngine: frozen-parameter node-query serving
(roc_tpu/serve/engine.py).

The serving hot path is the training hot path run forward-only: the engine
loads a checkpoint through ``train.frozen.load_frozen`` (weights only),
builds the graph data through the same backend resolution as training, and
answers node-level queries with an ``index_select`` of the queried rows
from the logits of one full-graph eval forward.  On CUDA every aggregation
of that forward is a launch of the hand-written sum-aggregation kernel, and
every attention layer one launch each of the GAT score and forward kernels.

Logit reuse: the engine keeps the logits of its last forward (``_logits``,
[N, C] on the device) for the graph state installed when it ran.  A window
runs the forward only when that slot is empty, so the forward runs once
per graph install that a query follows, not once per window.  The slot is
emptied in the same critical section that installs a delta patch or a
replan swap (``_install_gdata``, under ``_plan_lock``), and when the
bundle's weights or features are replaced, so every window reads logits
bitwise equal to a fresh forward of the state it serves: x and the weights
are frozen and the sums run in CSR order without atomics.

Shape discipline: a chunk of queries is padded to a power-of-two bucket
capped at ``serve_batch``, so the query gather sees at most
``len(buckets)`` shapes.  Each dispatched chunk pays exactly one host sync
(the copy of its rows to the host).  Under ``config.stream`` the bundle
sweeps the host-resident shards through the streaming executor's slots
(no deltas, so one forward lasts the engine's life).

Dynamic-graph deltas (``delta_journal=`` at construction, a path or ""
for volatile): edge adds and retires between requests journal to a
write-ahead log and rewrite the touched CSR rows into the delta manager's
idle device buffer, which swaps in under ``_plan_lock``, the lock the
serve worker holds for a whole window, so queries never see a torn CSR.
The patched CSR is read by the same kernels as the frozen one; a restart
replays the journal to the exact served state (serve/delta.py).

Calibration: the ``serve-p50`` ledger pair predicts a window's p50 from
the forward's roofline (``obs.roofline.forward_flops_bytes`` over the
card's peaks: a window that runs the forward) and measures the observed
request p50 every ``_P99_FEED_WINDOWS`` windows, where the watchdog's
serve feed also takes the p99.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from roc_tpu_torch import obs
from roc_tpu_torch.analysis import witness as _witness
from roc_tpu_torch.graph.datasets import Dataset
from roc_tpu_torch.models.model import Model
from roc_tpu_torch.obs import roofline
from roc_tpu_torch.obs.ledger import content_key, get_ledger
from roc_tpu_torch.ops.aggregate import csr_build_count
from roc_tpu_torch.ops.kernels.build import build_count
from roc_tpu_torch.serve.queue import MicrobatchQueue, ServeFuture
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.frozen import FrozenBundle, load_frozen

# Feed the watchdog's serve-latency EWMA once per this many windows: a
# p99 over a single window of a few requests is noise, not a tail.
_P99_FEED_WINDOWS = 8


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
                 watchdog=None, start_queue: bool = True,
                 delta_journal: Optional[str] = None, device=None):
        self.config = config
        self.dataset = dataset
        self.model = model
        self.watchdog = watchdog
        self.buckets = bucket_sizes(config.serve_batch)
        self._lat_buf: list = []
        self._p99_windows = 0
        # the serve worker holds this for a whole window; delta installs
        # and the replan swap take it: the swap lands at a window boundary
        self._plan_lock = _witness.trace("ServeEngine._plan_lock",
                                         threading.RLock())
        self.deltas = None
        # forwards run; dispatches answered from the slot instead:
        # forwards + logit_reuses == sum(dispatches)
        self.forwards = 0
        self.logit_reuses = 0
        self.dispatches = {b: 0 for b in self.buckets}
        # the last forward's logits and the (params, x) they were computed
        # from (a caller may replace the bundle's weights after
        # construction); an install empties the slot
        self._logits = None
        self._logits_of = None
        csr0, kern0 = csr_build_count(), build_count()
        with obs.span("serve_cold_start") as sp:
            self.bundle: FrozenBundle = load_frozen(
                config, dataset, model, checkpoint_path, device=device)
            self.device = self.bundle.device
            if delta_journal is not None:
                from roc_tpu_torch.serve.delta import DeltaError, DeltaManager
                if self.bundle.stream_trainer is not None:
                    raise DeltaError(
                        "dynamic deltas require the in-core kernel "
                        "engine; the streamed executor reshards from "
                        "host-resident edges instead")
                self.deltas = DeltaManager(
                    lambda: self.bundle.gdata, self._install_gdata,
                    self._plan_lock, self.bundle.num_nodes,
                    journal_path=delta_journal or None,
                    watchdog=watchdog, verbose=config.verbose, model=model)
            # one forward on the smallest bucket before the first request
            # lands: on CUDA it builds and loads the kernels
            self._serve_rows(np.zeros(1, np.int32))
        self.cold_start_stats = {
            "cold_start_s": round(sp.dur_s, 6),
            "csr_builds": csr_build_count() - csr0,
            "kernel_builds": build_count() - kern0,
            "buckets": list(self.buckets),
        }
        # Ledger pair: serving p50 predicted from the forward-only
        # roofline (a window that runs the forward), measured from the
        # observed request p50 at each watchdog feed
        g = dataset.graph
        fl, nb = roofline.forward_flops_bytes(
            model, g.num_nodes, g.num_edges, config.aggregate_precision)
        self._roofline_p50_s = roofline.roofline_time(fl, nb)
        self._ledger_key = content_key(
            model=config.model, nodes=g.num_nodes, edges=g.num_edges,
            precision=config.aggregate_precision, batch=config.serve_batch)
        get_ledger().predict("serve-p50", self._ledger_key,
                             self._roofline_p50_s, "s")
        self.queue = None
        if start_queue:
            self.queue = MicrobatchQueue(
                self._serve_rows, batch=config.serve_batch,
                wait_ms=config.serve_wait_ms, on_window=self._note_window,
                queue_max=config.serve_queue_max)

    def _install_gdata(self, gdata) -> None:
        """Swap the resident graph data (a delta patch or a replan swap).
        The caller holds ``_plan_lock``; each forward builds its graph
        context from ``bundle.gdata``, and the cached logits go with the
        swap (dropped here, not after the next forward, so the stale
        table never lives through the recompute): the next window runs
        the forward over the new CSR."""
        self.bundle.gdata = gdata
        self._logits = self._logits_of = None

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _installed_logits(self):
        """(logits [N, C] of the installed state, whether a forward ran).
        The caller holds ``_plan_lock``.  The full-graph forward runs only
        when the slot is empty or the bundle's weights or features were
        replaced since it was filled."""
        b = self.bundle
        of = self._logits_of
        if self._logits is not None and of[0] is b.params and of[1] is b.x:
            return self._logits, False
        # the stale table goes before the recompute, not after it
        self._logits = self._logits_of = None
        self._logits = b.predict_logits()
        self._logits_of = (b.params, b.x)
        self.forwards += 1
        return self._logits, True

    def _serve_rows(self, ids: np.ndarray) -> np.ndarray:
        """Serve one drained window: [k] node ids -> [k, C] logits.  Chunks
        larger than the top bucket split across dispatches; each dispatch
        is one ``index_select`` from the installed state's logits and one
        host sync.  The window runs the full-graph forward only when the
        logits slot is empty (``_installed_logits``), so at most once."""
        # roclint: allow(host-sync) request ingress: host ids to a host array, nothing device-resident
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            return np.zeros((0, self.dataset.num_classes), np.float32)
        nn = self.bundle.num_nodes
        if ids.min() < 0 or ids.max() >= nn:
            raise IndexError(f"query ids must be in [0, {nn})")
        parts = []
        cap = self.buckets[-1]
        with obs.span("serve_window", n=int(ids.size)) as sp, \
                self._plan_lock:
            logits, ran = self._installed_logits()
            sp.args["forward"] = int(ran)
            for lo in range(0, ids.size, cap):
                chunk = ids[lo:lo + cap]
                b = self.bucket_for(chunk.size)
                qidx = np.zeros(b, np.int64)
                qidx[:chunk.size] = chunk
                res = logits.index_select(
                    0, torch.as_tensor(qidx, device=self.device))
                if lo or not ran:
                    self.logit_reuses += 1
                self.dispatches[b] += 1
                # roclint: allow(host-sync) one result fetch per dispatched chunk: the window's sanctioned sync
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

    # -- observability ----------------------------------------------------
    def _note_window(self, latencies):
        """The queue's per-window hook: every ``_P99_FEED_WINDOWS`` windows
        the ``serve-p50`` measurement and the watchdog's p99 feed."""
        self._lat_buf.extend(latencies)
        self._p99_windows += 1
        if self._p99_windows < _P99_FEED_WINDOWS:
            return
        lats = sorted(self._lat_buf)
        p99 = lats[min(int(0.99 * (len(lats) - 1)), len(lats) - 1)]
        self._p99_windows = 0
        del self._lat_buf[:]
        led = get_ledger()
        led.predict("serve-p50", self._ledger_key, self._roofline_p50_s, "s")
        led.measure("serve-p50", self._ledger_key, lats[len(lats) // 2], "s")
        if self.watchdog is None:
            return
        alert = self.watchdog.observe_serve(self.queue.windows, p99)
        if alert is not None and self.config.verbose:
            print(f"# watchdog: serve p99 {alert['p99_s'] * 1e3:.2f} ms is "
                  f"{alert['ratio']:.2f}x its EWMA "
                  f"({alert['ewma_s'] * 1e3:.2f} ms)")

    def stats(self) -> dict:
        q = self.queue
        out = {
            "cold_start": dict(self.cold_start_stats),
            "windows": q.windows if q else 0,
            "requests": q.served if q else 0,
            "forwards": self.forwards,
            "logit_reuses": self.logit_reuses,
            "dispatches": dict(self.dispatches),
        }
        if self.deltas is not None:
            out["deltas"] = self.deltas.stats()
        return out

    # -- dynamic deltas ---------------------------------------------------
    def apply_delta(self, add_edges=None, retire_edges=None,
                    wait_replan: bool = False) -> dict:
        """Apply one dynamic-graph delta batch.  CONTRACT:

        - ``add_edges`` / ``retire_edges`` are [n, 2] integer arrays of
          (src, dst) node ids.  Out-of-range ids or a malformed shape
          reject the WHOLE batch with :class:`~roc_tpu_torch.serve.delta.
          DeltaError`; a rejected batch is never journaled and never
          partially applied.
        - Validated batches are framed into the write-ahead journal
          (CRC32, monotone seq, fsync) BEFORE any in-memory patch; a
          restart replays the journal over the frozen graph to the exact
          served state (requires ``delta_journal=<path>`` at
          construction; ``delta_journal=""`` runs volatile and loses
          deltas on restart).
        - The patch rewrites ONLY the touched CSR rows into the idle
          device buffer and swaps it in: no CSR rebuild, no new buffer,
          no kernel build.  Re-adding a live edge or retiring a dead one
          is a counted no-op, warned once.
        - When the live edges outgrow the buffers the batch escalates: a
          background rebuild on the mutated graph runs while the OLD CSR
          keeps serving, then swaps atomically at a window boundary; pass
          ``wait_replan=True`` to block until the swap lands.
        - Concurrent with queries: installs and swaps happen under the
          window-held plan lock.  Concurrent mutations serialize.

        Returns the manager's result dict (seq, mode "applied" / "noop" /
        "replanning", per-op counts, cells_patched: the rows rewritten).
        """
        if self.deltas is None:
            from roc_tpu_torch.serve.delta import DeltaError
            raise DeltaError(
                "engine was built without delta support; construct with "
                "delta_journal=<path> (journaled) or delta_journal='' "
                "(volatile)")
        return self.deltas.apply(add_edges, retire_edges,
                                 wait_replan=wait_replan)

    def delta_stats(self) -> dict:
        return self.deltas.stats() if self.deltas is not None else {}

    def delta_seq(self) -> int:
        """Applied-delta watermark (0 without delta support): the
        per-replica freshness signal the fleet router dispatches on."""
        return self.deltas.applied_seq if self.deltas is not None else 0

    def pending(self) -> int:
        """Requests queued but not yet drained: the engine's share of the
        router's least-loaded dispatch signal."""
        return self.queue.depth() if self.queue is not None else 0

    def checkpoint_deltas(self) -> None:
        """Fold the delta journal into a verified snapshot and truncate it
        (one crash-consistent unit; see DeltaManager.checkpoint)."""
        if self.deltas is not None:
            self.deltas.checkpoint()

    # -- lifecycle --------------------------------------------------------
    def close(self):
        # order matters: first the delta manager (an apply that reached
        # the journal finishes its patch), then the queue drains,
        # resolving every pending future against the final CSR
        if self.deltas is not None:
            self.deltas.close()
        if self.queue is not None:
            self.queue.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
