"""The bounded prefetch ring of the streaming executor
(roc_tpu/stream/ring.py).

One background worker drains a FIFO of fetch requests; each assembles one
shard's slot from the host stores and starts its copies to the card.  At
most ``num_slots`` requests are in flight (the slot being computed plus
the prefetch depth), so the device holds ``num_slots`` slots however many
shards an epoch rotates; 2 is double buffering.  One worker is
deliberate: transfers run in submission order, the executor's sweep
order, and the cotangent scatters it also runs (``submit``) never race
each other on shared halo rows.

``wait`` counts only time blocked on a fetch that had not completed
(``stall_s``); ``busy_s`` is the worker's fetch time; ``overlap_frac`` is
the share of the transfer time hidden under compute.  A fetch is retried
through ``fault.retrying`` (the ``ring.fetch`` and ``ring.fetch.slow``
injection sites); roc_tpu's lock-order witness is not ported.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Hashable

from roc_tpu_torch import fault, obs
from roc_tpu_torch.analysis import witness as _witness

__all__ = ["PrefetchRing"]


class PrefetchRing:
    """FIFO prefetcher over ``fetch_fn(item) -> slot``."""

    def __init__(self, num_slots: int, fetch_fn: Callable[[Hashable], Any],
                 initializer: Callable[[], None] = None):
        if num_slots < 2:
            raise ValueError(f"PrefetchRing needs >= 2 slots, got {num_slots}")
        self.num_slots = int(num_slots)
        self._fetch_fn = fetch_fn
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="roc-stream-prefetch",
            initializer=initializer)
        self._futures: Dict[Hashable, Future] = {}
        # stall_s and busy_s are written from two threads (consumer and
        # worker): every access holds the lock
        self._lock = _witness.trace("PrefetchRing._lock", threading.Lock())
        self.stall_s = 0.0
        self.busy_s = 0.0

    # -- worker side --------------------------------------------------------

    def _run(self, item: Hashable) -> Any:
        def _attempt():
            fault.point("ring.fetch.slow")
            fault.point("ring.fetch")
            return self._fetch_fn(item)
        with obs.span("stream_prefetch", item=str(item)) as sp:
            out = fault.retrying("ring.fetch", _attempt,
                                 retry_on=(OSError, RuntimeError))
        with self._lock:
            self.busy_s += sp.dur_s
        return out

    # -- consumer side ------------------------------------------------------

    def ensure(self, item: Hashable) -> bool:
        """Queue a fetch for ``item`` if absent and a slot is free."""
        with self._lock:
            if item in self._futures:
                return True
            if len(self._futures) >= self.num_slots:
                return False
            self._futures[item] = self._pool.submit(self._run, item)
            return True

    def wait(self, item: Hashable) -> Any:
        """Block until ``item``'s fetch completes and hand over its slot;
        submits the fetch itself when no ``ensure`` reached it."""
        with self._lock:
            fut = self._futures.pop(item, None)
            if fut is None:
                fut = self._pool.submit(self._run, item)
        if not fut.done():
            with obs.span("stream_wait", item=str(item)) as sp:
                out = fut.result()
            with self._lock:
                self.stall_s += sp.dur_s
            return out
        return fut.result()

    def submit(self, fn: Callable[[], Any]) -> Future:
        """Run side work on the worker, in FIFO order with the fetches (the
        cotangent scatters).  It takes no slot."""
        return self._pool.submit(fn)

    def drain(self) -> None:
        """Drop queued prefetches."""
        with self._lock:
            stale = list(self._futures.values())
            self._futures.clear()
        for fut in stale:
            fut.cancel()

    # -- epoch stats --------------------------------------------------------

    def reset_epoch_stats(self) -> None:
        with self._lock:
            self.stall_s = 0.0
            self.busy_s = 0.0

    def epoch_stats(self) -> Dict[str, float]:
        with self._lock:
            stall, busy = self.stall_s, self.busy_s
        overlap = 1.0 - stall / max(busy, 1e-12)
        return {"stall_s": stall, "transfer_s": busy,
                "overlap_frac": min(max(overlap, 0.0), 1.0)}

    def close(self) -> None:
        self.drain()
        self._pool.shutdown(wait=True)
