"""Bounded retry-with-backoff (roc_tpu/fault/retry.py): the one retry
policy of the port.

``retrying(site, fn)`` runs ``fn`` up to ``attempts`` times, sleeping a
jittered exponential backoff between tries, and re-raises the last error
when the budget is spent.  Every retry is counted per site
(``retry_counts``) and handed to ``inject.emit_event`` (dropped unless a
sink is attached).  The JAX package also runs the backoff sleep under an
``obs.span``; the port has no obs yet (ROADMAP queue A item 7).

The ``ROC_FAULT`` spec's ``retries=N`` token overrides the budget at every
site at once: ``retries=0`` is how a test proves a fault leg *needs* the
retries it exercises.

Backoff jitter is a hash of (site, attempt), not a clock or an RNG, so
seeded chaos runs stay reproducible.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Tuple, Type

from roc_tpu_torch.fault import inject

_LOCK = threading.Lock()
_RETRIES: dict = {}   # site -> retries performed (sleep-then-try count)


def retry_counts() -> dict:
    with _LOCK:
        return dict(_RETRIES)


def reset_retry_counts() -> None:
    with _LOCK:
        _RETRIES.clear()


def _backoff_s(site: str, attempt: int, base_s: float,
               max_s: float) -> float:
    delay = min(max_s, base_s * (2.0 ** attempt))
    frac = (zlib.crc32(f"{site}:{attempt}".encode()) & 0xFFFF) / 0xFFFF
    return delay * (0.5 + 0.5 * frac)


def retrying(site: str, fn: Callable, *, attempts: int = 3,
             base_s: float = 0.05, max_s: float = 2.0,
             retry_on: Tuple[Type[BaseException], ...] = (OSError,)):
    """Call ``fn()`` with up to ``attempts`` total tries.

    ``retry_on`` must be ``Exception`` subclasses: ``SimulatedCrash`` is a
    ``BaseException`` precisely so it can NOT be retried away.
    """
    override = inject.retry_override()
    if override is not None:
        attempts = override + 1
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            with _LOCK:
                _RETRIES[site] = _RETRIES.get(site, 0) + 1
            inject.emit_event("retry", site=site, attempt=attempt,
                              limit=attempts, error=type(e).__name__,
                              detail=str(e)[:200])
            if attempt >= attempts:
                raise
            time.sleep(_backoff_s(site, attempt - 1, base_s, max_s))
