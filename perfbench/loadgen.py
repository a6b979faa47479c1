"""Open-loop offers with due-time accounting.

Each item is offered when its schedule makes it due, however late the
answers come: a request is timed from its due time, so a stall is charged
to every request that waited behind it, and ``late_s`` records how far
behind its schedule the offering thread itself ran.  A request that raises
(refused, shed, expired) counts as failed and as missing every latency
limit."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, List, Sequence, Tuple


@dataclasses.dataclass
class Offer:
    due: float        # absolute, on the clock
    sent: float       # when the call was made
    returned: float   # when the call returned
    payload: Any
    result: Any = None
    error: BaseException = None

    @property
    def late_s(self) -> float:
        return self.sent - self.due


def offer(schedule: Sequence[Tuple[float, Any]], act: Callable, t0: float,
          clock=time.perf_counter, sleep=time.sleep,
          label=None) -> List[Offer]:
    """Call ``act(payload)`` for each (offset, payload) at ``t0 +
    offset``, in order, on this thread."""
    out = []
    for off, payload in schedule:
        due = t0 + off
        wait = due - clock()
        if wait > 0:
            sleep(wait)
        o = Offer(due, clock(), 0.0, payload)
        try:
            if label is None:
                o.result = act(payload)
            else:
                with label():
                    o.result = act(payload)
        except Exception as e:  # a refused request is a failed one
            o.error = e
        o.returned = clock()
        out.append(o)
    return out


def settle(offers: List[Offer], timeout_s: float) -> None:
    """Wait for each submitted future (``result`` with a ``result(timeout)``
    and ``t_done``), up to ``timeout_s`` past now in all; a future that
    raises or never comes is a failure."""
    end = time.perf_counter() + timeout_s
    for o in offers:
        if o.error is not None:
            continue
        try:
            o.result.result(max(end - time.perf_counter(), 0.0))
        except Exception as e:
            o.error = e


def latency_s(o: Offer, done_attr: str = "") -> float:
    """Seconds from due to done (the future's ``t_done``, or the call's
    return); infinite for a failure."""
    if o.error is not None:
        return math.inf
    end = getattr(o.result, done_attr) if done_attr else o.returned
    return end - o.due


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q of all at or
    below it."""
    vals = sorted(values)
    if not vals:
        return math.nan
    i = max(0, math.ceil(q * len(vals)) - 1)
    return vals[i]
