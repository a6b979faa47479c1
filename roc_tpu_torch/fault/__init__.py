"""Fault-tolerant runtime (roc_tpu/fault): the non-finite step guard, and
the fault injection, retry and durability that ``graph/lux.py`` reads and
writes through.

  inject.py   deterministic seeded fault injection: ``point("site")``
              hooks, armed via ROC_FAULT, no-op otherwise
  retry.py    bounded jittered-exponential retry (``retrying``), per-site
              counters
  durable.py  fsync-before-rename (``fsync_replace``), shared by every
              atomic writer of the port
  guard.py    the non-finite step guard (``guarded_update``) and the
              ``step.nan`` loss scale (``nan_scale``)
"""

from roc_tpu_torch.fault.durable import fsync_replace
from roc_tpu_torch.fault.guard import global_norm, guarded_update, nan_scale
from roc_tpu_torch.fault.inject import (InjectedFault, SimulatedCrash, armed,
                                        attach, configure, counters, detach,
                                        emit_event, parse_spec, point, spec)
from roc_tpu_torch.fault.retry import (reset_retry_counts, retry_counts,
                                       retrying)

__all__ = [
    "InjectedFault", "SimulatedCrash", "armed", "attach", "configure",
    "counters", "detach", "emit_event", "fsync_replace", "global_norm",
    "guarded_update", "nan_scale", "parse_spec", "point", "reset_retry_counts",
    "retry_counts", "retrying", "spec",
]
