"""Runtime lock-order witness: the dynamic half of roc-threads
(roc_tpu/analysis/witness.py).

The static analyzer (:mod:`roc_tpu_torch.analysis.threads`) derives the
sanctioned lock-order graph from the AST; this module checks that graph
against *reality*.  Every sanctioned lock site wraps its primitive in
``trace(name, lock)``:

* **Disarmed** (the default): ``trace`` returns the primitive untouched —
  the serving hot path pays literally zero cost, not even an attribute
  indirection.  Arming is decided once, at lock *creation* time.
* **Armed** (``ROC_OBS=1`` / ``ROC_WITNESS=1`` in the environment, or an
  explicit :func:`arm` before the locks are created; the threaded test
  suites use :func:`armed_scope`): ``trace`` returns a proxy that keeps a
  thread-local stack of held witness names and records every *new*
  (outer, inner) acquisition pair, both in-process (for
  :func:`validate`) and as a ``lock_order`` event on the shared
  telemetry JSONL via ``fault.emit_event`` (best-effort: dropped when no
  obs sink is attached, like every other fault event).

``validate(edges)`` asserts every observed pair is inside the static
graph (transitive closure — holding A while taking C is fine when the
graph sanctions A→B→C).  Re-entrant same-name acquisitions (RLock) are
never recorded: they order nothing.  ``Condition.wait`` releases and
reacquires its lock, so the proxy drops the name for the duration of the
wait and re-records the reacquisition — a wait that comes back while the
thread holds other locks is a real ordering event and is witnessed as
one.

The witness deliberately wraps only the *sanctioned* sites the analyzer
names (serve queue CV, plan lock, delta mutation lock, prefetch-ring
lock, in-proc transport CV).  The fault/retry leaf locks stay raw: the
proxy itself emits through ``fault``, and witnessing the emitter's own
lock would recurse.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["arm", "armed", "armed_scope", "trace", "observed_pairs",
           "records", "reset", "validate"]

_ARMED = os.environ.get("ROC_OBS", "") == "1" \
    or os.environ.get("ROC_WITNESS", "") == "1"

_TLS = threading.local()
_MU = threading.Lock()                       # guards the two tables below
_PAIRS: Dict[Tuple[str, str], int] = {}      # (outer, inner) -> count
_EMITTED: Set[Tuple[str, str]] = set()       # pairs already on the JSONL


def arm(on: bool = True) -> None:
    """Arm/disarm the witness for locks created *after* this call.
    Locks already handed out keep whatever they were born as — a raw
    primitive stays raw, a proxy keeps witnessing (its records are
    simply ignored by a later reset())."""
    global _ARMED
    _ARMED = bool(on)


def armed() -> bool:
    return _ARMED


def trace(name: str, lock):
    """Wrap ``lock`` under the static graph's node name (``Class.attr``).
    Returns ``lock`` itself when disarmed — zero overhead — else a
    recording proxy.  The analyzer cross-checks ``name`` against the
    attribute the result is assigned to (rule ``witness-name``)."""
    if not _ARMED:
        return lock
    return _WitnessLock(name, lock)


def _held() -> List[str]:
    h = getattr(_TLS, "held", None)
    if h is None:
        h = _TLS.held = []
    return h


def _record_entry(name: str) -> None:
    held = _held()
    fresh = name not in held
    held.append(name)
    if not fresh:
        return                       # re-entrant (RLock): orders nothing
    new_pairs = []
    with _MU:
        # dict.fromkeys: a re-entrantly held outer appears once per
        # depth on the stack but orders against `name` exactly once
        for outer in dict.fromkeys(held[:-1]):
            if outer == name:
                continue
            key = (outer, name)
            n = _PAIRS.get(key, 0)
            _PAIRS[key] = n + 1
            if key not in _EMITTED:
                _EMITTED.add(key)
                new_pairs.append(key)
    for outer, inner in new_pairs:
        # best-effort JSONL record; import here keeps this module
        # import-light and breaks no cycle when fault pulls analysis in
        from roc_tpu_torch import fault
        fault.emit_event("lock_order", outer=outer, inner=inner)


def _record_exit(name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


class _WitnessLock:
    """Delegating proxy over Lock/RLock/Condition.  Only the methods the
    tree actually uses are wrapped; everything else falls through."""

    def __init__(self, name: str, lock):
        self._name = name
        self._lock = lock

    # -- context manager / lock face -----------------------------------
    def __enter__(self):
        out = self._lock.__enter__()
        _record_entry(self._name)
        return out

    def __exit__(self, *exc):
        _record_exit(self._name)
        return self._lock.__exit__(*exc)

    def acquire(self, *a, **kw):
        got = self._lock.acquire(*a, **kw)
        if got:
            _record_entry(self._name)
        return got

    def release(self):
        _record_exit(self._name)
        return self._lock.release()

    def locked(self):
        return self._lock.locked()

    # -- condition face -------------------------------------------------
    def wait(self, timeout: Optional[float] = None):
        # wait() releases the underlying lock for its duration; the
        # reacquisition on wake is a real ordering event vs. anything
        # else this thread still holds, so drop + re-record.
        _record_exit(self._name)
        try:
            return self._lock.wait(timeout)
        finally:
            _record_entry(self._name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _record_exit(self._name)
        try:
            return self._lock.wait_for(predicate, timeout)
        finally:
            _record_entry(self._name)

    def notify(self, n: int = 1):
        return self._lock.notify(n)

    def notify_all(self):
        return self._lock.notify_all()

    def __repr__(self):
        return f"<witness {self._name!r} over {self._lock!r}>"


# -- inspection / validation ------------------------------------------------

def observed_pairs() -> Dict[Tuple[str, str], int]:
    with _MU:
        return dict(_PAIRS)


def records() -> int:
    """Total distinct pairs recorded since the last reset (the number of
    ``lock_order`` events that reached — or would have reached — the
    telemetry JSONL)."""
    with _MU:
        return len(_PAIRS)


def reset() -> None:
    with _MU:
        _PAIRS.clear()
        _EMITTED.clear()


def _closure(edges) -> Set[Tuple[str, str]]:
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    out: Set[Tuple[str, str]] = set()
    for a in list(adj):
        seen: Set[str] = set()
        stack = list(adj.get(a, ()))
        while stack:
            b = stack.pop()
            if b in seen:
                continue
            seen.add(b)
            out.add((a, b))
            stack.extend(adj.get(b, ()))
    return out


def validate(edges=None) -> List[str]:
    """Every observed (outer, inner) pair must sit inside the sanctioned
    lock-order graph.  ``edges`` defaults to the committed
    ``threads.json`` baseline; returns human-readable violations (empty
    = the runtime agreed with the static graph)."""
    if edges is None:
        from roc_tpu_torch.analysis import threads as _threads
        edges = _threads.load_baseline()["edges"]
    allowed = _closure(tuple(e) for e in edges)
    out = []
    for (a, b), n in sorted(observed_pairs().items()):
        if (a, b) not in allowed:
            out.append(f"observed {a} -> {b} ({n}x) is not an edge of "
                       f"the static lock-order graph")
    return out


@contextlib.contextmanager
def armed_scope(edges=None):
    """Arm the witness for the body (locks created inside it witness),
    then validate what it observed against ``edges`` (default: the
    committed baseline) and disarm.  Yields the module; raises
    AssertionError listing the violations when an observed order is off
    the graph."""
    was = armed()
    reset()
    arm(True)
    try:
        yield sys.modules[__name__]
        violations = validate(edges)
    finally:
        arm(was)
        reset()
    assert violations == [], violations
