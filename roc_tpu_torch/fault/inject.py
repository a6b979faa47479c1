"""Deterministic, seeded fault injection (roc_tpu/fault/inject.py, a
copy: the module needs only the standard library).

A failure-prone boundary registers a named *injection site* by calling
``point("site.name")``: a dict lookup when disarmed, so the hooks cost
nothing in production.  Armed via ``ROC_FAULT=<spec>`` (or
``configure(spec)``), a site raises :class:`InjectedFault` (an
``OSError``, so the shared retry wrapper treats it exactly like a real
transient I/O error), sleeps (``.slow`` sites), reports "inject a NaN" to
its caller (``.nan`` sites), or raises :class:`SimulatedCrash` (``.kill*``
sites: a ``BaseException``, so it sails through ``except Exception``
handlers and the retry wrapper the way a real ``kill -9`` would).

Spec grammar (comma-separated tokens)::

    seed=7                  # schedule seed (default 0)
    retries=0               # override the retry budget at EVERY
                            # retrying() site (0 disables retry)
    slow_ms=80              # sleep for .slow sites (default 50 ms)
    lux.read=2              # fail the first 2 calls at this site
    lux.read=perm           # fail every call (permanent fault)
    lux.read@0.2            # fail each call w.p. 0.2, seeded/deterministic

The probabilistic form hashes ``(seed, site, call_index)``: two runs with
the same spec fire at the same call indices.

Registered sites in the port: ``lux.read`` (graph/lux.py) and
``step.nan`` (fault/guard.py:nan_scale, once per training step).  The
trainer arms ``Config.fault`` when it differs from the armed spec.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple


class InjectedFault(OSError):
    """A synthetic transient fault (retryable, like a real I/O error)."""


class SimulatedCrash(BaseException):
    """A synthetic hard kill.  BaseException so it propagates through
    retry wrappers and ``except Exception`` cleanup the way SIGKILL
    would — only the test/selftest harness that armed it catches it."""


class _Rule:
    __slots__ = ("count", "perm", "prob")

    def __init__(self, count: Optional[int] = None, perm: bool = False,
                 prob: Optional[float] = None):
        self.count = count
        self.perm = perm
        self.prob = prob


class _State:
    def __init__(self, seed: int, retries: Optional[int],
                 slow_s: float, rules: Dict[str, _Rule], spec: str):
        self.seed = seed
        self.retries = retries
        self.slow_s = slow_s
        self.rules = rules
        self.spec = spec


_LOCK = threading.Lock()
_STATE: Optional[_State] = None
_CALLS: Dict[str, int] = {}    # per-site call index (counted when armed)
_FIRED: Dict[str, int] = {}    # per-site injected-fault count
_EMIT: Optional[Callable] = None   # obs JSONL sink (MetricsRegistry.emit)


def parse_spec(spec: str) -> Tuple[int, Optional[int], float,
                                   Dict[str, _Rule]]:
    """Parse a ROC_FAULT spec; ValueError on malformed input (config
    validation turns that into the usual SystemExit)."""
    seed, retries, slow_s = 0, None, 0.05
    rules: Dict[str, _Rule] = {}
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "@" in tok:
            site, _, p = tok.partition("@")
            prob = float(p)
            if not site or not (0.0 <= prob <= 1.0):
                raise ValueError(f"bad fault token {tok!r} "
                                 "(want site@prob, 0 <= prob <= 1)")
            rules[site] = _Rule(prob=prob)
            continue
        if "=" not in tok:
            raise ValueError(f"bad fault token {tok!r} "
                             "(want key=value or site@prob)")
        key, _, val = tok.partition("=")
        if key == "seed":
            seed = int(val)
        elif key == "retries":
            retries = int(val)
            if retries < 0:
                raise ValueError("retries must be >= 0")
        elif key == "slow_ms":
            slow_s = float(val) / 1e3
        elif val == "perm":
            rules[key] = _Rule(perm=True)
        else:
            n = int(val)
            if n < 0:
                raise ValueError(f"bad fault count in {tok!r}")
            rules[key] = _Rule(count=n)
    return seed, retries, slow_s, rules


def configure(spec: str) -> None:
    """Arm (or, with an empty spec, disarm) the harness and reset the
    per-site counters.  Thread-safe; tests call this directly."""
    global _STATE
    with _LOCK:
        _CALLS.clear()
        _FIRED.clear()
        if not (spec or "").strip():
            _STATE = None
            return
        seed, retries, slow_s, rules = parse_spec(spec)
        _STATE = _State(seed, retries, slow_s, rules, spec)


def armed() -> bool:
    return _STATE is not None


def spec() -> str:
    st = _STATE
    return st.spec if st is not None else ""


def retry_override() -> Optional[int]:
    """The spec's ``retries=N`` token (None = spec silent; retry sites
    keep their own defaults).  0 disables retry everywhere."""
    st = _STATE
    return st.retries if st is not None else None


def counters() -> Dict[str, Dict[str, int]]:
    """Snapshot of per-site {calls, fired} counts (tests + selftest)."""
    with _LOCK:
        sites = set(_CALLS) | set(_FIRED)
        return {s: {"calls": _CALLS.get(s, 0), "fired": _FIRED.get(s, 0)}
                for s in sorted(sites)}


def attach(emit: Callable) -> None:
    """Route fault/retry events into an obs JSONL sink
    (``MetricsRegistry.emit``-shaped: ``emit(kind, **fields)``)."""
    global _EMIT
    _EMIT = emit


def detach() -> None:
    global _EMIT
    _EMIT = None


def emit_event(kind: str, **fields) -> None:
    """Best-effort structured event (dropped when no sink is attached)."""
    sink = _EMIT
    if sink is not None:
        try:
            sink(kind, **fields)
        except Exception:  # roclint: allow(silent-swallow) — telemetry
            pass           # must never take down the operation it observes


def _should_fire(st: _State, site: str, rule: _Rule, idx: int) -> bool:
    if rule.perm:
        return True
    if rule.count is not None:
        return idx < rule.count
    h = hashlib.sha256(f"{st.seed}:{site}:{idx}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64 < (rule.prob or 0.0)


def point(site: str) -> bool:
    """The injection hook.  Disarmed: returns False (one dict lookup).
    Armed and scheduled to fire: raises :class:`InjectedFault`
    (default), raises :class:`SimulatedCrash` (``.kill`` sites), sleeps
    (``.slow`` sites, returns False), or returns True (``.nan`` sites —
    the caller injects the NaN itself, keeping the jit trace intact)."""
    st = _STATE
    if st is None:
        return False
    with _LOCK:
        idx = _CALLS.get(site, 0)
        _CALLS[site] = idx + 1
        rule = st.rules.get(site)
        if rule is None or not _should_fire(st, site, rule, idx):
            return False
        _FIRED[site] = _FIRED.get(site, 0) + 1
    emit_event("fault", site=site, call=idx)
    if site.endswith(".nan"):
        return True
    if site.endswith(".slow"):
        time.sleep(st.slow_s)
        return False
    if ".kill" in site:
        raise SimulatedCrash(f"fault: simulated crash at {site!r} "
                             f"(call {idx})")
    raise InjectedFault(f"fault: injected transient fault at {site!r} "
                        f"(call {idx})")


# Arm from the environment at import, so every entry point (python -m
# roc_tpu_torch, the converter, a test's subprocess) sees the same spec
# without plumbing.
configure(os.environ.get("ROC_FAULT", ""))
