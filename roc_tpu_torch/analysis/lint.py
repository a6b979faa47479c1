"""roclint for the port: an AST lint for the hazards that never change a
value (roc_tpu/analysis/lint.py, retargeted at a PyTorch tree).

    python -m roc_tpu_torch.analysis.lint [paths]     (default: the package)
    python -m roc_tpu_torch.analysis.lint --list-waivers [paths]

Exit status 0 when clean, 1 on findings (or, with ``--list-waivers``, on a
waiver without a reason).

Rules (waive with ``# roclint: allow(<rule>)`` and a reason, on the
offending or the preceding line):

``host-sync``
    A device->host sync (``.item()``, ``.cpu()``, ``.synchronize()``,
    ``torch.cuda.synchronize()``) inside a *tight timing window* (between
    ``t = time.perf_counter()`` and its ``... - t`` use, windows <=
    ``TIMED_WINDOW_MAX_LINES`` lines): a sync there is being timed, which
    is either the point (waive it, saying why) or a measurement bug.  And
    on the serving path (``roc_tpu_torch/serve/`` and ``fleet/``), where
    the microbatch contract is one sync per drained window, any of those
    or ``np.asarray``/``np.array``: each sanctioned site carries a waiver.
``unkeyed-rand``
    Legacy numpy global-RNG calls (``np.random.rand/randn/seed/...``):
    process-global state; use ``np.random.default_rng(seed)``.
``mutable-default``
    ``def f(x, acc=[])`` / ``={}`` / ``=set()``.
``closure-capture``
    A ``def``/``lambda`` inside a ``for`` body that captures the loop
    variable freely (late binding: every closure sees the last value).
``remat``
    A raw ``torch.utils.checkpoint`` call (``checkpoint``,
    ``checkpoint_sequential``) outside ``roc_tpu_torch/memory/policy.py``:
    ad-hoc recomputation bypasses the memory planner's budget (activation
    plans go through ``-mem-plan``).
``raw-timing``
    A ``t = time.perf_counter()`` / ``perf_counter_ns()`` assignment paired
    with a later ``... - t`` use, outside ``roc_tpu_torch/obs/``: the span
    tracer (``with obs.span("x") as sp`` then ``sp.dur_s``) is the
    sanctioned wall-clock site.  Only real file paths are checked (inline
    ``lint_source`` fixtures are exempt).
``unledgered-prediction``
    A ``predicted_*`` / ``measured_*`` string key in a dict literal, or an
    ``emit()``/``record_event()`` keyword of that shape, outside
    ``roc_tpu_torch/obs/``: predictions flow through the calibration
    ledger (``obs.get_ledger().predict/measure``) so they pair with their
    measurements.
``silent-swallow``
    An ``except`` handler whose whole body is ``pass``/``continue``: the
    error vanishes without a log line or a counter.  Tests are exempt.
``unpinned-host-buffer``
    Inside ``roc_tpu_torch/stream/``, outside the sanctioned allocator
    (``stream/host.py``): a raw ``np.empty/zeros/ones/full``, or a
    ``torch.empty/zeros/ones/full`` with neither ``pin_memory`` nor
    ``device``.  Streamed host stores are staged to the card and come
    pinned from the allocator; host scratch that never ships carries a
    waiver saying so.
``hand-rolled-geometry``
    A ``FwdGeometry(...)`` or ``LaunchTable(...)`` literal outside the
    sites that own the kernels' launch parameters (``ops/kernels/gat.py``,
    ``ops/aggregate.py``, ``tune/``) and tests: a hand-rolled launch
    bypasses the kernels' rule and the tuned store.

Not ported, because they need a jitted context or a tracer that a PyTorch
tree does not have: ``tracer-branch`` (a Python branch on a traced value)
and the jitted half of ``host-sync`` (a sync inside ``jax.jit``-traced
code).  The analysis is per file and does not chase calls across
functions.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import sys
from typing import Dict, List, Optional, Set

TIMED_WINDOW_MAX_LINES = 12

_PKG = "roc_tpu_torch"
# device->host syncs by method name: ``.item()``, ``.cpu()`` and every
# ``synchronize`` (``torch.cuda.synchronize()``, a stream's or an event's)
_SYNC_ATTRS = {"item", "cpu", "synchronize"}
_LEGACY_NP_RANDOM = {
    "rand", "randn", "randint", "random", "random_sample", "normal",
    "uniform", "seed", "shuffle", "permutation", "choice", "binomial",
    "poisson", "standard_normal",
}
_WAIVER_RE = re.compile(r"#\s*roclint:\s*allow\(([a-z\-,\s]+)\)")
# Raw recomputation entry points (the `remat` rule): torch.utils.checkpoint's
# two, under the file's own import spellings (see _remat_heads).
_REMAT_MODULE = "torch.utils.checkpoint"
_REMAT_NAMES = ("checkpoint", "checkpoint_sequential")
# The one module allowed to call them: the memory planner's policy.
_REMAT_EXEMPT_SUFFIX = os.path.join(_PKG, "memory", "policy.py")
# The one package allowed raw monotonic clocks and prediction fields: the
# span tracer and the calibration ledger.
_OBS_DIR = os.path.join(_PKG, "obs") + os.sep
# The serving hot path and the fleet router in front of it.
_SERVE_DIR = os.path.join(_PKG, "serve") + os.sep
_FLEET_DIR = os.path.join(_PKG, "fleet") + os.sep
_SERVE_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                     "numpy.array"}
_PRED_KEY_RE = re.compile(r"^(predicted|measured)_")
# The kernels' launch parameters: their owners and the autotuner.
_GEOM_NAMES = ("FwdGeometry", "LaunchTable")
_GEOM_EXEMPT_SUFFIXES = (
    os.path.join(_PKG, "ops", "kernels", "gat.py"),
    os.path.join(_PKG, "ops", "aggregate.py"),
)
_GEOM_EXEMPT_DIRS = (os.path.join(_PKG, "tune") + os.sep, "tests" + os.sep)
# The streaming tier's host stores come from the pinned allocator.
_STREAM_DIR = os.path.join(_PKG, "stream") + os.sep
_STREAM_ALLOC_EXEMPT_SUFFIX = os.path.join(_PKG, "stream", "host.py")
_RAW_ALLOC_CALLS = {
    "np.empty", "np.zeros", "np.ones", "np.full",
    "numpy.empty", "numpy.zeros", "numpy.ones", "numpy.full",
}
_TORCH_ALLOC_CALLS = {"torch.empty", "torch.zeros", "torch.ones",
                      "torch.full"}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    msg: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


def _dotted(node) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute chains rooted at a Name,
    else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _call_head(call: ast.Call) -> Optional[str]:
    """Dotted name of what a Call invokes; sees through partial(...)."""
    head = _dotted(call.func)
    if head in ("partial", "functools.partial") and call.args:
        return _dotted(call.args[0])
    return head


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _is_test_path(p: str) -> bool:
    return "tests" + os.sep in p or os.path.basename(p).startswith("test_")


class _FileLint:
    def __init__(self, path: str, src: str):
        self.path = path
        self.norm = path.replace("/", os.sep)
        self.src_lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        self.findings: List[Finding] = []

    # -- helpers ----------------------------------------------------------
    def _flag(self, node, rule: str, msg: str):
        line = getattr(node, "lineno", 1)
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.src_lines):
                m = _WAIVER_RE.search(self.src_lines[ln - 1])
                if m and rule in [r.strip()
                                  for r in m.group(1).split(",")]:
                    return
        self.findings.append(Finding(self.path, line, rule, msg))

    @staticmethod
    def _params(func) -> Set[str]:
        a = func.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        for extra in (a.vararg, a.kwarg):
            if extra is not None:
                names.append(extra.arg)
        return set(names)

    @staticmethod
    def _sync_name(node: ast.Call) -> Optional[str]:
        """'.item()' / '.synchronize()' for a sync-shaped call."""
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_ATTRS:
            return "." + node.func.attr + "()"
        return None

    # -- rules ------------------------------------------------------------
    def run(self) -> List[Finding]:
        self._rule_timed_windows()
        self._rule_raw_timing()
        self._rule_unkeyed_rand()
        self._rule_mutable_default()
        self._rule_closure_capture()
        self._rule_remat()
        self._rule_unledgered_prediction()
        self._rule_hand_rolled_geometry()
        self._rule_serve_sync()
        self._rule_silent_swallow()
        self._rule_unpinned_host_buffer()
        return self.findings

    def _rule_unpinned_host_buffer(self):
        """Raw host allocations in stream/ outside stream/host.py."""
        if _STREAM_DIR not in self.norm or \
                self.norm.endswith(_STREAM_ALLOC_EXEMPT_SUFFIX):
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            head = _call_head(node)
            kws = {kw.arg for kw in node.keywords}
            if head in _RAW_ALLOC_CALLS or (
                    head in _TORCH_ALLOC_CALLS
                    and not kws & {"pin_memory", "device"}):
                self._flag(
                    node, "unpinned-host-buffer",
                    f"raw {head}(...) in {_PKG}/stream/: staged host "
                    "stores come from the allocator (stream/host.py, "
                    "pinned); waive only host scratch that never ships")

    def _rule_silent_swallow(self):
        """``except: pass`` / ``except: continue``.  Flags the handler's
        first body statement, so a waiver works on the ``pass`` line, the
        comment above it, or the ``except`` line when ``pass`` follows."""
        if _is_test_path(self.norm):
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.body and all(isinstance(s, (ast.Pass, ast.Continue))
                                 for s in node.body):
                kind = _dotted(node.type) if node.type is not None \
                    else "bare except"
                self._flag(node.body[0], "silent-swallow",
                           f"except handler ({kind}) swallows the error "
                           f"with no log/counter; emit a warn-once or obs "
                           f"event, or waive with a rationale for why "
                           f"dropping it is correct")

    def _rule_serve_sync(self):
        """Sync-shaped calls in serve/ and fleet/."""
        if _SERVE_DIR not in self.norm and _FLEET_DIR not in self.norm:
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = self._sync_name(node)
            head = _dotted(node.func)
            if name is None and head in _SERVE_SYNC_CALLS:
                name = head + "()"
            if name:
                self._flag(node, "host-sync",
                           f"{name} on the serving path is a potential "
                           f"device->host sync; one per drained window is "
                           f"the contract (waive the sanctioned site)")

    def _rule_timed_windows(self):
        """Host syncs inside a tight perf_counter window."""
        for func in ast.walk(self.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            starts: Dict[str, int] = {}
            ends: Dict[str, int] = {}
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    if self._is_perf_clock(node.value):
                        starts.setdefault(node.targets[0].id, node.lineno)
                elif isinstance(node, ast.BinOp) and \
                        isinstance(node.op, ast.Sub) and \
                        isinstance(node.right, ast.Name) and \
                        node.right.id in starts and \
                        node.lineno > starts[node.right.id]:
                    ends.setdefault(node.right.id, node.lineno)
            for t, lo in starts.items():
                hi = ends.get(t)
                if hi is None or hi - lo > TIMED_WINDOW_MAX_LINES:
                    continue
                for node in ast.walk(func):
                    if not isinstance(node, ast.Call) or \
                            not lo < getattr(node, "lineno", 0) < hi:
                        continue
                    name = self._sync_name(node)
                    if name:
                        self._flag(
                            node, "host-sync",
                            f"{name} inside the timed window of "
                            f"{t!r} ({lo}..{hi}): timing a host sync; "
                            f"move it out or waive with a justification")

    @classmethod
    def _scope_walk(cls, scope):
        """Pre-order walk that does not descend into nested functions, so
        each timing window binds within one scope."""
        for child in ast.iter_child_nodes(scope):
            yield child
            if not isinstance(child, _FUNC_NODES):
                yield from cls._scope_walk(child)

    @staticmethod
    def _is_perf_clock(expr) -> bool:
        for c in ast.walk(expr):
            if isinstance(c, ast.Call):
                head = _dotted(c.func) or ""
                if head.endswith("perf_counter") or \
                        head.endswith("perf_counter_ns"):
                    return True
        return False

    def _rule_raw_timing(self):
        """Hand-rolled perf_counter windows outside obs/."""
        if not self.path.endswith(".py") or _OBS_DIR in self.norm:
            return  # inline lint_source fixtures ("<string>") are exempt
        scopes = [self.tree] + [n for n in ast.walk(self.tree)
                                if isinstance(n, _FUNC_NODES)]
        for scope in scopes:
            starts: Dict[str, ast.AST] = {}
            flagged: Set[str] = set()
            for node in self._scope_walk(scope):
                if isinstance(node, ast.Assign) and \
                        len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Name) and \
                        self._is_perf_clock(node.value):
                    starts.setdefault(node.targets[0].id, node)
                elif isinstance(node, ast.BinOp) and \
                        isinstance(node.op, ast.Sub) and \
                        isinstance(node.right, ast.Name) and \
                        node.right.id in starts and \
                        node.right.id not in flagged and \
                        node.lineno > starts[node.right.id].lineno:
                    t = node.right.id
                    flagged.add(t)
                    self._flag(
                        starts[t], "raw-timing",
                        f"raw perf_counter timing window for {t!r}; time "
                        f"through obs.span ({_PKG}/obs is the sanctioned "
                        f"clock site) so the measurement reaches the trace")

    def _rule_unkeyed_rand(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                head = _dotted(node.func) or ""
                parts = head.split(".")
                if len(parts) == 3 and parts[0] in ("np", "numpy") and \
                        parts[1] == "random" and \
                        parts[2] in _LEGACY_NP_RANDOM:
                    self._flag(node, "unkeyed-rand",
                               f"{head}() uses the process-global legacy "
                               f"RNG; use np.random.default_rng(seed)")

    def _rule_mutable_default(self):
        for node in ast.walk(self.tree):
            if not isinstance(node, _FUNC_NODES):
                continue
            defaults = list(node.args.defaults) + \
                [d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                bad = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(d, ast.Call)
                    and _dotted(d.func) in ("list", "dict", "set")
                    and not d.args and not d.keywords)
                if bad:
                    self._flag(d, "mutable-default",
                               "mutable default argument is shared "
                               "across calls; default to None")

    def _remat_heads(self) -> Set[str]:
        """The call heads that reach torch.utils.checkpoint in this file:
        the dotted path, a bare ``checkpoint``/``checkpoint_sequential``
        (as roc_tpu flags a bare ``checkpoint``), and whatever the file's
        imports bind to the module or its two functions."""
        heads = set(_REMAT_NAMES) | {f"{_REMAT_MODULE}.{n}"
                                     for n in _REMAT_NAMES}
        for node in ast.walk(self.tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.asname for a in node.names
                        if a.name == _REMAT_MODULE and a.asname]
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    name = a.asname or a.name
                    if f"{node.module}.{a.name}" == _REMAT_MODULE:
                        mods.append(name)
                    elif node.module == _REMAT_MODULE and \
                            a.name in _REMAT_NAMES:
                        heads.add(name)
            heads |= {f"{m}.{n}" for m in mods for n in _REMAT_NAMES}
        return heads

    def _rule_remat(self):
        """Raw torch.utils.checkpoint outside the memory policy module."""
        if self.norm.endswith(_REMAT_EXEMPT_SUFFIX):
            return
        heads = self._remat_heads()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and _call_head(node) in heads:
                self._flag(node, "remat",
                           f"raw {_call_head(node)}() bypasses the memory "
                           f"planner's budget accounting; route "
                           f"recomputation through {_PKG}/memory "
                           f"(-mem-plan) or waive with a rationale")

    def _rule_hand_rolled_geometry(self):
        """Launch-parameter literals outside their owners and the tuner."""
        if any(self.norm.endswith(s) for s in _GEOM_EXEMPT_SUFFIXES) or \
                any(d in self.norm for d in _GEOM_EXEMPT_DIRS) or \
                os.path.basename(self.norm).startswith("test_"):
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            head = _call_head(node) or ""
            if head.split(".")[-1] in _GEOM_NAMES:
                self._flag(node, "hand-rolled-geometry",
                           f"{head}(...) hand-rolls a kernel launch, "
                           f"bypassing the kernels' rule and the tuned "
                           f"store; use forward_geometry / the tuner, or "
                           f"waive with a rationale")

    def _rule_unledgered_prediction(self):
        """predicted_*/measured_* fields minted outside the ledger."""
        if _OBS_DIR in self.norm:
            return
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str) and \
                            _PRED_KEY_RE.match(k.value):
                        self._flag(
                            k, "unledgered-prediction",
                            f"dict key {k.value!r} mints a prediction/"
                            f"measurement outside the calibration ledger; "
                            f"route it through obs.get_ledger()."
                            f"predict/measure, or waive with a rationale")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("emit", "record_event"):
                for kw in node.keywords:
                    if kw.arg and _PRED_KEY_RE.match(kw.arg):
                        self._flag(
                            node, "unledgered-prediction",
                            f"{node.func.attr}(..., {kw.arg}=...) emits a "
                            f"prediction/measurement field outside the "
                            f"calibration ledger; use obs.get_ledger()."
                            f"predict/measure")

    def _rule_closure_capture(self):
        for loop in ast.walk(self.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor)):
                continue
            targets = {n.id for n in ast.walk(loop.target)
                       if isinstance(n, ast.Name)}
            for node in ast.walk(loop):
                if node is loop or not isinstance(node, _FUNC_NODES):
                    continue
                bound = self._params(node)
                # names the closure assigns locally are not captures
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) and \
                            isinstance(sub.ctx, ast.Store):
                        bound.add(sub.id)
                free = {n.id for n in ast.walk(node)
                        if isinstance(n, ast.Name)
                        and isinstance(n.ctx, ast.Load)} - bound
                # decorator expressions evaluate at def time: a loop
                # variable there is bound at once, not a late capture
                if not isinstance(node, ast.Lambda):
                    deco_names = set()
                    for deco in node.decorator_list:
                        deco_names |= {n.id for n in ast.walk(deco)
                                       if isinstance(n, ast.Name)}
                    body_names = set()
                    for part in node.body:
                        body_names |= {n.id for n in ast.walk(part)
                                       if isinstance(n, ast.Name)
                                       and isinstance(n.ctx, ast.Load)}
                    free -= deco_names - body_names
                captured = free & targets
                if captured:
                    self._flag(node, "closure-capture",
                               f"closure captures loop variable(s) "
                               f"{sorted(captured)} by reference (late "
                               f"binding); bind via default arg")


def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    return _FileLint(path, src).run()


def lint_file(path: str) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def iter_py(paths) -> List[str]:
    """The ``.py`` files of ``paths`` (files and directory trees), sorted."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git", "build")]
                out += [os.path.join(root, fn) for fn in sorted(files)
                        if fn.endswith(".py")]
        elif p.endswith(".py"):
            out.append(p)
    return sorted(out)


def lint_paths(paths) -> List[Finding]:
    """Lint files and/or directory trees (``.py`` only)."""
    out: List[Finding] = []
    for path in iter_py(paths):
        out.extend(lint_file(path))
    return sorted(out, key=lambda f: (f.path, f.line))


def list_waivers(paths) -> list:
    """Every ``# roclint: allow(...)`` of ``paths`` as ``(path, line,
    rules, reason)``.  The reason is the prose after the closing paren on
    the same line; a waiver without one cannot be audited."""
    out = []
    for path in iter_py(paths):
        with open(path, encoding="utf-8") as f:
            for ln, line in enumerate(f.read().splitlines(), 1):
                m = _WAIVER_RE.search(line)
                if not m:
                    continue
                if m.start() > 0 and line[m.start() - 1] == "`":
                    continue   # a mention in prose (``# roclint: ...``)
                rules = ",".join(r.strip() for r in m.group(1).split(","))
                reason = line[m.end():].strip().lstrip("—-: ").strip()
                out.append((path, ln, rules, reason))
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog=f"python -m {_PKG}.analysis.lint",
                                 description="roclint for the port")
    ap.add_argument("paths", nargs="*", help=f"files/dirs (default: {_PKG})")
    ap.add_argument("--list-waivers", action="store_true",
                    help="print every waiver; exit 1 if one has no reason")
    args = ap.parse_args(argv)
    paths = args.paths or [_PKG]
    if args.list_waivers:
        rows = list_waivers(paths)
        for path, ln, rules, reason in rows:
            print(f"{path}:{ln}: allow({rules}) {reason or '<NO REASON>'}")
        bad = sum(1 for r in rows if not r[3])
        print(f"# roclint: {len(rows)} waiver(s), {bad} without a reason",
              file=sys.stderr)
        return 1 if bad else 0
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    print(f"# roclint: {len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
