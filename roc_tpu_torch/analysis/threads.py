"""roc-threads for the port: whole-tree lock-discipline and race analyzer
(roc_tpu/analysis/threads.py, retargeted at ``roc_tpu_torch``).

ROC inherits data-race freedom from Legion's task model; the port, like
roc_tpu, has hand-rolled Python threads instead (serve-queue worker,
background replan, prefetch ring, fleet transports).  This pass makes that
concurrency contract machine-checked: derive the discipline from the AST,
commit it as a baseline (``threads.json`` beside this file), and refuse
drift.

    python -m roc_tpu_torch.analysis.threads [paths]   (default: the package)
    python -m roc_tpu_torch.analysis.threads --update  (rewrite threads.json)
    python -m roc_tpu_torch.analysis.threads --selftest

Run it from the repository root: lock paths in the baseline are relative.

What it computes:

* **Inventory** — every ``threading.{Lock,RLock,Condition,Event}``
  attribute (plus module-level locks and ``ThreadPoolExecutor``s), every
  ``Thread(target=...)`` spawn with its daemon flag, storage attribute
  and join/shutdown reachability.
* **Lock-order graph** — lock B acquired while A is held, propagated
  through same-class method calls, resolved attribute calls
  (``self.journal.append``) and imported module functions, with
  constructor-argument unification so a lock passed across classes is
  one node (``ServeEngine._plan_lock`` IS ``DeltaManager._plan_lock``).
  Cycles are ``lock-cycle`` findings (potential deadlocks).
* **Guarded-by facts** — an attribute consistently accessed under lock
  L (>= 3 accesses, at least one store) is inferred guarded-by L; a bare
  *store* from any method not reachable from ``__init__`` (construction
  happens-before publication) is an ``unguarded-attr`` finding.  Bare
  loads are never findings: stats snapshots read racily on purpose.
* **Rules** — ``condvar-wait`` (a ``Condition.wait`` outside a predicate
  loop), ``thread-join`` (a spawned thread/pool no ``close()``/join
  reaches), ``lock-blocking`` (a lock held across a blocking or
  chaos-injectable call: ``fault.point``/``fault.retrying``, fsync,
  ``time.sleep``, a subprocess, socket sends, ``.join`` (not
  ``os.path.join``)/``.result``/non-condvar ``.wait``), ``witness-name`` (a ``witness.trace`` name that disagrees
  with the attribute it is bound to).

Findings are waivable with ``# roclint: allow(<rule>)`` on the offending
or preceding line; waivers carry a reason (``python -m
roc_tpu_torch.analysis.lint --list-waivers`` enforces that).  The committed
baseline is exact-diffed; regenerate deliberate drift with ``--update`` and
review the diff.

Known precision limits (deliberate, mirroring lint.py's per-file trade):
calls through function-valued attributes (``self._serve_fn``), late
bindings (``self.engine.deltas``) and jit-wrapped closures are not
chased.  Runtime orders those paths create are covered by the *witness*
(:mod:`roc_tpu_torch.analysis.witness`): the port's threaded test suites
arm it and validate every real acquisition order against this graph.
Edges real at runtime but invisible to the AST are declared in
``DECLARED_EDGES`` with a reason and become part of the graph.

``--selftest`` proves the rules bite: a clean fixture stays clean and each
seeded mutation (lock inversion, dropped guard, waitless condvar wait,
unjoined thread, a lock held across fsync, a mislabeled witness name) is
caught.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, List, Optional, Set, Tuple

from roc_tpu_torch.analysis.lint import (Finding, _WAIVER_RE, _call_head,
                                         _dotted, iter_py)

__all__ = ["analyze_paths", "analyze_source", "load_baseline",
           "diff_baseline", "report_dict", "save_baseline", "selftest",
           "BASELINE_PATH", "DECLARED_EDGES"]

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "threads.json")

# Real runtime lock orders the AST cannot see (calls through
# function-valued attributes); each carries its reason into threads.json
# and the witness validator accepts them like any derived edge.
DECLARED_EDGES: List[Tuple[str, str, str]] = [
    ("ServeEngine._plan_lock", "PrefetchRing._lock",
     "streamed serving: the serve worker holds the plan lock for the "
     "whole window while bundle.predict_logits() sweeps shards through "
     "the prefetch ring (reached through FrozenBundle's stream trainer, "
     "a function-valued attribute outside the static call graph)"),
]

_LOCK_CTORS = {
    "threading.Lock": "Lock", "threading.RLock": "RLock",
    "threading.Condition": "Condition", "threading.Event": "Event",
    "threading.Semaphore": "Semaphore",
    "threading.BoundedSemaphore": "Semaphore",
}
# Lock kinds that guard (Events only gate; they are inventoried but
# never treated as mutual exclusion).
_GUARDING = {"Lock", "RLock", "Condition", "Semaphore", "external"}

# Call heads that block or sit in a chaos kill window; holding a lock
# across one stalls (or strands, under an injected kill) every waiter.
_BLOCKING_HEADS = {
    "fault.point": "fault.point", "fault.retrying": "fault.retrying",
    "fault.fsync_replace": "fsync_replace", "os.fsync": "os.fsync",
    "time.sleep": "time.sleep", "subprocess.run": "subprocess",
    "subprocess.check_call": "subprocess",
    "subprocess.check_output": "subprocess",
}
# Calls whose last name is a blocking attribute but which never block.
_NONBLOCKING_HEADS = {"os.path.join", "posixpath.join", "shlex.join"}
# The package prefix dropped from module-level lock names
# ("roc_tpu_torch.fault.inject" -> "fault.inject._LOCK").
_PKG_PREFIX = "roc_tpu_torch."
# Attribute calls that block regardless of receiver type.
_BLOCKING_ATTRS = {"join": ".join", "result": ".result",
                   "sendall": ".sendall"}

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


# -- inventory dataclasses ---------------------------------------------------

@dataclasses.dataclass
class LockNode:
    name: str            # "DeltaManager._mu" / "fault.inject._LOCK"
    kind: str            # Lock | RLock | Condition | Event | ... | external
    path: str
    line: int
    witness_name: Optional[str] = None   # the trace() string, if wrapped


@dataclasses.dataclass
class ThreadSpawn:
    target: str          # "MicrobatchQueue._run" or "?"
    daemon: bool
    stored: str          # "DeltaManager._replan_thread" / "<local>" / ""
    joined: bool
    pool: bool
    path: str
    line: int


@dataclasses.dataclass
class Report:
    locks: List[LockNode]
    threads: List[ThreadSpawn]
    edges: Dict[Tuple[str, str], Tuple[str, int]]   # (a,b) -> first site
    guarded_by: Dict[str, str]                      # "Class.attr" -> lock
    findings: List[Finding]
    waived: int


# -- phase 1: per-module scan ------------------------------------------------

class _ClassScan:
    def __init__(self, name: str, module: str, path: str,
                 node: ast.ClassDef):
        self.name = name
        self.module = module
        self.path = path
        self.node = node
        self.methods: Dict[str, ast.AST] = {}
        # attr -> (kind, line, witness_name)
        self.locks: Dict[str, Tuple[str, int, Optional[str]]] = {}
        # attr -> (param, line): assigned from a ctor parameter
        self.ext_candidates: Dict[str, Tuple[str, int]] = {}
        self.attr_type_heads: Dict[str, str] = {}   # attr -> raw call head
        self.spawns: List[dict] = []
        self.joined_attrs: Set[str] = set()
        self.shutdown_attrs: Set[str] = set()
        self.with_attrs: Set[str] = set()   # self.X used as `with`/.wait


class _ModuleScan:
    def __init__(self, path: str, module: str, tree: ast.Module,
                 src_lines: List[str]):
        self.path = path
        self.module = module
        self.tree = tree
        self.src_lines = src_lines
        self.classes: Dict[str, _ClassScan] = {}
        self.functions: Dict[str, ast.AST] = {}
        self.mod_locks: Dict[str, Tuple[str, int]] = {}   # VAR -> kind, line
        self.aliases: Dict[str, str] = {}   # local name -> dotted module


def _module_name(path: str) -> str:
    """'roc_tpu_torch/fault/inject.py' -> 'roc_tpu_torch.fault.inject'; a
    package's ``__init__.py`` is the package."""
    p = path.replace(os.sep, "/")
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[:-len("/__init__")]
    return p.replace("/", ".")


def _unwrap_ifexp(value):
    """`X(...) if flag else None` assigns an X at runtime."""
    while isinstance(value, ast.IfExp):
        value = value.body if isinstance(value.body, ast.Call) \
            else value.orelse
    return value


def _witness_parts(call: ast.Call):
    """(name, inner_ctor_call) for witness.trace("...", threading.X())."""
    head = _call_head(call)
    if not head or head.split(".")[-1] != "trace":
        return None
    if len(call.args) < 2 or not isinstance(call.args[0], ast.Constant) \
            or not isinstance(call.args[0].value, str):
        return None
    inner = call.args[1]
    if isinstance(inner, ast.Call) and _call_head(inner) in _LOCK_CTORS:
        return call.args[0].value, inner
    return None


def _scan_module(path: str, src: str) -> Optional[_ModuleScan]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError:
        return None
    ms = _ModuleScan(path, _module_name(path), tree, src.splitlines())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for al in node.names:
                ms.aliases[al.asname or al.name] = \
                    f"{node.module}.{al.name}"
        elif isinstance(node, ast.Import):
            for al in node.names:
                ms.aliases[al.asname or al.name.split(".")[0]] = al.name
        elif isinstance(node, _FUNC_NODES):
            ms.functions[node.name] = node
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = _unwrap_ifexp(node.value)
            if isinstance(v, ast.Call) and _call_head(v) in _LOCK_CTORS:
                ms.mod_locks[node.targets[0].id] = (
                    _LOCK_CTORS[_call_head(v)], node.lineno)
        elif isinstance(node, ast.ClassDef):
            ms.classes[node.name] = _scan_class(node, ms)
    return ms


def _self_attr(t) -> Optional[str]:
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self":
        return t.attr
    return None


def _scan_class(node: ast.ClassDef, ms: _ModuleScan) -> _ClassScan:
    cs = _ClassScan(node.name, ms.module, ms.path, node)
    for item in node.body:
        if isinstance(item, _FUNC_NODES):
            cs.methods[item.name] = item
    for mname, meth in cs.methods.items():
        params = [a.arg for a in meth.args.args[1:]] if meth.args.args \
            else []
        locals_thread: Dict[str, dict] = {}
        for sub in ast.walk(meth):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                value = _unwrap_ifexp(getattr(sub, "value", None))
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        # `t = threading.Thread(...)` local spawn
                        if isinstance(t, ast.Name) and \
                                isinstance(value, ast.Call):
                            sp = _spawn_info(value)
                            if sp is not None:
                                sp["local"] = t.id
                                locals_thread[t.id] = sp
                                cs.spawns.append(sp)
                        continue
                    if isinstance(value, ast.Call):
                        wp = _witness_parts(value)
                        if wp is not None:
                            name, inner = wp
                            cs.locks[attr] = (
                                _LOCK_CTORS[_call_head(inner)],
                                value.lineno, name)
                            continue
                        head = _call_head(value)
                        if head in _LOCK_CTORS:
                            cs.locks[attr] = (_LOCK_CTORS[head],
                                              value.lineno, None)
                            continue
                        sp = _spawn_info(value)
                        if sp is not None:
                            sp["stored"] = attr
                            cs.spawns.append(sp)
                            continue
                        if head:
                            cs.attr_type_heads[attr] = head
                    elif isinstance(value, ast.Name):
                        if value.id in params:
                            cs.ext_candidates[attr] = (value.id, sub.lineno)
                        elif value.id in locals_thread:
                            locals_thread[value.id]["stored"] = attr
            elif isinstance(sub, ast.Call):
                h = _dotted(sub.func)
                if h and "." in h:
                    parts = h.split(".")
                    if parts[0] == "self" and len(parts) == 3:
                        if parts[2] == "join":
                            cs.joined_attrs.add(parts[1])
                        elif parts[2] == "shutdown":
                            cs.shutdown_attrs.add(parts[1])
                        elif parts[2] in ("acquire", "wait", "notify",
                                          "notify_all", "wait_for"):
                            cs.with_attrs.add(parts[1])
                    elif len(parts) == 2 and parts[1] == "join" \
                            and parts[0] in locals_thread:
                        locals_thread[parts[0]]["joined_local"] = True
            elif isinstance(sub, ast.With):
                for w in sub.items:
                    d = _dotted(w.context_expr)
                    if d and d.startswith("self.") and d.count(".") == 1:
                        cs.with_attrs.add(d.split(".")[1])
    return cs


def _spawn_info(call: ast.Call) -> Optional[dict]:
    head = _call_head(call)
    if head not in ("threading.Thread", "Thread",
                    "ThreadPoolExecutor",
                    "concurrent.futures.ThreadPoolExecutor"):
        return None
    pool = "Executor" in (head or "")
    target, daemon = "?", False
    for kw in call.keywords:
        if kw.arg == "target":
            target = _dotted(kw.value) or "?"
        elif kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            daemon = bool(kw.value.value)
    return {"target": target, "daemon": daemon, "pool": pool,
            "stored": "", "local": "", "joined_local": False,
            "line": call.lineno}


# -- phase 2: global resolution ---------------------------------------------

class _Tree:
    """Global view over every scanned module."""

    def __init__(self, modules: List[_ModuleScan]):
        self.modules = modules
        self.classes: Dict[str, _ClassScan] = {}
        dup: Set[str] = set()
        for ms in modules:
            for cname, cs in ms.classes.items():
                if cname in self.classes:
                    dup.add(cname)
                else:
                    self.classes[cname] = cs
        self.ambiguous_classes = dup
        self.mod_funcs: Dict[Tuple[str, str], ast.AST] = {}
        for ms in modules:
            for fname, fn in ms.functions.items():
                self.mod_funcs[(ms.module, fname)] = fn

        # confirm external locks (assigned from a ctor param AND used as
        # a lock) and resolve attribute object types
        for cs in self.classes.values():
            for attr, (param, line) in list(cs.ext_candidates.items()):
                if attr in cs.with_attrs and attr not in cs.locks:
                    cs.locks[attr] = ("external", line, None)
            resolved = {}
            for attr, head in cs.attr_type_heads.items():
                last = head.split(".")[-1]
                if last in self.classes and last not in dup:
                    resolved[attr] = last
            cs.attr_types = resolved

        # lock node table + union-find over ctor-passed locks
        self.nodes: Dict[Tuple[str, str], LockNode] = {}
        for cs in self.classes.values():
            for attr, (kind, line, wname) in cs.locks.items():
                self.nodes[(cs.name, attr)] = LockNode(
                    f"{cs.name}.{attr}", kind, cs.path, line, wname)
        for ms in modules:
            for var, (kind, line) in ms.mod_locks.items():
                key = (f"@{ms.module}", var)
                short = ms.module
                if short.startswith(_PKG_PREFIX):
                    short = short[len(_PKG_PREFIX):]
                self.nodes[key] = LockNode(f"{short}.{var}", kind,
                                           ms.path, line)
        self._uf: Dict[Tuple[str, str], Tuple[str, str]] = {}

        # unique lock-attr fallback: `mgr._mu` resolves when exactly one
        # class in the tree owns a lock attribute `_mu`
        attr_owner: Dict[str, List[Tuple[str, str]]] = {}
        for (owner, attr) in self.nodes:
            if not owner.startswith("@"):
                attr_owner.setdefault(attr, []).append((owner, attr))
        self.unique_attr = {a: ks[0] for a, ks in attr_owner.items()
                            if len(ks) == 1}

    # union-find ----------------------------------------------------------
    def _find(self, k):
        while k in self._uf:
            k = self._uf[k]
        return k

    def union(self, ext_key, src_key):
        a, b = self._find(ext_key), self._find(src_key)
        if a == b:
            return
        # creation sites win over external nodes as the canonical name
        if self.nodes[a].kind != "external":
            a, b = b, a
        self._uf[a] = b

    def canon(self, key) -> str:
        return self.nodes[self._find(key)].name

    def canon_kind(self, key) -> str:
        return self.nodes[self._find(key)].kind


def _bind_ctor_args(init: ast.AST, call: ast.Call) -> Dict[str, ast.AST]:
    params = [a.arg for a in init.args.args[1:]]
    bound: Dict[str, ast.AST] = {}
    for i, arg in enumerate(call.args):
        if i < len(params):
            bound[params[i]] = arg
    for kw in call.keywords:
        if kw.arg:
            bound[kw.arg] = kw.value
    return bound


def _unify_ctor_locks(tree: _Tree) -> None:
    """A lock attribute assigned from a ctor param is the SAME node as
    whatever the caller passed — walk every construction site."""
    for ms in tree.modules:
        ctxs = [(None, fn) for fn in ms.functions.values()]
        for cs in ms.classes.values():
            ctxs += [(cs, m) for m in cs.methods.values()]
        for cls, fn in ctxs:
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                head = _call_head(sub)
                if not head:
                    continue
                cname = head.split(".")[-1]
                callee = tree.classes.get(cname)
                if callee is None or cname in tree.ambiguous_classes \
                        or "__init__" not in callee.methods:
                    continue
                ext = {attr: pp for attr, (pp, _l)
                       in callee.ext_candidates.items()
                       if (cname, attr) in tree.nodes}
                if not ext:
                    continue
                bound = _bind_ctor_args(callee.methods["__init__"], sub)
                for attr, param in ext.items():
                    arg = bound.get(param)
                    if arg is None:
                        continue
                    src = _resolve_lock_key(arg, cls, tree, {})
                    if src is not None:
                        tree.union((cname, attr), src)


def _resolve_lock_key(expr, cls: Optional[_ClassScan], tree: _Tree,
                      locals_locks: Dict[str, Tuple[str, str]],
                      module: Optional[str] = None):
    d = _dotted(expr)
    if d is None:
        return None
    parts = d.split(".")
    if parts[0] == "self" and cls is not None and len(parts) == 2:
        key = (cls.name, parts[1])
        return key if key in tree.nodes else None
    if len(parts) == 1:
        if parts[0] in locals_locks:
            return locals_locks[parts[0]]
        if module is not None:
            key = (f"@{module}", parts[0])
            if key in tree.nodes:
                return key
        return None
    # foreign receiver (`mgr._mu`): unique lock-attr fallback
    return tree.unique_attr.get(parts[-1])


# -- phase 3: summaries, edges, findings ------------------------------------

class _Analyzer:
    def __init__(self, tree: _Tree):
        self.t = tree
        self.findings: List[Finding] = []
        self.waived = 0
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.src: Dict[str, List[str]] = {m.path: m.src_lines
                                          for m in tree.modules}
        self.mod_of: Dict[str, _ModuleScan] = {m.module: m
                                               for m in tree.modules}
        # function registry: key -> (node, class, module)
        self.fns: Dict[tuple, tuple] = {}
        for ms in tree.modules:
            for fname, fn in ms.functions.items():
                self.fns[("M", ms.module, fname)] = (fn, None, ms)
            for cs in ms.classes.values():
                if tree.classes.get(cs.name) is not cs:
                    continue
                for mname, m in cs.methods.items():
                    self.fns[("C", cs.name, mname)] = (m, cs, ms)
        self.acq: Dict[tuple, Set[tuple]] = {k: set() for k in self.fns}
        self.blk: Dict[tuple, Set[str]] = {k: set() for k in self.fns}
        self.calls: Dict[tuple, List[tuple]] = {k: [] for k in self.fns}
        self.call_sites: List[tuple] = []   # (caller, callee, heldset)
        self.accesses: List[tuple] = []     # (fnkey, cls, attr, store,
                                            #  line, local_held)

    # -- waiver-aware flag ------------------------------------------------
    def _flag(self, path: str, line: int, rule: str, msg: str) -> None:
        lines = self.src.get(path, [])
        for ln in (line, line - 1):
            if 1 <= ln <= len(lines):
                m = _WAIVER_RE.search(lines[ln - 1])
                if m and rule in [r.strip()
                                  for r in m.group(1).split(",")]:
                    self.waived += 1
                    return
        self.findings.append(Finding(path, line, rule, msg))

    # -- direct facts per function ---------------------------------------
    def run(self) -> None:
        for key in self.fns:
            self._walk_fn(key)
        self._fixpoint()
        self._second_pass()
        self._cycles()
        self._threads_rule()
        self._witness_rule()
        self._guarded_by_findings()

    def _walk_fn(self, key) -> None:
        node, cls, ms = self.fns[key]
        self._walk_block(key, node.body, [], cls, ms, 0, collect=True)

    def _fixpoint(self) -> None:
        changed = True
        while changed:
            changed = False
            for k in self.fns:
                for callee in self.calls[k]:
                    if callee in self.acq:
                        if not self.acq[callee] <= self.acq[k]:
                            self.acq[k] |= self.acq[callee]
                            changed = True
                        if not self.blk[callee] <= self.blk[k]:
                            self.blk[k] |= self.blk[callee]
                            changed = True

    # -- the statement walker --------------------------------------------
    def _walk_block(self, key, stmts, held, cls, ms, loops,
                    collect=False, emit=False) -> None:
        for st in stmts:
            self._walk_stmt(key, st, held, cls, ms, loops, collect, emit)

    def _walk_stmt(self, key, st, held, cls, ms, loops, collect, emit):
        t = self.t
        if isinstance(st, ast.With):
            acquired = []
            for item in st.items:
                self._exprs(key, item.context_expr, held, cls, ms, loops,
                            collect, emit)
                lk = _resolve_lock_key(item.context_expr, cls, t, {},
                                       ms.module)
                if lk is None or t.canon_kind(lk) not in _GUARDING:
                    continue
                name = t.canon(lk)
                if emit:
                    for h in held:
                        if h == name:
                            if t.canon_kind(lk) != "RLock":
                                self._flag(ms.path, st.lineno,
                                           "lock-cycle",
                                           f"{name} re-acquired while "
                                           f"already held and it is not "
                                           f"an RLock: self-deadlock")
                        else:
                            self.edges.setdefault(
                                (h, name), (ms.path, st.lineno))
                if collect:
                    self.acq[key].add(lk)
                acquired.append(name)
            self._walk_block(key, st.body, held + acquired, cls, ms,
                             loops, collect, emit)
        elif isinstance(st, (ast.If,)):
            self._exprs(key, st.test, held, cls, ms, loops, collect, emit)
            self._walk_block(key, st.body, held, cls, ms, loops,
                             collect, emit)
            self._walk_block(key, st.orelse, held, cls, ms, loops,
                             collect, emit)
        elif isinstance(st, (ast.While, ast.For)):
            # only a While with a real (non-constant) test counts as a
            # predicate loop for the condvar rule: `while True:` around
            # an if-guarded wait is exactly the seeded-mutation bug
            pred = 1 if (isinstance(st, ast.While)
                         and not (isinstance(st.test, ast.Constant)
                                  and st.test.value)) else 0
            for e in ([st.test] if isinstance(st, ast.While)
                      else [st.iter]):
                self._exprs(key, e, held, cls, ms, loops + pred, collect,
                            emit)
            self._walk_block(key, st.body, held, cls, ms, loops + pred,
                             collect, emit)
            self._walk_block(key, st.orelse, held, cls, ms, loops,
                             collect, emit)
        elif isinstance(st, ast.Try):
            self._walk_block(key, st.body, held, cls, ms, loops,
                             collect, emit)
            for h in st.handlers:
                self._walk_block(key, h.body, held, cls, ms, loops,
                                 collect, emit)
            self._walk_block(key, st.orelse, held, cls, ms, loops,
                             collect, emit)
            self._walk_block(key, st.finalbody, held, cls, ms, loops,
                             collect, emit)
        elif isinstance(st, _FUNC_NODES):
            # nested defs run where they are *invoked* (fault.retrying,
            # pool.submit); inlining at the definition approximates that
            # for acquire/blocking summaries without a closure analysis
            self._walk_block(key, st.body, held, cls, ms, loops,
                             collect, emit)
        else:
            for e in ast.iter_child_nodes(st):
                self._exprs(key, e, held, cls, ms, loops, collect, emit)

    def _exprs(self, key, expr, held, cls, ms, loops, collect, emit):
        if expr is None:
            return
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                self._call(key, sub, held, cls, ms, loops, collect, emit)
            elif isinstance(sub, ast.Attribute) and collect:
                self._attr_access(key, sub, held, cls)

    def _attr_access(self, key, node: ast.Attribute, held, cls):
        if cls is None:
            return
        if not (isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return
        if (cls.name, node.attr) in self.t.nodes:
            return   # the locks themselves are not guarded data
        store = isinstance(node.ctx, (ast.Store, ast.AugStore)) \
            if hasattr(ast, "AugStore") else isinstance(node.ctx, ast.Store)
        self.accesses.append((key, cls.name, node.attr, store,
                              node.lineno, frozenset(held)))
        # AugAssign target parses as Store-only; count the implied load
        if store:
            self.accesses.append((key, cls.name, node.attr, False,
                                  node.lineno, frozenset(held)))

    def _call(self, key, call: ast.Call, held, cls, ms, loops, collect,
              emit):
        t = self.t
        head = _call_head(call)
        if head is None:
            return
        parts = head.split(".")
        label = _BLOCKING_HEADS.get(head)
        if label is None and len(parts) >= 2 \
                and parts[-1] in _BLOCKING_ATTRS \
                and head not in _NONBLOCKING_HEADS:
            label = _BLOCKING_ATTRS[parts[-1]]
        if label is None and len(parts) >= 2 and parts[-1] == "wait":
            # Condition.wait on the condvar you hold is the sanctioned
            # sleep (it releases that lock); anything else blocks.
            recv = call.func.value if isinstance(call.func,
                                                 ast.Attribute) else None
            lk = _resolve_lock_key(recv, cls, t, {}, ms.module) \
                if recv is not None else None
            if lk is not None and t.canon_kind(lk) == "Condition" \
                    and t.canon(lk) in held:
                if emit and loops == 0:
                    self._flag(ms.path, call.lineno, "condvar-wait",
                               f"{t.canon(lk)}.wait() outside a "
                               f"predicate loop: a stolen or spurious "
                               f"wakeup drops the wait silently — wrap "
                               f"in `while not <predicate>:`")
                others = [h for h in held if h != t.canon(lk)]
                if emit and others:
                    self._flag(ms.path, call.lineno, "lock-blocking",
                               f"{', '.join(sorted(set(others)))} held "
                               f"across {t.canon(lk)}.wait() — the wait "
                               f"releases only its own condvar")
                return
            label = ".wait"
        if label is not None:
            if collect:
                self.blk[key].add(label)
            if emit and held:
                self._flag(ms.path, call.lineno, "lock-blocking",
                           f"{', '.join(sorted(set(held)))} held across "
                           f"blocking/chaos-injectable call {label}"
                           f" ({head})")
            return
        callee = self._resolve_callee(parts, cls, ms)
        if callee is None:
            return
        if collect:
            self.calls[key].append(callee)
        if emit:
            self.call_sites.append((key, callee, frozenset(held)))
            if held:
                inner = {t.canon(k) for k in self.acq.get(callee, ())}
                for h in held:
                    for name in inner:
                        if name != h:
                            self.edges.setdefault(
                                (h, name), (ms.path, call.lineno))
                labels = self.blk.get(callee, ())
                if labels:
                    self._flag(
                        ms.path, call.lineno, "lock-blocking",
                        f"{', '.join(sorted(set(held)))} held across "
                        f"{head}(), which reaches blocking/"
                        f"chaos-injectable call(s): "
                        f"{', '.join(sorted(labels))}")

    def _resolve_callee(self, parts, cls, ms):
        t = self.t
        last = parts[-1]
        if len(parts) == 1:
            if last in t.classes and last not in t.ambiguous_classes \
                    and ("C", last, "__init__") in self.fns:
                return ("C", last, "__init__")
            if ("M", ms.module, last) in self.fns:
                return ("M", ms.module, last)
            return None
        if parts[0] == "self" and cls is not None:
            if len(parts) == 2 and ("C", cls.name, last) in self.fns:
                return ("C", cls.name, last)
            if len(parts) == 3:
                owner = getattr(cls, "attr_types", {}).get(parts[1])
                if owner and ("C", owner, last) in self.fns:
                    return ("C", owner, last)
            return None
        if len(parts) == 2:
            target = ms.aliases.get(parts[0])
            if target:
                # "from roc_tpu_torch.train import checkpoint as _ckpt"
                # -> _ckpt.save_arrays -> roc_tpu_torch.train.checkpoint
                for mod in (target, target.rsplit(".", 1)[0]):
                    if ("M", mod, last) in self.fns:
                        return ("M", mod, last)
            if parts[0] in t.classes \
                    and parts[0] not in t.ambiguous_classes \
                    and ("C", parts[0], last) in self.fns:
                return ("C", parts[0], last)
        return None

    def _second_pass(self) -> None:
        for key in self.fns:
            node, cls, ms = self.fns[key]
            self._walk_block(key, node.body, [], cls, ms, 0, emit=True)

    # -- rule: lock-order cycles ------------------------------------------
    def _cycles(self) -> None:
        adj: Dict[str, List[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        color: Dict[str, int] = {}
        stack: List[str] = []

        def dfs(u):
            color[u] = 1
            stack.append(u)
            for v in sorted(adj.get(u, [])):
                if color.get(v, 0) == 0:
                    cyc = dfs(v)
                    if cyc:
                        return cyc
                elif color.get(v) == 1:
                    return stack[stack.index(v):] + [v]
            stack.pop()
            color[u] = 2
            return None

        for u in sorted(adj):
            if color.get(u, 0) == 0:
                cyc = dfs(u)
                if cyc:
                    path, line = self.edges.get(
                        (cyc[0], cyc[1]), ("<graph>", 1))
                    self._flag(path, line, "lock-cycle",
                               f"lock-order cycle (potential deadlock): "
                               f"{' -> '.join(cyc)}")
                    return

    # -- rule: spawned threads must be joinable ---------------------------
    def _threads_rule(self) -> None:
        for cs in self.t.classes.values():
            for sp in cs.spawns:
                joined = bool(sp["joined_local"])
                if sp["stored"]:
                    joined = joined or (
                        sp["stored"] in cs.shutdown_attrs if sp["pool"]
                        else sp["stored"] in cs.joined_attrs)
                if not joined:
                    what = "ThreadPoolExecutor" if sp["pool"] else \
                        f"thread (target={sp['target']}, " \
                        f"daemon={sp['daemon']})"
                    self._flag(cs.path, sp["line"], "thread-join",
                               f"{cs.name} spawns a {what} that no "
                               f".join()/.shutdown() in the class ever "
                               f"reaches — unreachable from close()")

    # -- rule: witness names must match their attribute -------------------
    def _witness_rule(self) -> None:
        for cs in self.t.classes.values():
            for attr, (kind, line, wname) in cs.locks.items():
                if wname is not None and wname != f"{cs.name}.{attr}":
                    self._flag(cs.path, line, "witness-name",
                               f"witness.trace name {wname!r} disagrees "
                               f"with its attribute "
                               f"{cs.name}.{attr} — the runtime witness "
                               f"would validate against the wrong node")

    # -- guarded-by inference ---------------------------------------------
    def _entry_held(self) -> Dict[tuple, Optional[frozenset]]:
        entry: Dict[tuple, Optional[frozenset]] = {}
        thread_targets = set()
        for cs in self.t.classes.values():
            for sp in cs.spawns:
                tgt = sp["target"]
                if tgt.startswith("self."):
                    thread_targets.add(("C", cs.name, tgt.split(".")[1]))
        for key in self.fns:
            kind, owner, name = key
            public = not name.startswith("_") or name == "__init__"
            if kind == "M" or public or key in thread_targets:
                entry[key] = frozenset()
            else:
                entry[key] = None   # unknown: no observed entry yet
        sites: Dict[tuple, List[tuple]] = {}
        for caller, callee, held in self.call_sites:
            sites.setdefault(callee, []).append((caller, held))
        changed = True
        while changed:
            changed = False
            for callee, lst in sites.items():
                cur = entry.get(callee)
                if cur == frozenset():
                    continue   # pinned entry point / already bottom
                acc = None
                for caller, held in lst:
                    ch = entry.get(caller)
                    if ch is None:
                        continue
                    eff = ch | held
                    acc = eff if acc is None else (acc & eff)
                if acc is None:
                    continue
                new = acc if cur is None else (cur & acc)
                if new != cur:
                    entry[callee] = new
                    changed = True
        return entry

    def _init_reachable(self) -> Set[tuple]:
        out: Set[tuple] = set()
        adj: Dict[tuple, Set[tuple]] = {}
        for caller, callee, _h in self.call_sites:
            adj.setdefault(caller, set()).add(callee)
        for cs in self.t.classes.values():
            key = ("C", cs.name, "__init__")
            if key not in self.fns:
                continue
            stack = [key]
            while stack:
                k = stack.pop()
                if k in out:
                    continue
                out.add(k)
                stack.extend(adj.get(k, ()))
        return out

    def compute_guarded(self) -> Dict[str, str]:
        self._entry = self._entry_held()
        self._exempt = self._init_reachable()
        # classes that own a guarding lock are in scope
        in_scope = {cs.name for cs in self.t.classes.values()
                    if any(k in _GUARDING
                           for k, _l, _w in cs.locks.values())}
        per_attr: Dict[Tuple[str, str], dict] = {}
        for key, cname, attr, store, line, local_held in self.accesses:
            if cname not in in_scope:
                continue
            e = self._entry.get(key)
            if e is None:
                continue   # never-called private method: no context
            held = {h for h in local_held} | set(e)
            rec = per_attr.setdefault((cname, attr), {
                "under": {}, "stores_under": {}, "bare_stores": []})
            if held:
                for h in held:
                    rec["under"][h] = rec["under"].get(h, 0) + 1
                    if store:
                        rec["stores_under"][h] = \
                            rec["stores_under"].get(h, 0) + 1
            elif store:
                mname = key[2]
                rec["bare_stores"].append((key, mname, line))
        guarded: Dict[str, str] = {}
        self._guard_viol: List[tuple] = []
        for (cname, attr), rec in sorted(per_attr.items()):
            if not rec["under"]:
                continue
            under = rec["under"]
            lock = sorted(under, key=lambda h, _u=under: (-_u[h], h))[0]
            # "consistently accessed under L": at least 3 accesses under
            # it, and bare *stores* outside construction stay a strict
            # minority (they are the bug, not the convention).  Stores
            # under the lock are not required — a deque filled and
            # drained under a condvar is guarded data even though its
            # binding never changes after __init__.
            bad = [b for b in rec["bare_stores"]
                   if b[0] not in self._exempt and b[1] != "__init__"]
            if under[lock] < 3 or len(bad) >= under[lock]:
                continue
            guarded[f"{cname}.{attr}"] = lock
            for fkey, mname, line in bad:
                cs = self.t.classes[cname]
                self._guard_viol.append(
                    (cs.path, line, cname, attr, lock, mname))
        return guarded

    def _guarded_by_findings(self) -> None:
        self.guarded = self.compute_guarded()
        for path, line, cname, attr, lock, mname in self._guard_viol:
            self._flag(path, line, "unguarded-attr",
                       f"{cname}.{attr} is guarded by {lock} "
                       f"(>=3 accesses incl. stores) but {mname}() "
                       f"stores it with no lock held — a thread-"
                       f"reachable unguarded write")


# -- public API --------------------------------------------------------------

def analyze_paths(paths=("roc_tpu_torch",)) -> Report:
    modules = []
    for path in iter_py(paths):
        with open(path, encoding="utf-8") as f:
            ms = _scan_module(path, f.read())
        if ms is not None:
            modules.append(ms)
    return _analyze(modules)


def analyze_source(src: str, path: str = "fixture.py") -> Report:
    ms = _scan_module(path, src)
    return _analyze([ms] if ms is not None else [])


def _analyze(modules) -> Report:
    tree = _Tree(modules)
    _unify_ctor_locks(tree)
    an = _Analyzer(tree)
    an.run()
    # canonical lock table: external nodes fold into their creation site
    locks, seen = [], set()
    for key in sorted(tree.nodes, key=lambda k: tree.nodes[k].name):
        canon = tree.canon(key)
        if canon in seen:
            continue
        seen.add(canon)
        root = tree.nodes[tree._find(key)]
        locks.append(root)
    threads = []
    for cs in sorted(tree.classes.values(), key=lambda c: c.name):
        for sp in sorted(cs.spawns, key=lambda s: s["line"]):
            target = sp["target"]
            if target.startswith("self."):
                target = f"{cs.name}.{target[5:]}"
            stored = f"{cs.name}.{sp['stored']}" if sp["stored"] else \
                ("<local>" if sp["local"] else "")
            joined = bool(sp["joined_local"]) or (
                sp["stored"] in (cs.shutdown_attrs if sp["pool"]
                                 else cs.joined_attrs))
            threads.append(ThreadSpawn(target, sp["daemon"], stored,
                                       joined, sp["pool"], cs.path,
                                       sp["line"]))
    edges = dict(an.edges)
    for a, b, _reason in DECLARED_EDGES:
        edges.setdefault((a, b), ("<declared>", 0))
    findings = sorted(an.findings, key=lambda f: (f.path, f.line, f.rule))
    return Report(locks=locks, threads=threads, edges=edges,
                  guarded_by=an.guarded, findings=findings,
                  waived=an.waived)


def report_dict(report: Report) -> dict:
    """Deterministic baseline payload.  Line numbers are deliberately
    excluded: the baseline pins the *discipline* (nodes, edges, facts),
    not the layout — unrelated edits must not churn it."""
    return {
        "locks": [{"name": lk.name, "kind": lk.kind, "path": lk.path,
                   "witness": lk.witness_name}
                  for lk in sorted(report.locks, key=lambda l: l.name)],
        "threads": [{"target": th.target, "daemon": th.daemon,
                     "stored": th.stored, "joined": th.joined,
                     "pool": th.pool, "path": th.path}
                    for th in sorted(report.threads,
                                     key=lambda t: (t.path, t.target))],
        "edges": sorted([a, b] for a, b in report.edges),
        "declared_edges": [[a, b, r] for a, b, r in DECLARED_EDGES],
        "guarded_by": {k: report.guarded_by[k]
                       for k in sorted(report.guarded_by)},
    }


def load_baseline(path: str = BASELINE_PATH) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def save_baseline(report: Report, path: str = BASELINE_PATH) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report_dict(report), f, indent=1, sort_keys=True)
        f.write("\n")


def diff_baseline(report: Report, path: str = BASELINE_PATH) -> List[str]:
    """Exact-diff the live report against the committed baseline: any
    drift is a violation until regenerated deliberately with --update."""
    if not os.path.exists(path):
        return [f"no committed baseline at {path}: run python -m "
                f"roc_tpu_torch.analysis.threads --update"]
    want = load_baseline(path)
    got = report_dict(report)
    out = []
    for section in sorted(set(want) | set(got)):
        if want.get(section) != got.get(section):
            w = json.dumps(want.get(section), sort_keys=True)
            g = json.dumps(got.get(section), sort_keys=True)
            out.append(f"threads.json drift in {section!r}:\n"
                       f"  committed: {w}\n  current:   {g}")
    return out


# -- selftest: the seeded-mutation fixture matrix ---------------------------

_FIX_CLEAN = '''
import threading

class Worker:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()
        self.cv = threading.Condition()
        self.items = []
        self.done = False
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            with self.cv:
                while not self.items and not self.done:
                    self.cv.wait(timeout=0.1)
                if self.done:
                    return
                self.items.pop()

    def push(self, x):
        with self.cv:
            self.items.append(x)
            self.done = False
            self.cv.notify()

    def transfer(self):
        with self.a:
            with self.b:
                pass

    def close(self):
        with self.cv:
            self.done = True
            self.cv.notify_all()
        self._t.join()
'''

_MUT_INVERSION = _FIX_CLEAN + '''
    def transfer_back(self):
        with self.b:
            with self.a:
                pass
'''

_MUT_UNGUARDED = _FIX_CLEAN + '''
    def poison(self):
        self.done = True
'''

_MUT_WAITLESS = _FIX_CLEAN.replace(
    """                while not self.items and not self.done:
                    self.cv.wait(timeout=0.1)""",
    """                if not self.items:
                    self.cv.wait(timeout=0.1)""")

_MUT_UNJOINED = _FIX_CLEAN.replace("        self._t.join()\n", "")

_MUT_BLOCKING = _FIX_CLEAN + '''
    def flush(self):
        import os
        with self.a:
            os.fsync(0)
'''

_MUT_WITNESS_NAME = _FIX_CLEAN.replace(
    "self.a = threading.Lock()",
    'self.a = witness.trace("Other.z", threading.Lock())')


def selftest(verbose: bool = True) -> int:
    """Seeded-mutation matrix + witness mechanics; 0 on success."""
    failures = []

    def check(label, cond):
        if verbose:
            print(f"#   threads selftest: {label}: "
                  f"{'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(label)

    clean = analyze_source(_FIX_CLEAN)
    check("clean fixture has zero findings", not clean.findings)
    check("clean fixture derives the a->b edge",
          ("Worker.a", "Worker.b") in clean.edges)
    check("clean fixture infers items guarded-by cv",
          clean.guarded_by.get("Worker.items") == "Worker.cv")
    check("clean fixture infers done guarded-by cv",
          clean.guarded_by.get("Worker.done") == "Worker.cv")

    def rules(rep):
        return {f.rule for f in rep.findings}

    check("seeded lock inversion is caught (lock-cycle)",
          "lock-cycle" in rules(analyze_source(_MUT_INVERSION)))
    check("seeded dropped guard is caught (unguarded-attr)",
          "unguarded-attr" in rules(analyze_source(_MUT_UNGUARDED)))
    check("seeded waitless condvar wait is caught (condvar-wait)",
          "condvar-wait" in rules(analyze_source(_MUT_WAITLESS)))
    check("seeded unjoined thread is caught (thread-join)",
          "thread-join" in rules(analyze_source(_MUT_UNJOINED)))
    check("seeded lock-held-across-fsync is caught (lock-blocking)",
          "lock-blocking" in rules(analyze_source(_MUT_BLOCKING)))
    check("witness name mismatch is caught (witness-name)",
          "witness-name" in rules(analyze_source(_MUT_WITNESS_NAME)))

    # witness mechanics: armed proxies record pairs, the validator
    # checks them against a graph, disarmed trace is a passthrough
    import threading as _th

    from roc_tpu_torch.analysis import witness as w
    was = w.armed()
    try:
        w.arm(False)
        raw = _th.Lock()
        check("disarmed trace returns the primitive untouched",
              w.trace("X.a", raw) is raw)
        w.reset()
        with w.trace("X.a", _th.Lock()):
            pass
        check("disarmed witness records zero pairs", w.records() == 0)

        w.arm(True)
        w.reset()
        la = w.trace("X.a", _th.Lock())
        lb = w.trace("X.b", _th.Lock())
        with la:
            with lb:
                pass
        check("armed witness records the (a, b) pair",
              w.observed_pairs().get(("X.a", "X.b"), 0) >= 1)
        check("validator accepts an in-graph order",
              w.validate(edges=[("X.a", "X.b")]) == [])
        check("validator flags an off-graph order",
              len(w.validate(edges=[("X.b", "X.a")])) == 1)
        check("validator accepts a transitively sanctioned order",
              w.validate(edges=[("X.a", "X.c"), ("X.c", "X.b")]) == [])
        w.reset()
    finally:
        w.arm(was)

    if verbose:
        n = len(failures)
        print(f"# threads selftest: {n} failure(s)")
    return 1 if failures else 0


def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m roc_tpu_torch.analysis.threads",
        description="whole-tree lock-discipline analyzer (roc-threads)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded-mutation fixture matrix")
    ap.add_argument("--update", action="store_true",
                    help="regenerate threads.json from the current tree")
    ap.add_argument("paths", nargs="*", default=None)
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    rep = analyze_paths(args.paths or ("roc_tpu_torch",))
    if args.update:
        save_baseline(rep)
        print(f"# threads: wrote {BASELINE_PATH}")
        return 0
    for f in rep.findings:
        print(f)
    for line in diff_baseline(rep):
        print(line)
    bad = bool(rep.findings) or bool(diff_baseline(rep))
    print(f"# threads: {len(rep.findings)} finding(s), "
          f"{len(rep.edges)} edge(s), {len(rep.guarded_by)} guarded-by "
          f"fact(s), {rep.waived} waived")
    return 3 if bad else 0


if __name__ == "__main__":
    raise SystemExit(_main())
