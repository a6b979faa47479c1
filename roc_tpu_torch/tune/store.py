"""The tuned store: the content-keyed launch choices
(roc_tpu/tune/store.py retargeted).

One JSON document maps *graph content* (shape and an edge-list digest,
roc_tpu's key: ``graph_key``) to the sweep's winning launches per
*variant* and kernel.  ``ops.DeviceCsr.from_csr`` takes its
``LaunchTable`` from here when a CSR is placed (``launch_table``;
``train/graph_data.py:dense_graph_data``), never per launch.

Variants keep roc_tpu's four names: ``fp32`` is the port's exact, ``bf16``
its fast (the staged bf16 plane), ``+fuse`` a ``-megafuse`` run (whose
megakernel gather keeps its launch: ``tune/lattice.py``).

Location: ``ROC_NO_TUNED=1`` turns the store off (nothing is read or
written), ``ROC_TUNED_PATH`` names it, and otherwise it lies in roc_tpu's
plan-cache directory, resolved as roc_tpu resolves it (``ROC_PLAN_CACHE=0``
turns it off, ``ROC_PLAN_CACHE_DIR`` overrides), as ``tuned_cuda.json``:
roc_tpu's own is ``tuned.json`` there.  A document in roc_tpu's schema (a
Geometry ``geom`` a variant) is never read, merged over or overwritten
here, so a shared ``ROC_TUNED_PATH`` cannot lose either package's
entries; roc_tpu's ``load_store`` refuses the port's (no ``geom``).

Schema (``validate_store`` is the single source of truth)::

  {"version": 1, "package": "roc_tpu_torch",
   "interpret": <bool: true for the CI surrogate, not the card's times>,
   "seed": <int>,
   "entries": {
     "<graph key: edges=..|rows=..|sha=..|table_rows=..>": {
       "<variant: fp32|bf16[+fuse]>": {
         "<kernel key: sum/<H> | gat/<K>x<F>>": {
           "launch": [<lanes a row, edges in flight> | <lanes, packs>],
           "label": <the candidate's label>,
           "modeled_s": <screen seconds>, "trial_s": <confirmed seconds>,
           "default_s": <the default rule, measured the same way>,
           "source": "surrogate" | "device"}}}}}

Entries apply on any device: they choose a launch, not a rate, and no
launch changes a bit.  A launch the library does not build fails the
schema, so a hand-edited store cannot reach the kernel with it.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import warnings

import numpy as np

from roc_tpu_torch.obs.ledger import content_key
from roc_tpu_torch.ops.aggregate import LaunchTable
from roc_tpu_torch.tune.lattice import LaunchConfig

VERSION = 1
PACKAGE = "roc_tpu_torch"
FILE_NAME = "tuned_cuda.json"
_VARIANTS = ("fp32", "bf16", "fp32+fuse", "bf16+fuse")
_SUM_KEY = re.compile(r"^sum/[1-9][0-9]*$")
_GAT_KEY = re.compile(r"^gat/[1-9][0-9]*x[1-9][0-9]*$")

# Parsed-store cache: path -> ((mtime_ns, size), doc or None).
_CACHE: dict = {}
# Warn-once registry, keyed by (path, finding).
_WARNED: set = set()


def plan_cache_dir() -> str:
    """roc_tpu's plan-cache directory (binned.py:1273-1281); '' disables."""
    if os.environ.get("ROC_PLAN_CACHE", "1") == "0":
        return ""
    return os.environ.get(
        "ROC_PLAN_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     f"roc_plans_u{os.getuid()}"))


def tuned_store_path() -> str:
    """The store's path; '' disables it.  ROC_NO_TUNED=1 turns it off,
    ROC_TUNED_PATH names it, else ``tuned_cuda.json`` in the plan-cache
    directory."""
    if os.environ.get("ROC_NO_TUNED"):
        return ""
    p = os.environ.get("ROC_TUNED_PATH")
    if p:
        return p
    base = plan_cache_dir()
    return os.path.join(base, FILE_NAME) if base else ""


def graph_key(edge_src, edge_dst, num_rows: int, table_rows: int) -> str:
    """Content key for one graph direction, roc_tpu's (store.py:84-94):
    the shape and a sha1 digest over the int64 edge bytes."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(edge_src, np.int64).tobytes())
    h.update(np.ascontiguousarray(edge_dst, np.int64).tobytes())
    return content_key(rows=int(num_rows), table_rows=int(table_rows),
                       edges=int(len(edge_src)), sha=h.hexdigest()[:16])


def variant_key(storage_dtype: str = "fp32",
                fuse_linear: bool = False) -> str:
    """roc_tpu's variant names: fp32 (exact) or bf16 (fast), +fuse under
    -megafuse."""
    return storage_dtype + ("+fuse" if fuse_linear else "")


def storage_of(precision: str) -> str:
    """A precision's variant stem: fast sums the bf16 plane."""
    return {"fast": "bf16", "exact": "fp32"}[precision]


def precision_of(storage_dtype: str) -> str:
    return {"bf16": "fast", "fp32": "exact"}[storage_dtype]


def roc_tpu_document(doc) -> bool:
    """True for a document in roc_tpu's schema: a variant entry holding a
    Geometry ``geom`` and its ``knobs``."""
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"), dict):
        return False
    return any(isinstance(variants, dict) and any(
        isinstance(e, dict) and "geom" in e and "knobs" in e
        for e in variants.values())
        for variants in doc["entries"].values())


def _launch_problem(kkey: str, vkey: str, launch) -> str:
    if (not isinstance(launch, list) or len(launch) != 2
            or not all(isinstance(v, int) and not isinstance(v, bool)
                       for v in launch)):
        return "launch must be 2 ints"
    if _SUM_KEY.match(kkey):
        cfg = LaunchConfig("sum", (int(kkey[4:]),), "fast", tuple(launch))
    elif _GAT_KEY.match(kkey):
        k, f = kkey[4:].split("x")
        cfg = LaunchConfig("gat", (int(k), int(f)), "fast", tuple(launch))
    else:
        return "unknown kernel key"
    if vkey in _VARIANTS:
        cfg = cfg._replace(precision=precision_of(vkey.split("+")[0]))
    if not cfg.built():
        return f"launch {launch} is not built ({cfg.label})"
    return ""


def validate_store(doc) -> list:
    """Schema problems in a tuned-store document (empty list = valid)."""
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if roc_tpu_document(doc):
        return ["roc_tpu's tuned store (Geometry entries), not the port's"]
    problems = []
    if doc.get("version") != VERSION:
        problems.append(f"version {doc.get('version')!r} != {VERSION}")
    if doc.get("package") != PACKAGE:
        problems.append(f"package {doc.get('package')!r} != {PACKAGE!r}")
    if not isinstance(doc.get("interpret"), bool):
        problems.append("missing/non-bool 'interpret'")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        return problems + ["missing/non-object 'entries'"]
    for gkey, variants in entries.items():
        if not isinstance(variants, dict):
            problems.append(f"{gkey}: variants not an object")
            continue
        for vkey, kernels in variants.items():
            if vkey not in _VARIANTS:
                problems.append(f"{gkey}[{vkey}]: unknown variant")
            if not isinstance(kernels, dict):
                problems.append(f"{gkey}[{vkey}]: kernels not an object")
                continue
            for kkey, e in kernels.items():
                where = f"{gkey}[{vkey}][{kkey}]"
                if not isinstance(e, dict):
                    problems.append(f"{where}: entry not an object")
                    continue
                bad = _launch_problem(kkey, vkey, e.get("launch"))
                if bad:
                    problems.append(f"{where}: {bad}")
                for f in ("modeled_s", "trial_s", "default_s"):
                    v = e.get(f)
                    if not isinstance(v, (int, float)) or isinstance(v, bool):
                        problems.append(f"{where}: non-numeric {f}")
                if not isinstance(e.get("label"), str):
                    problems.append(f"{where}: missing label")
                if e.get("source") not in ("surrogate", "device"):
                    problems.append(f"{where}: bad source")
    return problems


def _warn_once(key, msg: str) -> None:
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(msg, stacklevel=3)


def _read(path: str):
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_store(path: str = ""):
    """The parsed, validated store, or None (no file, invalid, roc_tpu's,
    or the store turned off).  Cached per (path, mtime, size); an invalid
    document warns once and reads as absent: the kernels' own rule stays,
    and a run never stops over a tuning artifact."""
    path = path or tuned_store_path()
    if not path:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    ck = (st.st_mtime_ns, st.st_size)
    hit = _CACHE.get(path)
    if hit is not None and hit[0] == ck:
        return hit[1]
    doc = _read(path)
    if doc is not None:
        problems = validate_store(doc)
        if problems:
            _warn_once((path, "schema"),
                       f"tuned store {path}: {problems[0]}; ignoring it "
                       f"(the kernels keep their own launch rule)")
            doc = None
    _CACHE[path] = (ck, doc)
    return doc


def _refuse_roc_tpu(path: str) -> None:
    if os.path.exists(path) and roc_tpu_document(_read(path)):
        raise ValueError(
            f"tuned store {path} holds roc_tpu's tuned Geometry entries "
            f"(roc_tpu/tune/store.py); refusing to merge over or overwrite "
            f"it: point ROC_TUNED_PATH elsewhere")


def save_store(path: str, doc: dict) -> None:
    """Deterministic, durable atomic write (sorted keys, fixed separators,
    tmp + fsync + rename), refused for an invalid document or over
    roc_tpu's store."""
    from roc_tpu_torch.fault.durable import fsync_replace
    problems = validate_store(doc)
    if problems:
        raise ValueError(f"refusing to write invalid tuned store: "
                         f"{problems[:3]}")
    _refuse_roc_tpu(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    fsync_replace(tmp, path)
    _CACHE.pop(path, None)


def merge_entries(path: str, entries: dict, interpret: bool,
                  seed: int) -> dict:
    """Fold a sweep's winners into the store at ``path`` (created if
    absent) and write it back: per (graph, variant, kernel) the newest
    sweep wins, other entries survive.  Refuses roc_tpu's store."""
    _refuse_roc_tpu(path)
    doc = load_store(path) or {"version": VERSION, "package": PACKAGE,
                               "interpret": interpret, "seed": seed,
                               "entries": {}}
    doc = json.loads(json.dumps(doc))      # the cached parse stays intact
    doc["interpret"] = bool(interpret)
    doc["seed"] = int(seed)
    for gkey, variants in entries.items():
        for vkey, kernels in variants.items():
            doc["entries"].setdefault(gkey, {}).setdefault(
                vkey, {}).update(kernels)
    save_store(path, doc)
    return doc


def lookup(edge_src, edge_dst, num_rows: int, table_rows: int,
           storage_dtype: str = "bf16", fuse_linear: bool = False,
           path: str = "", key: str = ""):
    """This graph direction's {kernel key: entry} for the variant, or None.
    EXACT variant only: a ``+fuse`` run never takes the unfused winners.
    ``key`` is the direction's ``graph_key`` when the caller has it."""
    doc = load_store(path)
    if doc is None:
        return None
    variants = doc["entries"].get(
        key or graph_key(edge_src, edge_dst, num_rows, table_rows))
    if not variants:
        return None
    return variants.get(variant_key(storage_dtype, fuse_linear)) or None


def launch_table(edge_src, edge_dst, num_rows: int, table_rows: int,
                 storage_dtype: str = "bf16", fuse_linear: bool = False,
                 path: str = ""):
    """The ``ops.aggregate.LaunchTable`` of a graph (its edge list, in
    roc_tpu's roles) from the store: the forward direction's entries and
    the transpose's (roles swapped), or None when the store holds
    neither."""
    if load_store(path) is None:
        return None
    fwd = lookup(edge_src, edge_dst, num_rows, table_rows, storage_dtype,
                 fuse_linear, path) or {}
    bwd = lookup(edge_dst, edge_src, table_rows, num_rows, storage_dtype,
                 fuse_linear, path) or {}
    if not fwd and not bwd:
        return None
    pairs = [{k: tuple(e["launch"]) for k, e in d.items()}
             for d in (fwd, bwd)]
    return LaunchTable(precision_of(storage_dtype), *pairs)


def clear_cache() -> None:
    """Drop the parsed-store cache and the warn-once registry (tests)."""
    _CACHE.clear()
    _WARNED.clear()
