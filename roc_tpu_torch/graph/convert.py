"""Converters from standard dataset dumps to the ROC on-disk format
(roc_tpu/graph/convert.py).

The reference consumes preprocessed ``<prefix>.add_self_edge.lux`` + sidecar
files (gnn.cc:755, load_task.cu:25-184) but ships no converter.  This module
converts the three dump layouts one meets:

  * **edge list**: ``src dst`` per line (whitespace or comma separated,
    ``#`` comments), plus optional feature CSV / label / mask sidecars in
    any combination; missing pieces are synthesized (identity features,
    a seeded stratified split).
  * **OGB-style directory**: ``edge.csv`` (src,dst per line), optional
    ``node-feat.csv`` / ``node-label.csv`` and a ``split/`` directory with
    ``train.csv``/``valid.csv``/``test.csv`` index files.
  * **Matrix Market** coordinate files (SuiteSparse dumps).

and builds the vendored real graphs of ``data/`` (karate, davis, lesmis),
whose golden curves docs/GOLDEN.md pins.  Everything returns a
:class:`roc_tpu_torch.graph.datasets.Dataset` equal, field by field, to
roc_tpu's; ``write`` puts it on disk in the reference layout, byte-equal to
roc_tpu's, so ``python -m roc_tpu_torch -file <prefix>`` trains from it.
"""

from __future__ import annotations

import os

import numpy as np

from roc_tpu_torch.graph import lux
from roc_tpu_torch.graph.csr import add_self_edges, from_edges
from roc_tpu_torch.graph.datasets import Dataset

_VENDOR_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data")


def read_mtx(path: str) -> "tuple[int, np.ndarray, np.ndarray, bool]":
    """Parse a Matrix Market coordinate file (the SuiteSparse / common
    public graph dump format): returns (num_nodes, src, dst, symmetric).
    1-indexed entries become 0-indexed; `symmetric` headers mean the file
    stores one triangle (caller symmetrizes via undirected=True).  Banner
    qualifiers are case-insensitive per the MM spec."""
    with open(path) as f:
        header = f.readline().lower()
        if not header.startswith("%%matrixmarket matrix coordinate"):
            raise ValueError(f"{path}: not a MatrixMarket coordinate file "
                             f"(header {header[:50]!r})")
        symmetric = "symmetric" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, nnz = (int(v) for v in line.split()[:3])
        n = max(rows, cols)
        data = np.loadtxt(f, ndmin=2)
    count = 0 if data.size == 0 else data.shape[0]
    if count != nnz:
        # a truncated download parses "cleanly" otherwise — silent data loss
        raise ValueError(f"{path}: header declares {nnz} entries, file has "
                         f"{count} (truncated?)")
    if count == 0:
        return n, np.zeros(0, np.int64), np.zeros(0, np.int64), symmetric
    src = data[:, 0].astype(np.int64) - 1
    dst = data[:, 1].astype(np.int64) - 1
    return n, src, dst, symmetric


def from_mtx(path: str, *, labels_path: "str | None" = None,
             feats_path: "str | None" = None, self_edges: bool = True,
             undirected: "bool | None" = None,
             split: "tuple[int, int, int] | None" = None,
             seed: int = 0, name: str = "") -> Dataset:
    """Convert a Matrix Market graph.  ``undirected`` None follows the
    banner (symmetric headers symmetrize); pass True to symmetrize a
    'general'-header dump of an effectively-undirected graph."""
    n, src, dst, symmetric = read_mtx(path)
    feats, labels = _load_sidecars(feats_path, labels_path)
    return _finish(name or os.path.basename(path), n, src, dst, feats,
                   labels, None,
                   undirected=symmetric if undirected is None else undirected,
                   self_edges=self_edges, split=split, seed=seed)


def _load_sidecars(feats_path, labels_path):
    """The one place that knows the sidecar text formats (feature CSV,
    one-int-per-line labels) — shared by every converter front end."""
    feats = np.loadtxt(feats_path, delimiter=",", dtype=np.float32,
                       ndmin=2) if feats_path else None
    labels = np.loadtxt(labels_path, dtype=np.int64).reshape(-1) \
        if labels_path else None
    return feats, labels


def read_edge_file(path: str) -> "tuple[np.ndarray, np.ndarray]":
    """Parse an edge-list text file: one ``src dst`` pair per line,
    whitespace- or comma-separated, ``#``-to-EOL comments, blank lines ok."""
    srcs, dsts = [], []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 2:
                raise ValueError(f"{path}:{ln}: need 'src dst', got {line!r}")
            srcs.append(int(parts[0]))
            dsts.append(int(parts[1]))
    return (np.asarray(srcs, dtype=np.int64),
            np.asarray(dsts, dtype=np.int64))


def stratified_split(label_ids: np.ndarray, n_train: int, n_val: int,
                     n_test: int, seed: int = 0) -> np.ndarray:
    """Seeded split mask with the train set stratified by class (the
    citation-benchmark convention: every class is represented in train).

    Train picks ``ceil(n_train / C)`` per class round-robin up to n_train;
    val/test draw from the remainder uniformly.  Nodes left over get NONE.
    """
    n = label_ids.shape[0]
    if n_train + n_val + n_test > n:
        raise ValueError(f"split {n_train}+{n_val}+{n_test} is larger "
                         f"than the graph ({n} nodes)")
    rng = np.random.default_rng(seed)
    mask = np.full(n, lux.MASK_NONE, dtype=np.int32)
    by_class = {}
    for c in np.unique(label_ids):
        idx = np.nonzero(label_ids == c)[0]
        by_class[c] = rng.permutation(idx)
    # round-robin over classes so small n_train still covers all of them
    train: "list[int]" = []
    depth = 0
    while len(train) < n_train:
        took = False
        for c in sorted(by_class):
            if len(train) >= n_train:
                break
            if depth < by_class[c].shape[0]:
                train.append(int(by_class[c][depth]))
                took = True
        if not took:
            raise ValueError(f"n_train={n_train} exceeds labeled nodes")
        depth += 1
    train = np.asarray(train)
    mask[train] = lux.MASK_TRAIN
    rest = rng.permutation(np.setdiff1d(np.arange(n), train))
    mask[rest[:n_val]] = lux.MASK_VAL
    mask[rest[n_val:n_val + n_test]] = lux.MASK_TEST
    return mask


def _finish(name: str, num_nodes: int, src: np.ndarray, dst: np.ndarray,
            feats: "np.ndarray | None", label_ids: "np.ndarray | None",
            mask: "np.ndarray | None", *, undirected: bool,
            self_edges: bool, split=None, seed: int = 0) -> Dataset:
    """Shared tail of every converter: symmetrize / self-edge / synthesize
    missing sidecars, then assemble the Dataset."""
    if src.size and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= num_nodes):
        raise ValueError(f"edge endpoint out of range [0, {num_nodes})")
    if undirected:
        src, dst = (np.concatenate([src, dst]), np.concatenate([dst, src]))
        # dedup after symmetrization (an undirected file may list both
        # orientations already; a self-loop symmetrizes to its own
        # duplicate, which the dedup collapses back to one)
        pair = src * num_nodes + dst
        uniq = np.unique(pair)
        src, dst = uniq // num_nodes, uniq % num_nodes
    g = from_edges(num_nodes, src, dst)
    if self_edges:
        g = add_self_edges(g)
    if feats is None:
        # identity features: the standard featureless-graph convention
        # (each vertex's feature is its own indicator; Kipf & Welling's
        # karate-club demo does exactly this).  Dense [N, N] — only viable
        # for small graphs, so guard with a clear error instead of an OOM
        # deep inside np.eye.
        if num_nodes > 65536:
            raise ValueError(
                f"no features given and identity features for {num_nodes} "
                f"nodes would be a dense [{num_nodes}, {num_nodes}] matrix; "
                f"supply --feats for graphs this size")
        feats = np.eye(num_nodes, dtype=np.float32)
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    if feats.shape[0] != num_nodes:
        raise ValueError(f"features rows {feats.shape[0]} != num_nodes "
                         f"{num_nodes}")
    if label_ids is None:
        label_ids = np.zeros(num_nodes, dtype=np.int64)
    label_ids = np.asarray(label_ids, dtype=np.int64).reshape(-1)
    if label_ids.shape[0] != num_nodes:
        raise ValueError(f"labels rows {label_ids.shape[0]} != num_nodes "
                         f"{num_nodes}")
    if label_ids.min() < 0:
        # OGB marks unlabeled nodes -1; one_hot's fancy indexing would wrap
        # that to the LAST class and the split would train on fabricated
        # labels — refuse instead of corrupting silently.
        raise ValueError(
            "negative label ids (unlabeled-node markers?) — remap them to a "
            "real class or supply a mask that excludes those nodes")
    num_classes = int(label_ids.max()) + 1
    if mask is None:
        if split is None:
            # default: ~10% train / ~10% val / remainder test, stratified
            n = num_nodes
            n_tr, n_va = max(num_classes, n // 10), n // 10
            split = (n_tr, n_va, n - n_tr - n_va)
        mask = stratified_split(label_ids, *split, seed=seed)
    mask = np.asarray(mask, dtype=np.int32).reshape(-1)
    if mask.shape[0] != num_nodes:
        raise ValueError(f"mask rows {mask.shape[0]} != num_nodes "
                         f"{num_nodes}")
    return Dataset(name, g, feats, lux.one_hot(label_ids, num_classes),
                   label_ids, mask, feats.shape[1], num_classes)


def from_edge_list(edges_path: str, *, num_nodes: "int | None" = None,
                   feats_path: "str | None" = None,
                   labels_path: "str | None" = None,
                   mask_path: "str | None" = None,
                   undirected: bool = False, self_edges: bool = True,
                   split: "tuple[int, int, int] | None" = None,
                   seed: int = 0, name: str = "") -> Dataset:
    """Convert a plain edge-list dump (plus optional sidecars)."""
    src, dst = read_edge_file(edges_path)
    if num_nodes is None:
        num_nodes = int(max(src.max(), dst.max())) + 1 if src.size else 0
    feats, label_ids = _load_sidecars(feats_path, labels_path)
    mask = None
    if mask_path:
        mask = lux.load_mask(mask_path[:-5], num_nodes) \
            if mask_path.endswith(".mask") else np.loadtxt(
                mask_path, dtype=np.int32).reshape(-1)
    return _finish(name or os.path.basename(edges_path), num_nodes, src, dst,
                   feats, label_ids, mask, undirected=undirected,
                   self_edges=self_edges, split=split, seed=seed)


def from_ogb_dir(root: str, *, undirected: bool = True,
                 self_edges: bool = True, seed: int = 0,
                 name: str = "") -> Dataset:
    """Convert an extracted OGB-style node-property-prediction directory:

        root/edge.csv            src,dst per line (no header)
        root/node-feat.csv       one float row per node          (optional)
        root/node-label.csv      one int per line                (optional)
        root/split/train.csv     node indices, one per line      (optional)
        root/split/valid.csv
        root/split/test.csv

    This is the ``raw/`` layout of an ogbn-* download after gunzip; ogbn-*
    graphs ship directed edges that standard GCN pipelines symmetrize, so
    ``undirected`` defaults to True.
    """
    src, dst = read_edge_file(os.path.join(root, "edge.csv"))
    fp = os.path.join(root, "node-feat.csv")
    lp = os.path.join(root, "node-label.csv")
    feats, labels = _load_sidecars(fp if os.path.exists(fp) else None,
                                   lp if os.path.exists(lp) else None)
    num_nodes = (feats.shape[0] if feats is not None else
                 labels.shape[0] if labels is not None else
                 int(max(src.max(), dst.max())) + 1)
    mask = None
    sp = os.path.join(root, "split")
    if os.path.isdir(sp):
        mask = np.full(num_nodes, lux.MASK_NONE, dtype=np.int32)
        for fname, val in (("train.csv", lux.MASK_TRAIN),
                           ("valid.csv", lux.MASK_VAL),
                           ("test.csv", lux.MASK_TEST)):
            p = os.path.join(sp, fname)
            if os.path.exists(p):
                idx = np.loadtxt(p, dtype=np.int64, ndmin=1)
                mask[idx] = val
    return _finish(name or os.path.basename(os.path.abspath(root)),
                   num_nodes, src, dst, feats, labels, mask,
                   undirected=undirected, self_edges=self_edges, seed=seed)


def karate_club(*, train_nodes=(0, 33)) -> Dataset:
    """Zachary's karate club — a *real* social network (34 members, 78
    friendship edges, observed 1970-72; the club's actual post-fission split
    is the 2-class label).  Vendored under data/karate/ (public-domain
    figures from Zachary 1977); the classic semi-supervised-GCN oracle:
    train on the two faction leaders only (node 0 = "Mr. Hi", node 33 =
    the club officer), predict everyone else's side.

    Zachary's own max-flow model predicted 33/34 members correctly — the
    one miss, member 8, joined Mr. Hi's faction despite a network position
    closer to the officers.  A 2-layer GCN with identity features
    reproduces exactly that: 33/34, with node 8 the sole structural
    misprediction (measured deterministic curve pinned in docs/GOLDEN.md).
    """
    d = os.path.join(_VENDOR_DIR, "karate")
    src, dst = read_edge_file(os.path.join(d, "karate.edges"))
    labels = np.loadtxt(os.path.join(d, "karate.labels"),
                        dtype=np.int64).reshape(-1)
    n = labels.shape[0]
    mask = np.full(n, lux.MASK_TEST, dtype=np.int32)   # test = all others
    mask[list(train_nodes)] = lux.MASK_TRAIN
    return _finish("karate", n, src, dst, None, labels, mask,
                   undirected=True, self_edges=True)


def davis_women(*, train_nodes=(0, 13)) -> Dataset:
    """Davis-Gardner-Gardner Southern Women (1941) — a *real* bipartite
    attendance network (18 women x 14 social events, 89 attendances,
    observed in Natchez, Mississippi in the 1930s; published in *Deep
    South*, 1941).  Vendored under data/davis/ (public-domain figures via
    networkx).  Labels on the women are Freeman's consensus two-group
    split (*Finding Social Groups: A Meta-Analysis of the Southern Women
    Data*, 2003 — the agreement of 21 independent published analyses);
    event nodes are unlabeled (mask NONE).

    The oracle task mirrors the karate recipe on a BIPARTITE graph: train
    on one seed woman per group (node 0 = Evelyn Jefferson, node 13 =
    Nora Fayette), predict the remaining 16 women's group through the
    event nodes — two GCN hops = co-attendance.  Deterministic curve
    pinned in docs/GOLDEN.md."""
    d = os.path.join(_VENDOR_DIR, "davis")
    src, dst = read_edge_file(os.path.join(d, "davis.edges"))
    labels = np.loadtxt(os.path.join(d, "davis.labels"),
                        dtype=np.int64).reshape(-1)
    n = labels.shape[0]
    mask = np.full(n, lux.MASK_NONE, dtype=np.int32)
    mask[labels >= 0] = lux.MASK_TEST          # women; events stay NONE
    mask[list(train_nodes)] = lux.MASK_TRAIN
    labels = np.maximum(labels, 0)     # events: dummy class, masked NONE
    return _finish("davis", n, src, dst, None, labels, mask,
                   undirected=True, self_edges=True)


def les_miserables(*, per_class_train=2, seed: int = 0) -> Dataset:
    """Knuth's Les Misérables co-occurrence network (1993) — a *real*
    literary graph (77 characters, 254 co-occurrence edges; the standard
    community-detection benchmark of Newman 2004).  Vendored under
    data/lesmis/ (public-domain figures via networkx).

    Labels are the 5 Clauset-Newman-Moore greedy-modularity communities
    (Q = 0.4729), computed deterministically at vendor time and checked in
    — NOT hand-assigned (data/lesmis/README.md documents the provenance).
    With identity features, ``per_class_train`` seeds per community, and
    the rest split val/test, a 2-layer GCN lands well below 100%: the
    repo's one real NON-SATURATING accuracy oracle (docs/GOLDEN.md), where
    a plan/kernel bug costing 1-2% accuracy actually moves the pin."""
    d = os.path.join(_VENDOR_DIR, "lesmis")
    src, dst = read_edge_file(os.path.join(d, "lesmis.edges"))
    labels = np.loadtxt(os.path.join(d, "lesmis.labels"),
                        dtype=np.int64).reshape(-1)
    n = labels.shape[0]
    ncls = int(labels.max()) + 1
    mask = stratified_split(labels, per_class_train * ncls, n // 4,
                            n - per_class_train * ncls - n // 4, seed=seed)
    return _finish("lesmis", n, src, dst, None, labels, mask,
                   undirected=True, self_edges=True)


def write(ds: Dataset, prefix: str) -> None:
    """Write a converted dataset to disk in the reference's on-disk layout
    (``<prefix>.add_self_edge.lux`` + sidecars)."""
    lux.write_dataset(prefix, ds.graph, ds.features, ds.label_ids, ds.mask)
