"""Dataset registry (roc_tpu/graph/datasets.py): the reference's on-disk
format through :func:`load_roc_dataset`, the vendored real graphs
(karate, davis, lesmis; graph/convert.py) and deterministic synthetic
graphs.

``synthetic()`` draws from ``np.random.default_rng(seed)`` in the same
order as the JAX package, so the same name and seed give the same graph,
features and masks, byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from roc_tpu_torch.graph import lux
from roc_tpu_torch.graph.csr import Csr, add_self_edges, from_edges


@dataclasses.dataclass(frozen=True)
class GraphStub:
    """The ``.lux`` header only (num_nodes, num_edges): under -perhost the
    topology is never read whole; the SPMD trainer reads each part's byte
    ranges itself (graph/shard_load.py)."""
    num_nodes: int
    num_edges: int


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    graph: Csr              # includes self-edges; a GraphStub under -perhost
    features: np.ndarray    # [N, in_dim] float32 (may be a read-only memmap)
    labels: "np.ndarray | None"  # [N, C] one-hot float32, or None when lazy
    label_ids: np.ndarray   # [N] int64
    mask: np.ndarray        # [N] int32 in {TRAIN, VAL, TEST, NONE}
    in_dim: int
    num_classes: int

    def onehot_labels(self) -> np.ndarray:
        """One-hot labels, made on demand when the dataset was loaded lazily
        (which skips the [N, C] float32 array)."""
        if self.labels is not None:
            return self.labels
        return lux.one_hot(self.label_ids, self.num_classes)


def load_roc_dataset(prefix: str, in_dim: int, num_classes: int,
                     name: str = "", lazy: bool = False,
                     graph_stub: bool = False) -> Dataset:
    """Load a dataset laid out in the reference's on-disk format.

    ``in_dim``/``num_classes`` come from the layer spec exactly as in the
    reference CLI (`-layers 602-256-41` supplies both, gnn.cc:68-69).
    ``lazy=True`` memory-maps the features and defers the one-hot labels.
    ``graph_stub=True`` (implies lazy) reads only the 12-byte ``.lux``
    header: the per-host trainer (-perhost) loads the topology's slices
    itself."""
    if graph_stub:
        lazy = True
        g = GraphStub(*lux.read_header(prefix + lux.LUX_SUFFIX))
    else:
        g = lux.read_lux(prefix + lux.LUX_SUFFIX)
    feats = lux.load_features(prefix, g.num_nodes, in_dim, mmap=lazy)
    ids = lux.load_label_ids(prefix, g.num_nodes, num_classes)
    mask = lux.load_mask(prefix, g.num_nodes)
    onehot = None if lazy else lux.one_hot(ids, num_classes)
    return Dataset(name or prefix, g, feats, onehot, ids, mask, in_dim,
                   num_classes)


def synthetic(name: str, num_nodes: int, avg_degree: float, in_dim: int,
              num_classes: int, *, n_train: int, n_val: int, n_test: int,
              p_intra: float = 0.8, feature_snr: float = 1.0,
              seed: int = 0, inter_mode: str = "uniform") -> Dataset:
    """Deterministic SBM-style graph with class-informative features: edges
    prefer endpoints in the same class block with probability ``p_intra``;
    features are a per-class mean plus unit Gaussian noise.  ``inter_mode``
    sends the other edges anywhere ("uniform") or to the two neighbouring
    classes on a ring ("ring")."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes)
    num_rand_edges = int(num_nodes * avg_degree)
    src = rng.integers(0, num_nodes, size=num_rand_edges)
    dst = rng.integers(0, num_nodes, size=num_rand_edges)
    intra = rng.random(num_rand_edges) < p_intra
    # a same-class partner: nodes ordered by class, a position drawn inside
    # the class segment of the source's class
    order = np.argsort(labels, kind="stable")
    class_start = np.searchsorted(labels[order], np.arange(num_classes))
    class_count = np.bincount(labels, minlength=num_classes)
    cls = labels[src[intra]]
    pos = class_start[cls] + (rng.random(intra.sum())
                              * class_count[cls]).astype(np.int64)
    dst[intra] = order[np.minimum(pos, num_nodes - 1)]
    if inter_mode == "ring":
        inter = ~intra
        cls_i = labels[src[inter]]
        step = np.where(rng.random(inter.sum()) < 0.5, 1,
                        num_classes - 1).astype(np.int64)
        tgt = (cls_i + step) % num_classes
        pos_i = class_start[tgt] + (rng.random(inter.sum())
                                    * class_count[tgt]).astype(np.int64)
        dst[inter] = order[np.minimum(pos_i, num_nodes - 1)]
    elif inter_mode != "uniform":
        raise ValueError(f"inter_mode={inter_mode!r}: uniform|ring")
    # symmetrize (undirected, like the citation benchmarks)
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    keep = s != d
    g = add_self_edges(from_edges(num_nodes, s[keep], d[keep]))

    means = rng.normal(0.0, 1.0, size=(num_classes, in_dim)).astype(np.float32)
    feats = (feature_snr * means[labels]
             + rng.normal(0.0, 1.0, size=(num_nodes, in_dim))).astype(np.float32)

    mask = np.full(num_nodes, lux.MASK_NONE, dtype=np.int32)
    perm = rng.permutation(num_nodes)
    mask[perm[:n_train]] = lux.MASK_TRAIN
    mask[perm[n_train:n_train + n_val]] = lux.MASK_VAL
    mask[perm[n_train + n_val:n_train + n_val + n_test]] = lux.MASK_TEST

    onehot = np.zeros((num_nodes, num_classes), dtype=np.float32)
    onehot[np.arange(num_nodes), labels] = 1.0
    return Dataset(name, g, feats, onehot, labels.astype(np.int64), mask,
                   in_dim, num_classes)


# Named configs with the standard benchmarks' node, feature and class
# counts (topology and features are synthetic).
_REGISTRY = {
    # name: (num_nodes, avg_degree, in_dim, classes, n_train, n_val, n_test)
    "cora":         (2708,    2.0, 1433,  7,   140,  500, 1000),
    "citeseer":     (3327,    1.4, 3703,  6,   120,  500, 1000),
    "pubmed":       (19717,   2.3, 500,   3,    60,  500, 1000),
    "reddit-small": (23296,  25.0, 602,  41,  3600, 1200, 1200),
    "reddit":       (232965, 50.0, 602,  41, 153431, 23831, 55703),
    "arxiv":        (169343,  7.0, 128,  40, 90941, 29799, 48603),
    "products":     (2449029, 25.0, 100, 47, 196615, 39323, 2213091),
    "roc-audit":    (96,      4.0, 8,     4,    48,   24,   24),
    "mega-shard":   (448,     4.0, 64,    8,   128,   64,   64),
}

# Vendored real graphs (data/*/README.md), fetched by the same names as the
# synthetic stand-ins: name -> constructor on graph/convert.py.  ``seed``
# does not apply: karate and davis use the canonical published splits, and
# lesmis pins its golden-curve split (docs/GOLDEN.md).
_REAL = {"karate": "karate_club", "davis": "davis_women",
         "lesmis": "les_miserables"}


def get(name: str, seed: int = 0) -> Dataset:
    """Fetch a named dataset: a vendored real graph (fixed canonical split;
    ``seed`` ignored), or a deterministic synthetic stand-in (seeded;
    ``roc-audit`` pins its seed to 7, as the JAX package does)."""
    if name in _REAL:
        from roc_tpu_torch.graph import convert
        return getattr(convert, _REAL[name])()
    if name == "roc-audit":
        seed = 7
    n, deg, in_dim, classes, ntr, nva, nte = _REGISTRY[name]
    return synthetic(name, n, deg, in_dim, classes,
                     n_train=ntr, n_val=nva, n_test=nte, seed=seed)


def names():
    return sorted(_REGISTRY) + list(_REAL)
