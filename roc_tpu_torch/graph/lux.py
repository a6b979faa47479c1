"""ROC on-disk format IO (`.lux`, `.feats.csv/.bin`, `.label`, `.mask`), as
roc_tpu/graph/lux.py's NumPy path writes and reads it.

Binary `.lux` layout (reference: gnn.cc:755-801 + load_task.cu:222-245):
    uint32  numNodes
    uint64  numEdges                      (FILE_HEADER_SIZE = 12, gnn.h:33)
    uint64  raw_rows[numNodes]            inclusive END offsets per vertex
                                          (raw_rows[N-1] == numEdges)
    uint32  raw_cols[numEdges]            source vertex id per in-edge

Sidecar files (load_task.cu:25-184):
    <prefix>.feats.csv   one comma-separated float row per vertex
    <prefix>.feats.bin   row-major float32 cache, written on first CSV parse
    <prefix>.label       one int class id per vertex (whitespace separated)
    <prefix>.label.bin   int32 cache of the `.label` parse
    <prefix>.mask        one of Train/Val/Test/None per line

Mask encoding matches gnn.h:98-103: TRAIN=0, VAL=1, TEST=2, NONE=3.
Every read goes through the ``lux.read`` fault site and the shared retry
policy (roc_tpu_torch/fault).  The header, the slices and the feature CSV
are read in C++ (``roc_tpu_torch.native``, where roc_tpu reads them with
its own) unless ``ROC_TPU_NO_NATIVE=1``; the NumPy reads are their oracle.
"""

from __future__ import annotations

import os

import numpy as np

from roc_tpu_torch import fault, native
from roc_tpu_torch.graph.csr import Csr, E_DTYPE, V_DTYPE

MASK_TRAIN, MASK_VAL, MASK_TEST, MASK_NONE = 0, 1, 2, 3
_MASK_NAMES = {"Train": MASK_TRAIN, "Val": MASK_VAL, "Test": MASK_TEST,
               "None": MASK_NONE}
_MASK_STRS = {v: k for k, v in _MASK_NAMES.items()}

LUX_SUFFIX = ".add_self_edge.lux"
# The transposed graph (out-edge CSR over sources), written by the converter
# for the JAX package's edge-sharded per-host loading.
TLUX_SUFFIX = ".add_self_edge.t.lux"

_HEADER_SIZE = 12  # uint32 numNodes + uint64 numEdges (gnn.h:33)


def read_header(path: str) -> "tuple[int, int]":
    """The 12-byte `.lux` header: (num_nodes, num_edges)."""
    if native.enabled():
        return native.lux_header(path)
    with open(path, "rb") as f:
        num_nodes = int(np.fromfile(f, dtype=np.uint32, count=1)[0])
        num_edges = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
    return num_nodes, num_edges


def read_rows_slice(path: str, lo: int, hi: int) -> np.ndarray:
    """raw_rows[lo:hi] (inclusive end offsets) via one seek and read (the
    reference's per-partition seeking, load_task.cu:231-243).

    The range is checked *before* any seek: a bad range fails loudly here
    rather than as a short read or a silent negative-count no-op."""
    if lo < 0 or hi < lo:
        raise ValueError(f".lux row range [{lo}, {hi}) is invalid "
                         "(need 0 <= lo <= hi)")
    num_nodes, _ = read_header(path)
    if hi > num_nodes:
        raise ValueError(f".lux row range [{lo}, {hi}) runs past the end "
                         f"of {path} ({num_nodes} nodes)")

    def _read():
        # Retried as one unit: the seek and read are idempotent, and a
        # short read (a torn write seen mid-replace) surfaces as the
        # ValueError below, transient by construction.
        fault.point("lux.read")
        if native.enabled():
            return native.lux_read_slice(path, lo, hi, 0, 0)[0]
        with open(path, "rb") as f:
            f.seek(_HEADER_SIZE + 8 * lo)
            rows = np.fromfile(f, dtype=np.uint64, count=hi - lo)
        if rows.shape[0] != hi - lo:
            raise ValueError(f".lux row range [{lo}, {hi}) runs past the "
                             f"end of {path} (got {rows.shape[0]} offsets)")
        return rows
    return fault.retrying("lux.read", _read, retry_on=(OSError, ValueError))


def read_cols_slice(path: str, num_nodes: int, e0: int, e1: int
                    ) -> np.ndarray:
    """raw_cols[e0:e1] (source vertex ids) via one seek and read."""
    if e0 < 0 or e1 < e0:
        raise ValueError(f".lux edge range [{e0}, {e1}) is invalid "
                         "(need 0 <= e0 <= e1)")
    _, num_edges = read_header(path)
    if e1 > num_edges:
        raise ValueError(f".lux edge range [{e0}, {e1}) runs past the end "
                         f"of {path} ({num_edges} edges)")

    def _read():
        fault.point("lux.read")
        if native.enabled():
            return native.lux_read_slice(path, 0, 0, e0, e1)[1]
        with open(path, "rb") as f:
            f.seek(_HEADER_SIZE + 8 * num_nodes + 4 * e0)
            cols = np.fromfile(f, dtype=np.uint32, count=e1 - e0)
        if cols.shape[0] != e1 - e0:
            raise ValueError(f".lux edge range [{e0}, {e1}) runs past the "
                             f"end of {path} (got {cols.shape[0]} ids)")
        return cols
    return fault.retrying("lux.read", _read, retry_on=(OSError, ValueError))


def read_lux(path: str) -> Csr:
    """Read a `.lux` graph file into an exclusive-prefix CSR."""
    num_nodes, num_edges = read_header(path)
    raw_rows = read_rows_slice(path, 0, num_nodes)
    raw_cols = read_cols_slice(path, num_nodes, 0, num_edges)
    # The reference asserts monotonicity and the final offset
    # (gnn.cc:797-800).
    if np.any(np.diff(raw_rows.astype(np.int64)) < 0):
        raise ValueError(f"{path}: row offsets are not monotone")
    if num_nodes and raw_rows[-1] != num_edges:
        raise ValueError(f"{path}: last row offset {raw_rows[-1]} != "
                         f"{num_edges} edges")
    row_ptr = np.zeros(num_nodes + 1, dtype=E_DTYPE)
    row_ptr[1:] = raw_rows.astype(E_DTYPE)
    g = Csr(num_nodes, num_edges, row_ptr, raw_cols.astype(V_DTYPE))
    g.validate()
    return g


def write_lux(path: str, g: Csr) -> None:
    """Write a CSR in the reference's `.lux` layout (inclusive end
    offsets)."""
    with open(path, "wb") as f:
        np.asarray([g.num_nodes], dtype=np.uint32).tofile(f)
        np.asarray([g.num_edges], dtype=np.uint64).tofile(f)
        g.row_ptr[1:].astype(np.uint64).tofile(f)
        g.col_idx.astype(np.uint32).tofile(f)


def write_transpose(prefix: str, g: Csr) -> None:
    """Write the transposed graph (``prefix + TLUX_SUFFIX``)."""
    write_lux(prefix + TLUX_SUFFIX, g.transpose())


def _cache_fresh(bin_path: str, src_path: str) -> bool:
    """A binary cache is usable iff it exists and is no older than its
    source text file (a regenerated source invalidates it, like make);
    equal mtimes count as fresh, and a cache without its source is a
    binary-only distribution."""
    if not os.path.exists(bin_path):
        return False
    if not os.path.exists(src_path):
        return True
    return os.path.getmtime(bin_path) >= os.path.getmtime(src_path)


def _atomic_tofile(arr: np.ndarray, path: str) -> None:
    """Write-then-rename, so a concurrent reader never sees a truncated
    cache, with an fsync on both sides of the rename
    (``fault.fsync_replace``)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    arr.tofile(tmp)
    fault.fsync_replace(tmp, path)


def load_features(prefix: str, num_nodes: int, in_dim: int,
                  mmap: bool = False) -> np.ndarray:
    """Load node features, preferring the `.feats.bin` cache and writing it
    after a CSV parse, exactly like the reference (load_task.cu:41-73).

    ``mmap=True`` returns a read-only np.memmap of the binary cache instead
    of materializing [N, in_dim] in host memory."""
    bin_path = prefix + ".feats.bin"
    csv_path = prefix + ".feats.csv"
    if not _cache_fresh(bin_path, csv_path):
        if native.enabled():
            feats = native.parse_feats_csv(csv_path, num_nodes, in_dim)
        else:
            feats = np.loadtxt(csv_path, delimiter=",", dtype=np.float32,
                               ndmin=2)
            if feats.shape != (num_nodes, in_dim):
                raise ValueError(f"feats.csv shape {feats.shape} != "
                                 f"({num_nodes},{in_dim})")
        _atomic_tofile(feats, bin_path)
        if not mmap:
            return feats
    if mmap:
        return np.memmap(bin_path, dtype=np.float32, mode="r",
                         shape=(num_nodes, in_dim))
    feats = np.fromfile(bin_path, dtype=np.float32, count=num_nodes * in_dim)
    if feats.size != num_nodes * in_dim:
        raise ValueError(f"{bin_path}: {feats.size} floats, expected "
                         f"{num_nodes} x {in_dim}")
    return feats.reshape(num_nodes, in_dim)


def one_hot(ids: np.ndarray, num_classes: int) -> np.ndarray:
    """[...,] int ids -> [..., C] float32 one-hot (the reference's on-host
    label layout, load_task.cu:110-123)."""
    out = np.zeros(ids.shape + (num_classes,), dtype=np.float32)
    out.reshape(-1, num_classes)[np.arange(ids.size), ids.reshape(-1)] = 1.0
    return out


def load_label_ids(prefix: str, num_nodes: int,
                   num_classes: int) -> np.ndarray:
    """Load `.label` int class ids, caching the text parse to `.label.bin`
    (the `.feats.bin` pattern: the binary reload is instant)."""
    bin_path = prefix + ".label.bin"
    if _cache_fresh(bin_path, prefix + ".label"):
        ids = np.fromfile(bin_path, dtype=np.int32, count=num_nodes)
        if ids.size != num_nodes:
            raise ValueError(f"{bin_path}: {ids.size} labels, expected "
                             f"{num_nodes}")
        ids = ids.astype(np.int64)
    else:
        ids = np.loadtxt(prefix + ".label", dtype=np.int64).reshape(-1)
        if ids.shape[0] != num_nodes:
            raise ValueError(f"{prefix}.label: {ids.shape[0]} labels, "
                             f"expected {num_nodes}")
        _atomic_tofile(ids.astype(np.int32), bin_path)
    if ids.size and (ids.min() < 0 or ids.max() >= num_classes):
        raise ValueError(f"{prefix}.label: class ids outside "
                         f"[0, {num_classes})")
    return ids


def load_labels(prefix: str, num_nodes: int, num_classes: int) -> np.ndarray:
    """Load int class ids and expand to one-hot float32 rows
    (load_task.cu:110-123)."""
    return one_hot(load_label_ids(prefix, num_nodes, num_classes),
                   num_classes)


def load_mask(prefix: str, num_nodes: int) -> np.ndarray:
    """Load the Train/Val/Test/None text mask (load_task.cu:160-180)."""
    with open(prefix + ".mask") as f:
        lines = [line.rstrip("\n") for line in f][:num_nodes]
    if len(lines) != num_nodes:
        raise ValueError(f"{prefix}.mask: {len(lines)} lines, expected "
                         f"{num_nodes} (mask file too short)")
    try:
        return np.asarray([_MASK_NAMES[ln] for ln in lines], dtype=np.int32)
    except KeyError as e:
        raise ValueError(f"Unrecognized mask: {e.args[0]!r}") from None


def write_features_bin(prefix: str, feats: np.ndarray) -> None:
    """Write the `.feats.bin` cache alone: with no `.feats.csv` beside it,
    ``load_features`` reads it as a binary-only distribution."""
    _atomic_tofile(np.ascontiguousarray(feats, np.float32),
                   prefix + ".feats.bin")


def write_labels(prefix: str, label_ids: np.ndarray) -> None:
    np.savetxt(prefix + ".label", label_ids.reshape(-1, 1), fmt="%d")


def write_mask(prefix: str, mask: np.ndarray) -> None:
    with open(prefix + ".mask", "w") as f:
        f.writelines(_MASK_STRS[int(m)] + "\n" for m in mask)


def write_dataset(prefix: str, g: Csr, feats: np.ndarray,
                  label_ids: np.ndarray, mask: np.ndarray) -> None:
    """Write a full ROC-format dataset (graph + sidecars) under `prefix`,
    byte-equal to roc_tpu's ``write_dataset``."""
    parent = os.path.dirname(prefix)
    if parent:
        os.makedirs(parent, exist_ok=True)
    write_lux(prefix + LUX_SUFFIX, g)
    # %.9g is FLT_DECIMAL_DIG significant digits: every float32 round-trips
    # the text exactly, so a reader that loses the .bin cache and reparses
    # the CSV gets bit-identical features.
    feats32 = np.ascontiguousarray(feats, np.float32)
    np.savetxt(prefix + ".feats.csv", feats32, delimiter=",", fmt="%.9g")
    # the binary cache the loader would build on first read, written after
    # the CSV so _cache_fresh accepts it
    write_features_bin(prefix, feats32)
    write_labels(prefix, label_ids)
    write_mask(prefix, mask)
