"""The host graph builders in C++ (src/roc_native.cc), bound with ctypes
(roc_tpu/native/__init__.py's names and signatures).

The library is built with ``g++ -O3 -fPIC -std=c++17 -shared -pthread`` at its first
use, into the git-ignored ``roc_tpu_torch/build/``, named by the hash of
its source and flags as the CUDA libraries are (``ops/kernels/build.py``),
and loaded once a process.  Nothing builds at import.

The graph modules call it where roc_tpu calls its own: the CSR transpose
with its edge map and the RCM order at >= 2^20 edges (``graph/csr.py``,
``ops/aggregate.py``, ``graph/reorder.py``), the edge-balanced cut
(``graph/partition.py``), the halo maps (``parallel/halo.py``), the `.lux`
header and slices and the feature CSV (``graph/lux.py``; it follows
``np.loadtxt``'s grammar, one range of lines per core).  Each has a NumPy
twin there, its oracle in the tests.  roc_tpu also binds a `.lux` writer
and an in-degree count that none of its modules calls; the port leaves
them out.

One difference from roc_tpu, on purpose: no silent fallback.  roc_tpu's
``lib()`` returns None on any build or load failure and its NumPy paths
then run without a word; here a failed build raises with g++'s output, and
a failed load raises.  The NumPy paths run only when asked for, with
roc_tpu's switch ``ROC_TPU_NO_NATIVE=1`` (read at each call).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "roc_native.cc"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# the build of this process: library path, g++ seconds (0 when the library
# was already on disk) and whether it was
info: dict = {}


def enabled() -> bool:
    """Whether the graph modules take the native paths: always, unless
    ``ROC_TPU_NO_NATIVE=1``."""
    return os.environ.get("ROC_TPU_NO_NATIVE") != "1"


def build() -> Path:
    """Build the library from ``SOURCE`` unless a library of the same
    source and flags is already built; its path.  Raises RuntimeError with
    g++'s output when the build fails."""
    from roc_tpu_torch.ops.kernels.build import BUILD_DIR, source_key
    source = SOURCE
    lib = BUILD_DIR / f"libroc_native_{source_key(source, GXX_FLAGS)}.so"
    if lib.exists():
        info.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    # roclint: allow(raw-timing) the build's seconds for ``info``, as CudaLibrary records nvcc's: a build runs once, outside any traced step
    t0 = time.perf_counter()
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    info.update(path=str(lib), seconds=time.perf_counter() - t0,
                cached=False)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded library, built at the first call of the process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            # roclint: allow(lock-blocking) one g++ a process: a second caller waits for the first build instead of starting its own; nothing else takes this lock
            L = ctypes.CDLL(str(build()))
            _bind(L)
            _LIB = L
    return _LIB


def _bind(L: ctypes.CDLL) -> None:
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    L.roc_lux_header.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_uint32),
                                 ctypes.POINTER(ctypes.c_uint64)]
    L.roc_lux_header.restype = ctypes.c_int
    L.roc_lux_read_slice.argtypes = [ctypes.c_char_p] + \
        [ctypes.c_uint64] * 4 + [u64p, u32p]
    L.roc_lux_read_slice.restype = ctypes.c_int
    L.roc_partition.argtypes = [u64p, ctypes.c_uint64, ctypes.c_uint64,
                                ctypes.c_int64, i64p, ctypes.c_int64]
    L.roc_partition.restype = ctypes.c_int64
    L.roc_parse_feats_csv.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int64, f32p]
    L.roc_parse_feats_csv.restype = ctypes.c_int64
    L.roc_halo_sizes.argtypes = [i64p] + [ctypes.c_int64] * 3 + [i64p]
    L.roc_halo_sizes.restype = ctypes.c_int
    L.roc_halo_fill.argtypes = [i64p] + [ctypes.c_int64] * 4 + [i32p, i32p]
    L.roc_halo_fill.restype = ctypes.c_int
    L.roc_rcm_order.argtypes = [i64p, i32p, i64p, i32p, ctypes.c_int64,
                                i64p]
    L.roc_rcm_order.restype = ctypes.c_int
    # the edge map may be null: a pointer argument rather than an ndpointer
    L.roc_csr_transpose.argtypes = [i64p, i32p, ctypes.c_int64,
                                    ctypes.c_int64, i64p, i32p,
                                    ctypes.c_void_p]
    L.roc_csr_transpose.restype = ctypes.c_int


# -- typed wrappers ---------------------------------------------------------

def lux_header(path: str):
    """The `.lux` header: (num_nodes, num_edges)."""
    nv, ne = ctypes.c_uint32(), ctypes.c_uint64()
    rc = lib().roc_lux_header(os.fsencode(path), ctypes.byref(nv),
                              ctypes.byref(ne))
    if rc != 0:
        raise IOError(f"roc_lux_header({path}) failed rc={rc}")
    return int(nv.value), int(ne.value)


def lux_read_slice(path: str, row_lo: int, row_hi: int, col_lo: int,
                   col_hi: int):
    """Rows [row_lo, row_hi) of the offset section and cols [col_lo,
    col_hi) of the column section: (uint64 rows, uint32 cols).  A short
    read (the file ends inside a range) raises ValueError, as the NumPy
    reads do; a file that does not open, or holds no header, OSError."""
    rows = np.empty(row_hi - row_lo, np.uint64)
    cols = np.empty(col_hi - col_lo, np.uint32)
    rc = lib().roc_lux_read_slice(os.fsencode(path), row_lo, row_hi, col_lo,
                                  col_hi, rows, cols)
    if rc == -4:
        raise ValueError(f".lux row range [{row_lo}, {row_hi}) runs past "
                         f"the end of {path} (short read)")
    if rc == -5:
        raise ValueError(f".lux edge range [{col_lo}, {col_hi}) runs past "
                         f"the end of {path} (short read)")
    if rc == -3:
        raise ValueError(f".lux ranges [{row_lo}, {row_hi}) and [{col_lo}, "
                         f"{col_hi}) do not fit the header of {path}")
    if rc != 0:
        raise IOError(f"roc_lux_read_slice({path}) failed rc={rc}")
    return rows, cols


def partition(raw_rows: np.ndarray, num_edges: int, num_parts: int):
    """The greedy edge-balanced cut: (parts produced, bounds [n, 2]) with
    every part it produced, which on a skewed graph may be more than
    ``num_parts`` (a second call, sized by the first's count, writes
    them)."""
    L = lib()
    raw_rows = np.ascontiguousarray(raw_rows, np.uint64)
    bounds = np.zeros((num_parts, 2), np.int64)
    n = int(L.roc_partition(raw_rows, len(raw_rows), num_edges, num_parts,
                            bounds.reshape(-1), num_parts))
    if n > num_parts:
        bounds = np.zeros((n, 2), np.int64)
        L.roc_partition(raw_rows, len(raw_rows), num_edges, num_parts,
                        bounds.reshape(-1), n)
    return n, bounds[:n]


def parse_feats_csv(path: str, num_rows: int, num_cols: int) -> np.ndarray:
    """[num_rows, num_cols] float32 from a comma-separated text file, as
    ``np.loadtxt(path, delimiter=",", dtype=np.float32)`` reads it ('#'
    comments, empty lines skipped, whitespace around a field, Python's
    float grammar).  OSError when the file does not open; ValueError, as
    ``np.loadtxt`` and the NumPy path's shape check give, on a malformed
    row or a row count other than ``num_rows``."""
    out = np.empty((num_rows, num_cols), np.float32)
    n = lib().roc_parse_feats_csv(os.fsencode(path), num_rows, num_cols,
                                  out.reshape(-1))
    if n == -1:
        raise OSError(f"roc_parse_feats_csv: cannot open {path}")
    if n != num_rows:
        where = (f"row {-n - 2} is malformed" if n < 0
                 else f"it holds {n} rows")
        raise ValueError(f"{path}: feats.csv shape is not ({num_rows},"
                         f"{num_cols}): {where}")
    return out


def halo_maps(edge_src: np.ndarray, shard_nodes: int):
    """Halo send lists and the edge-source remap (parallel/halo.py's
    layout).  ``edge_src``: [P, E] padded-global ids.  Returns (K, sizes
    [P, P] int64, send_idx [P, P, K] int32, edge_src_local [P, E]
    int32)."""
    L = lib()
    src = np.ascontiguousarray(edge_src, np.int64)
    P, E = src.shape
    sizes = np.zeros((P, P), np.int64)
    rc = L.roc_halo_sizes(src.reshape(-1), P, E, shard_nodes,
                          sizes.reshape(-1))
    if rc != 0:
        raise RuntimeError(f"roc_halo_sizes rc={rc}")
    K = max(int(sizes.max()), 1)
    send_idx = np.empty((P, P, K), np.int32)
    edge_src_local = np.empty((P, E), np.int32)
    rc = L.roc_halo_fill(src.reshape(-1), P, E, shard_nodes, K,
                         send_idx.reshape(-1), edge_src_local.reshape(-1))
    if rc != 0:
        raise RuntimeError(f"roc_halo_fill rc={rc}")
    return K, sizes, send_idx, edge_src_local


def _check_rows(row_ptr: np.ndarray, num_edges: int) -> None:
    """ValueError unless ``row_ptr`` runs monotonely from 0 to
    ``num_edges``: the C loops index by it."""
    if len(row_ptr) < 1 or row_ptr[0] != 0 or row_ptr[-1] != num_edges \
            or np.any(np.diff(row_ptr) < 0):
        raise ValueError("row_ptr must run monotonely from 0 to num_edges")


def _check_csr(row_ptr: np.ndarray, col_idx: np.ndarray) -> None:
    """:func:`_check_rows`, and every source in [0, N)."""
    _check_rows(row_ptr, len(col_idx))
    if len(col_idx) and (int(col_idx.min()) < 0
                         or int(col_idx.max()) >= len(row_ptr) - 1):
        raise ValueError("col_idx out of range [0, num_nodes)")


def rcm_order(row_ptr: np.ndarray, col_idx: np.ndarray,
              t_row_ptr: np.ndarray, t_col_idx: np.ndarray) -> np.ndarray:
    """The RCM order (graph/reorder.py) from the in-edge CSR and its
    transpose: order[new] = old, element-equal to the NumPy oracle."""
    _check_csr(row_ptr, col_idx)
    _check_csr(t_row_ptr, t_col_idx)
    N = len(row_ptr) - 1
    out = np.empty(N, np.int64)
    rc = lib().roc_rcm_order(np.ascontiguousarray(row_ptr, np.int64),
                             np.ascontiguousarray(col_idx, np.int32),
                             np.ascontiguousarray(t_row_ptr, np.int64),
                             np.ascontiguousarray(t_col_idx, np.int32),
                             N, out)
    if rc != 0:
        raise RuntimeError(f"roc_rcm_order rc={rc}")
    return out


def csr_transpose(row_ptr: np.ndarray, col_idx: np.ndarray,
                  edge_map: bool = False):
    """The stable O(E) CSR transpose: (t_row_ptr [N+1] int64, t_col_idx
    [E] int32), element-equal to the NumPy stable-argsort oracle, and with
    ``edge_map`` the order too: [E] int64, edge e' of the transpose is
    forward edge order[e'] (``np.argsort(col_idx, kind="stable")``).
    ValueError when a source lies outside [0, N) (the library checks each
    as it counts) or the row offsets are not a CSR's."""
    N, E = len(row_ptr) - 1, len(col_idx)
    _check_rows(row_ptr, E)
    t_row = np.empty(N + 1, np.int64)
    t_col = np.empty(E, np.int32)
    order = np.empty(E, np.int64) if edge_map else None
    rc = lib().roc_csr_transpose(
        np.ascontiguousarray(row_ptr, np.int64),
        np.ascontiguousarray(col_idx, np.int32), N, E, t_row, t_col,
        None if order is None else order.ctypes.data)
    if rc == -1:
        raise ValueError("col_idx out of range [0, num_nodes)")
    if rc != 0:
        raise RuntimeError(f"roc_csr_transpose rc={rc}")
    return (t_row, t_col, order) if edge_map else (t_row, t_col)
