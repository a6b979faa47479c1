"""The spill tier: memory-mapped boundary stores for -stream-spill
(roc_tpu/stream/spill.py, the same on-disk format).

The third rung of the rotation ladder (device slot -> host store ->
disk): the segment-boundary activation and cotangent stores become
``np.memmap`` files under the ``-stream-spill`` directory, so host memory
holds only the graph-shaped arrays.  The ring's worker reads slot i+1's
rows off the map behind slot i's compute, as it stages the other tiers.

Each file starts with roc_tpu's 64-byte CRC'd header (magic, version,
dtype code, rows, cols, CRC32), promoted through
``fault.fsync_replace``, so a store written by either package opens in
the other.  dtype code 2 is bf16: roc_tpu maps it as ``ml_dtypes``'
bfloat16, the port as the raw 16-bit words (``host.BF16``), the same
bytes.  A bad magic, version or CRC or a short file raises
:class:`SpillHeaderError`.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from roc_tpu_torch.stream.host import BF16

__all__ = ["SpillError", "SpillHeaderError", "create_store", "open_store",
           "HEADER_BYTES"]

_MAGIC = b"RSPL"
_VERSION = 1
HEADER_BYTES = 64
# magic | u16 version | u16 dtype-code | u64 rows | u64 cols | u32 crc32
_HDR = struct.Struct("<4sHHQQI")

# dtype codes are part of the on-disk format: append-only.
_DTYPES = {1: np.dtype(np.float32), 2: BF16}
_CODES = {v: k for k, v in _DTYPES.items()}


class SpillError(RuntimeError):
    """A spill store that cannot be used (I/O layout, unknown dtype)."""


class SpillHeaderError(SpillError):
    """A spill store that cannot be *trusted*: torn/corrupt header."""


def _pack_header(dtype: np.dtype, rows: int, cols: int) -> bytes:
    code = _CODES.get(np.dtype(dtype))
    if code is None:
        raise SpillError(f"spill store: unsupported dtype {dtype!r}")
    body = _HDR.pack(_MAGIC, _VERSION, code, rows, cols, 0)[:-4]
    crc = zlib.crc32(body) & 0xFFFFFFFF
    hdr = body + struct.pack("<I", crc)
    return hdr + b"\0" * (HEADER_BYTES - len(hdr))


def create_store(path: str, shape, dtype) -> np.ndarray:
    """Create a zero-filled spill store at ``path`` and return its
    writable memmap.  The CRC'd header is promoted durably
    (tmp + fsync + rename, ``fault.fsync_replace``) before the data
    region is extended, so every visible file has a valid header."""
    from roc_tpu_torch import fault

    rows, cols = int(shape[0]), int(shape[1])
    dtype = np.dtype(dtype)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_pack_header(dtype, rows, cols))
    fault.fsync_replace(tmp, path)
    nbytes = rows * cols * dtype.itemsize
    with open(path, "r+b") as f:
        f.truncate(HEADER_BYTES + nbytes)  # sparse: zero pages on demand
    return np.memmap(path, dtype=dtype, mode="r+",
                     offset=HEADER_BYTES, shape=(rows, cols))


def open_store(path: str) -> np.ndarray:
    """Open an existing spill store, validating the header end to end."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            raw = f.read(HEADER_BYTES)
    except OSError as e:
        raise SpillError(f"spill store {path!r}: {e}") from e
    if len(raw) < HEADER_BYTES:
        raise SpillHeaderError(
            f"spill store {path!r}: truncated header "
            f"({len(raw)} < {HEADER_BYTES} bytes)")
    magic, version, code, rows, cols, crc = _HDR.unpack(raw[:_HDR.size])
    if magic != _MAGIC:
        raise SpillHeaderError(
            f"spill store {path!r}: bad magic {magic!r} (not a spill store)")
    if zlib.crc32(raw[:_HDR.size - 4]) & 0xFFFFFFFF != crc:
        raise SpillHeaderError(
            f"spill store {path!r}: header CRC mismatch — torn or corrupt "
            "write; delete the spill directory and rerun")
    if version != _VERSION:
        raise SpillHeaderError(
            f"spill store {path!r}: version {version} (expected {_VERSION})")
    dtype = _DTYPES.get(code)
    if dtype is None:
        raise SpillHeaderError(
            f"spill store {path!r}: unknown dtype code {code}")
    want = HEADER_BYTES + rows * cols * dtype.itemsize
    if size < want:
        raise SpillHeaderError(
            f"spill store {path!r}: data region truncated "
            f"({size} < {want} bytes)")
    return np.memmap(path, dtype=dtype, mode="r+",
                     offset=HEADER_BYTES, shape=(rows, cols))
