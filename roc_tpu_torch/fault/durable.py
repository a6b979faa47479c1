"""Crash-consistent file replacement (roc_tpu/fault/durable.py).

An atomic writer (the ``.feats.bin`` and ``.label.bin`` caches of
``graph/lux.py``) writes a temp file and ``os.replace``s it over the
target.  That is atomic against *readers*, but not durable against
*power loss / kill*: without an fsync the rename can land on disk
before the data blocks do, leaving a correctly-named file full of
garbage.  ``fsync_replace`` closes the hole: flush the temp file's
data, rename, then flush the directory entry.

Standard library only, as ``graph/lux.py`` needs.
"""

from __future__ import annotations

import os


def fsync_replace(tmp_path: str, path: str) -> None:
    """Durably promote ``tmp_path`` (already written + closed) to
    ``path``: fsync(tmp) -> os.replace -> fsync(parent dir)."""
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp_path, path)
    dirname = os.path.dirname(os.path.abspath(path))
    try:
        dfd = os.open(dirname, os.O_RDONLY)
    except OSError:  # roclint: allow(silent-swallow) — platforms without
        return       # O_RDONLY directory opens lose only the dir fsync
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
