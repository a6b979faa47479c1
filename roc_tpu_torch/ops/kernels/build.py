"""Build and load the hand-written CUDA kernels.

Each source under ``roc_tpu_torch/csrc/`` has a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``roc_tpu_torch/build/`` (named by the hash of the source, the headers it
includes and the flags, so an edit rebuilds) at its first use, and loaded with ctypes.  Nothing here
runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "from source at first use")


_QUOTED_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_closure(source: Path) -> list:
    """The bytes of ``source`` and of every header it includes with quotes
    (resolved beside the including file, as nvcc resolves them), each
    once, in the order first reached: an edit to a header rebuilds every
    library that includes it."""
    seen, out, todo = set(), [], [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        data = path.read_bytes()
        out.append(data)
        todo += [(path.parent / m.decode()).resolve()
                 for m in _QUOTED_INCLUDE.findall(data)]
    return out


_BUILDS = [0]


def build_count() -> int:
    """``nvcc`` runs in this process (a library already built on disk is
    loaded, not counted)."""
    return _BUILDS[0]


class CudaLibrary:
    """One ``csrc/*.cu`` source, its shared library and its ctypes handle.

    ``bind(lib)`` declares ``argtypes``/``restype`` of the library's entry
    points.  ``info`` records the build: the library path, the seconds
    ``nvcc`` took (0 when the library was already built) and the compiler's
    register report."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None
        self.info: dict = {}

    def build(self) -> Path:
        key = hashlib.sha256(b"".join(_source_closure(self.source))
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"libroc_{self.source.stem}_{key}.so"
        if lib.exists():
            self.info.update(path=str(lib), seconds=0.0, cached=True)
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{self.source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        _BUILDS[0] += 1
        self.info.update(path=str(lib), seconds=time.perf_counter() - t0,
                         cached=False,
                         log=(proc.stdout + proc.stderr).strip())
        return lib

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library, once per process."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib
