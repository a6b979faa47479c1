"""Build and load the hand-written CUDA kernels.

Each source under ``roc_tpu_torch/csrc/`` has a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``roc_tpu_torch/build/`` (named by the hash of the source, the headers it
includes and the flags, so an edit rebuilds) at its first use, and loaded with ctypes.  Nothing here
runs when a module is imported.  Every wrapper reaches its entry points
through :meth:`CudaLibrary.launch` and checks its tensors' placement with
:func:`_require_cuda` and :func:`_csr_int64`.
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

import torch

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


def source_key(source: Path, flags) -> str:
    """The name a library built from ``source`` with ``flags`` carries: the
    hash of the source, of the headers it includes and of the flags, so an
    edit to any of them builds a new library."""
    return hashlib.sha256(b"".join(_source_closure(source))
                          + " ".join(flags).encode()).hexdigest()[:16]


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
        key = source_key(self.source, NVCC_FLAGS)
        lib = BUILD_DIR / f"libroc_{self.source.stem}_{key}.so"
        if lib.exists():
            self.info.update(path=str(lib), seconds=0.0, cached=True)
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        # roclint: allow(raw-timing) the build's seconds for ``info``, read by chip_smoke's env phase: a build runs once, outside any traced step
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
                # roclint: allow(lock-blocking) one nvcc a library a process: a second caller waits for the first build instead of starting its own; nothing else takes this lock
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib

    def launch(self, wrapper, entry: str, device: torch.device, *args,
               tail=()) -> None:
        """Queue ``entry(*args, stream, *tail)`` on ``device``'s current
        stream, ``device`` entered: the library's entry point ``entry``
        with its arguments, the stream and those that follow it.  Raises
        RuntimeError with the CUDA error the entry point returns; counts
        the launch in ``wrapper.launches`` once it is queued."""
        fn = getattr(self.load(), entry)
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream,
                     *tail)
        if err != 0:
            raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                               f"CUDA error {err}")
        wrapper.launches += 1


def _require_cuda(name: str, *tensors, rows=()) -> None:
    """Every tensor on one CUDA device and contiguous; those in ``rows``
    need only their rows' elements adjacent (a column slice)."""
    dev = (*tensors, *rows)[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    for t in (*tensors, *rows):
        if t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}, got "
                             f"{t.device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in rows:
        if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1) \
                or t.stride(0) < t.shape[1]:
            raise ValueError(f"{name}: {tuple(t.shape)} with strides "
                             f"{t.stride()} is not a row-major matrix")


def _csr_int64(name: str, row_ptr: torch.Tensor) -> None:
    if row_ptr.dtype != torch.int64:
        raise ValueError(f"{name} takes an int64 row_ptr, got "
                         f"{row_ptr.dtype}")
