"""npz checkpoints in the JAX package's layout (roc_tpu/train/checkpoint.py),
so a checkpoint crosses between the two packages both ways.

Layout: ``p_leaf_{i}`` for the params, ``o_leaf_{i}`` for the optimizer
state, and a ``meta`` record (JSON bytes as uint8) holding the format
version, epoch, alpha, extra and a CRC32 over the payload.  Leaf ``i`` is
the i-th leaf in jax's pytree flatten order, which sorts dict keys
lexicographically: ``linear_10`` comes before ``linear_2``.

A save writes a temp file, fsyncs it, renames it over the target and
fsyncs the directory (``fault.durable.fsync_replace``), so a crash leaves
the old checkpoint or the new one.

``save_arrays`` / ``load_arrays`` (checkpoint.py:82-145) store any named
array dict under the same meta record and CRC, through the retried write
and the ``<site>.write`` / ``<site>.kill_tmp`` / ``<site>.kill_rename``
fault sites; the delta snapshot of ``serve/delta.py`` is one.  A file
written by either package opens in the other.
"""

from __future__ import annotations

import json
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from roc_tpu_torch.fault import inject
from roc_tpu_torch.fault.durable import fsync_replace
from roc_tpu_torch.fault.retry import retrying
from roc_tpu_torch.optim.adam import AdamState

_FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    """A checkpoint file that cannot be trusted (corrupt, truncated, or
    from an incompatible format version)."""


def _leaves(tree) -> List[Any]:
    """Leaves in jax's flatten order: dicts by sorted key, lists and tuples
    in order, None has no leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(_leaves(tree))}


def _payload_crc(arrays: Dict[str, np.ndarray]) -> int:
    """CRC32 over every payload array (sorted key order), covering key,
    dtype, shape and bytes."""
    crc = 0
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        crc = zlib.crc32(f"{k}:{a.dtype.str}:{a.shape}".encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def save(path: str, params, opt_state=None, epoch: int = 0,
         alpha: float = 0.0, extra: Dict[str, Any] | None = None) -> None:
    """Durable atomic save of ``params`` (a dict of tensors or arrays) and
    an optional optimizer-state tree."""
    payload = {f"p_{k}": v for k, v in _flatten(params).items()}
    payload.update({f"o_{k}": v for k, v in _flatten(opt_state).items()})
    meta = {"version": _FORMAT_VERSION, "epoch": epoch, "alpha": alpha,
            "extra": extra or {}, "crc32": _payload_crc(payload)}
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    fsync_replace(tmp, path)


def save_arrays(path: str, arrays: Dict[str, np.ndarray],
                extra: Dict[str, Any] | None = None,
                site: str = "ckpt") -> None:
    """The durable save for an arbitrary named array dict: retried temp
    write, CRC32 stamp in the meta record, fsync + rename + directory
    fsync, with the kill windows ``<site>.kill_tmp`` (temp on disk, target
    untouched) and ``<site>.kill_rename`` (the new file complete)."""
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    meta = {"version": _FORMAT_VERSION, "epoch": -1, "alpha": 0.0,
            "extra": extra or {}, "crc32": _payload_crc(payload)}
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"

    def _write():
        inject.point(f"{site}.write")
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
    retrying(f"{site}.write", _write)
    inject.point(f"{site}.kill_tmp")
    fsync_replace(tmp, path)
    inject.point(f"{site}.kill_rename")


def load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Verified load of a :func:`save_arrays` file: ``(arrays, extra)``;
    :class:`CheckpointError` on anything torn, corrupt or version-skewed."""
    meta, arrays = _read_verified(path)
    return arrays, meta.get("extra", {})


def _read_verified(path: str):
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        if "meta" not in arrays:
            raise ValueError("missing meta record")
        meta = json.loads(bytes(arrays.pop("meta")).decode())
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointError(
            f"corrupt or truncated checkpoint {path!r} "
            f"({type(e).__name__}: {e})") from e
    if meta.get("version") != _FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint {path!r} has format version "
            f"{meta.get('version')!r}, this build reads {_FORMAT_VERSION}")
    want = meta.get("crc32")
    if want is not None and _payload_crc(arrays) != want:
        raise CheckpointError(
            f"checkpoint {path!r} failed its CRC32 integrity check (torn "
            f"write or bit rot)")
    return meta, arrays


def _unflatten(like, leaves: List[np.ndarray]):
    """Rebuild ``like``'s structure (dicts by sorted key, tuples and
    NamedTuples in order) from its leaves in flatten order, each leaf a
    tensor with the dtype and device of the leaf it replaces."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        if isinstance(t, list):
            return [build(v) for v in t]
        a = next(it)
        if tuple(a.shape) != tuple(t.shape):
            raise CheckpointError(f"checkpoint leaf shape {a.shape}, "
                                  f"expected {tuple(t.shape)}")
        return torch.as_tensor(a).to(device=t.device, dtype=t.dtype)

    return build(like)


def _leaf_arrays(arrays: Dict[str, np.ndarray], prefix: str,
                 count: int, path: str) -> List[np.ndarray]:
    n = sum(1 for k in arrays if k.startswith(prefix))
    if n != count:
        raise CheckpointError(f"checkpoint {path!r} holds {n} "
                              f"{prefix}* leaves, expected {count}")
    return [arrays[f"{prefix}leaf_{i}"] for i in range(count)]


def load(path: str, params_like, opt_state_like):
    """Full restore into the structure, dtypes and devices of
    ``params_like`` and ``opt_state_like``: returns ``(params, opt_state,
    epoch, alpha, extra)``."""
    meta, arrays = _read_verified(path)
    params = _unflatten(params_like, _leaf_arrays(
        arrays, "p_", len(_leaves(params_like)), path))
    opt_state = _unflatten(opt_state_like, _leaf_arrays(
        arrays, "o_", len(_leaves(opt_state_like)), path))
    return params, opt_state, meta["epoch"], meta["alpha"], meta["extra"]


def load_params(path: str, params_like: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """Params-only restore into the keys, dtypes and devices of
    ``params_like`` (the optimizer arrays are verified, not kept)."""
    _, arrays = _read_verified(path)
    keys = sorted(params_like)
    n = sum(1 for k in arrays if k.startswith("p_"))
    if n != len(keys):
        raise CheckpointError(f"checkpoint {path!r} holds {n} param "
                              f"leaves, the model has {len(keys)}")
    out = {}
    for i, k in enumerate(keys):
        a = arrays[f"p_leaf_{i}"]
        like = params_like[k]
        if tuple(a.shape) != tuple(like.shape):
            raise CheckpointError(f"param {k!r}: checkpoint shape "
                                  f"{a.shape}, model shape "
                                  f"{tuple(like.shape)}")
        out[k] = torch.as_tensor(a).to(device=like.device, dtype=like.dtype)
    return out


def params_from_jax(np_params: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """Carry a JAX param dict (already pulled to numpy) onto ``device``."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in np_params.items()}


def opt_state_from_jax(np_state, device):
    """Carry a JAX ``AdamState(m, v, t)`` (already pulled to numpy) onto
    ``device`` as the port's AdamState."""
    m, v, t = np_state
    return AdamState(params_from_jax(m, device), params_from_jax(v, device),
                     torch.tensor(np.asarray(t, np.int32), device=device))
