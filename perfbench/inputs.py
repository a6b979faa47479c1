"""The benchmark's inputs, made from ``--seed``: the graph, the features,
labels and split, the initial weights, the query schedule and the edge
deltas.

The graph follows the model of the port's synthetic generator (class
blocks, ``p_intra`` of the random edges inside the source's class, the
rest uniform, symmetrised, self loops dropped and one self edge added per
node), drawn here with ``torch`` on the run's device in a few large calls.
It is a frozen copy of that model, not of its draws: the same seed gives
the same graph here on every run, and the port never sees the seed.

``make(spec, seed, device)`` returns an :class:`Inputs` of device tensors;
:func:`for_port` hands the port what its public constructors take.  The traffic (query schedule, delta batches) is drawn on the host
from the same seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# roc_tpu's mask codes (the reference's .mask format)
MASK_TRAIN, MASK_VAL, MASK_TEST, MASK_NONE = 0, 1, 2, 3


@dataclasses.dataclass
class Inputs:
    num_nodes: int
    row_ptr: torch.Tensor     # [N+1] int64, in-edge CSR
    col_idx: torch.Tensor     # [E] int32, sources in row order
    features: torch.Tensor    # [N, F] float32
    label_ids: torch.Tensor   # [N] int64
    mask: torch.Tensor        # [N] int32
    weights: Dict[str, torch.Tensor]

    @property
    def num_edges(self) -> int:
        return int(self.col_idx.numel())


def _generator(seed: int, device, stream: int) -> torch.Generator:
    """One generator a stream of draws, so adding a draw to one stream
    never moves another's."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def make_graph(gspec: dict, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """(row_ptr int64 [N+1], col_idx int32 [E], label_ids int64 [N])."""
    n = int(gspec["num_nodes"])
    classes = int(gspec["num_classes"])
    g = _generator(seed, device, 1)
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    r = int(n * float(gspec["avg_degree"]))
    src = torch.randint(0, n, (r,), generator=g, device=device)
    dst = torch.randint(0, n, (r,), generator=g, device=device)
    intra = torch.rand(r, generator=g, device=device) < float(
        gspec["p_intra"])
    # a same-class partner: nodes ordered by class, a position drawn inside
    # the source's class segment
    order = torch.argsort(labels, stable=True)
    count = torch.bincount(labels, minlength=classes)
    start = torch.cumsum(count, 0) - count
    cls = labels[src]
    pos = start[cls] + (torch.rand(r, generator=g, device=device)
                        * count[cls]).long()
    dst = torch.where(intra, order[pos.clamp_max(n - 1)], dst)
    s = torch.cat([src, dst])
    d = torch.cat([dst, src])
    keep = s != d
    loops = torch.arange(n, device=device)
    s = torch.cat([s[keep], loops])
    d = torch.cat([d[keep], loops])
    del src, dst, intra, pos, cls, keep
    perm = torch.argsort(d, stable=True)
    col_idx = s[perm].to(torch.int32)
    deg = torch.bincount(d, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=row_ptr[1:])
    return row_ptr, col_idx, labels


def make_features(gspec: dict, labels: torch.Tensor, seed: int, device):
    """A class mean plus unit Gaussian noise, float32 [N, F]."""
    n, f = labels.numel(), int(gspec["in_dim"])
    g = _generator(seed, device, 2)
    means = torch.randn(int(gspec["num_classes"]), f, generator=g,
                        device=device)
    x = torch.randn(n, f, generator=g, device=device)
    x.add_(means[labels], alpha=float(gspec["feature_snr"]))
    return x


def make_mask(gspec: dict, seed: int, device) -> torch.Tensor:
    n = int(gspec["num_nodes"])
    g = _generator(seed, device, 3)
    perm = torch.randperm(n, generator=g, device=device)
    mask = torch.full((n,), MASK_NONE, dtype=torch.int32, device=device)
    a = int(gspec["n_train"])
    b = a + int(gspec["n_val"])
    c = b + int(gspec["n_test"])
    mask[perm[:a]] = MASK_TRAIN
    mask[perm[a:b]] = MASK_VAL
    mask[perm[b:c]] = MASK_TEST
    return mask


def weight_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    """(leaf name, shape, Glorot fan-in, fan-out) of each leaf in draw
    order, in the port's leaf names: the ``leaves`` of the model module
    the configuration names under ``reference``."""
    from perfbench.reference import model_module
    return model_module(cfg).leaves(cfg)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Glorot-uniform leaves, float32, from one draw on the device."""
    shapes = weight_shapes(cfg)
    total = sum(math.prod(s) for _, s, _, _ in shapes)
    g = _generator(seed, device, 4)
    flat = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape, fan_in, fan_out in shapes:
        n = math.prod(shape)
        scale = math.sqrt(6.0 / (fan_in + fan_out))
        out[name] = (flat[off:off + n] * scale).reshape(shape).contiguous()
        off += n
    return out


def make(cfg: dict, seed: int, device) -> Inputs:
    gspec = cfg["graph"]
    row_ptr, col_idx, labels = make_graph(gspec, seed, device)
    x = make_features(gspec, labels, seed, device)
    mask = make_mask(gspec, seed, device)
    return Inputs(int(gspec["num_nodes"]), row_ptr, col_idx, x, labels,
                  mask, make_weights(cfg, seed, device))


def for_port(cfg: dict, seed: int, device):
    """The seed's inputs as the port's public constructors take them: a
    ``Dataset`` over a host ``Csr``, and the weights on ``device``.  The
    benchmark's own device copies are freed."""
    from roc_tpu_torch.graph.csr import Csr
    from roc_tpu_torch.graph.datasets import Dataset
    inp = make(cfg, seed, device)
    g = cfg["graph"]
    ds = Dataset("perfbench",
                 Csr(inp.num_nodes, inp.num_edges, inp.row_ptr.cpu().numpy(),
                     inp.col_idx.cpu().numpy()),
                 inp.features.cpu().numpy(), None,
                 inp.label_ids.cpu().numpy(), inp.mask.cpu().numpy(),
                 int(g["in_dim"]), int(g["num_classes"]))
    weights = {k: v.clone() for k, v in inp.weights.items()}
    del inp
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return ds, weights


# -- traffic ------------------------------------------------------------------

def query_schedule(traffic: dict, seed: int, stream: int, seconds: float,
                   num_nodes: int) -> List[Tuple[float, np.ndarray]]:
    """Open-loop queries over ``seconds``: (due offset in s, node ids).
    Every seed gets the same ``ceil(qps * seconds)`` queries with the same
    multiset of gaps (the quantiles of an exponential at the cell's rate,
    scaled to fill the window) and of sizes (each of ``sizes`` equally
    often), in its own order; the ids are uniform over the nodes."""
    rate = float(traffic["qps"])
    n = int(math.ceil(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    sizes = np.resize(np.asarray(traffic["sizes"], np.int64), n)
    rng = np.random.default_rng([int(seed), int(stream)])
    gaps = gaps[rng.permutation(n)]
    sizes = sizes[rng.permutation(n)]
    due = np.cumsum(gaps) - gaps
    ids = rng.integers(0, num_nodes, int(sizes.sum())).astype(np.int32)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [(float(due[i]), ids[bounds[i]:bounds[i + 1]])
            for i in range(n)]


def delta_batches(traffic: dict, seed: int, count: int, row_ptr: np.ndarray,
                  col_idx: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``count`` batches of ``adds`` new (src, dst) pairs and ``retires``
    retirements: up to half of each batch's retires take live adds of
    earlier batches, the rest base edges drawn at random.  Self edges are
    never added or retired, so every node keeps its in-degree >= 1."""
    d = traffic["deltas"]
    n_add, n_ret = int(d["adds"]), int(d["retires"])
    n = row_ptr.size - 1
    rng = np.random.default_rng([int(seed), 13])
    live_adds: list = []
    out = []
    for _ in range(count):
        adds = rng.integers(0, n, (n_add, 2))
        same = adds[:, 0] == adds[:, 1]
        adds[same, 1] = (adds[same, 1] + 1) % n
        take = min(n_ret // 2, len(live_adds))
        earlier = [live_adds.pop(int(rng.integers(0, len(live_adds))))
                   for _ in range(take)]
        rets = list(earlier)
        while len(rets) < n_ret:
            e = int(rng.integers(0, col_idx.size))
            dst = int(np.searchsorted(row_ptr, e, side="right") - 1)
            src = int(col_idx[e])
            if src != dst:
                rets.append((src, dst))
        live_adds.extend(map(tuple, adds.tolist()))
        out.append((adds.astype(np.int64),
                    np.asarray(rets, np.int64).reshape(-1, 2)))
    return out
