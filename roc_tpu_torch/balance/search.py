"""Min-max repartition search over the contiguous-cut space
(roc_tpu/balance/search.py, NumPy, element for element; ``halo_counts``
finds roc_tpu's counts by another route, below).

The reference's repartitioner keeps ROC's key structural simplification:
parts stay *contiguous vertex ranges*, so a cut is just P-1 boundaries and
the search space is tiny compared to general graph partitioning.  Given the
fitted cost model (cost_model.py) this module finds boundaries minimizing
the predicted **max**-part time — the quantity that is the SPMD step time —
in three stages:

  1. **Parametric packing.**  With halo terms ignored, part cost is a
     monotone prefix difference ``w_n * nodes + w_e * edges + w_c``, so
     "does a cut with max cost <= T exist?" is answerable by greedy packing
     with a searchsorted per part.  Binary search on T gives the optimal
     halo-free min-max cut in O((P log N) log(1/eps)).
  2. **DP refinement.**  Exact min-max DP over per-boundary candidate
     windows around stage 1's boundaries (halo-free cost, but exact rather
     than parametric-greedy, and it re-levels the tail parts).
  3. **Halo-aware greedy shifting.**  Recompute true halo-in/out counts for
     the full cut, then move the argmax part's boundaries in _NODE_ALIGN
     steps while the *predicted* max (now including halo terms) drops.

Feasibility throughout honors the frozen padded shard shape: every part
must fit ``shard_nodes - 1`` live nodes (>=1 pad row) and ``shard_edges``
live edges, so the proposal can be applied under the same static S/E
(graph/partition.py compute_meta overrides).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from roc_tpu_torch.graph.partition import _NODE_ALIGN, bounds_from_row_ptr

# Stage-2 window half-width (vertices) around each stage-1 boundary.
_DP_WINDOW = 48
# Stage-3 shifting: max passes and initial step (vertices, align multiple).
_SHIFT_ROUNDS = 24


def part_sizes(row_ptr: np.ndarray, bounds: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(nodes [P], edges [P]) live counts for an inclusive-bounds cut."""
    bounds = np.asarray(bounds, dtype=np.int64)
    nodes = np.maximum(bounds[:, 1] - bounds[:, 0] + 1, 0)
    lo = np.maximum(bounds[:, 0], 0)
    edges = np.where(nodes > 0, row_ptr[bounds[:, 1] + 1] - row_ptr[lo], 0)
    return nodes.astype(np.int64), edges.astype(np.int64)


def halo_counts(row_ptr: np.ndarray, col_idx: np.ndarray,
                bounds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact halo row counts per part for a contiguous cut.

    halo_in[p]  = #distinct remote source vertices part p's edges read
    halo_out[p] = #(part q != p) pairs for which a vertex of p is a distinct
                  remote source — i.e. rows p sends, counted per receiver
                  (matches HaloMaps' send_idx volume, parallel/halo.py).

    roc_tpu sorts every (source, destination part) pair (one O(E log E)
    ``np.unique``); here a mark over the vertices per part finds the same
    distinct pairs in O(P*N + E), and the owner lookup is roc_tpu's
    searchsorted: the same counts, element for element.  The search
    (``_halo_shift``) recounts a whole cut per candidate move.
    """
    bounds = np.asarray(bounds, dtype=np.int64)
    P = len(bounds)
    n = len(row_ptr) - 1
    nodes, _ = part_sizes(row_ptr, bounds)
    owner = np.searchsorted(bounds[:, 1], np.arange(n), side="left")
    halo_in = np.zeros(P, np.int64)
    halo_out = np.zeros(P, np.int64)
    mark = np.zeros(n, dtype=bool)
    for p, ((lo, hi), k) in enumerate(zip(bounds, nodes)):
        if k == 0:
            continue
        mark[:] = False
        mark[col_idx[row_ptr[lo]: row_ptr[hi + 1]]] = True
        own = owner[np.flatnonzero(mark)]
        remote = own[own != p]
        halo_in[p] = remote.size
        halo_out += np.bincount(remote, minlength=P)
    return halo_in, halo_out


def part_features(row_ptr: np.ndarray, col_idx: Optional[np.ndarray],
                  bounds: np.ndarray) -> np.ndarray:
    """[P, 5] design rows (nodes, edges, halo_in, halo_out, 1) for a cut.
    ``col_idx=None`` skips the halo pass (zeros) for halo-free costing."""
    bounds = np.asarray(bounds, dtype=np.int64)
    P = len(bounds)
    nodes, edges = part_sizes(row_ptr, bounds)
    if col_idx is not None:
        halo_in, halo_out = halo_counts(row_ptr, col_idx, bounds)
    else:
        halo_in = halo_out = np.zeros(P, np.int64)
    return np.stack([nodes, edges, halo_in, halo_out,
                     np.ones(P, np.int64)], axis=1).astype(np.float64)


def _pack(comb: np.ndarray, caps_hi: np.ndarray, num_parts: int,
          T: float, w_const: float) -> Optional[List[int]]:
    """Greedy packing: largest feasible part ending under cost T.

    ``comb[i]`` is the monotone prefix cost of vertices [0, i);
    ``caps_hi[i]`` the largest end index (exclusive) allowed for a part
    starting at i by the shard-shape caps.  Returns exclusive boundary
    list [b_1..b_P] with b_P = N, or None if T is infeasible.
    """
    n = len(comb) - 1
    ends = []
    lo = 0
    for _ in range(num_parts):
        # largest e with comb[e] <= comb[lo] + (T - w_const), e <= caps_hi[lo]
        budget = comb[lo] + max(T - w_const, 0.0)
        e = int(np.searchsorted(comb, budget, side="right")) - 1
        e = min(e, int(caps_hi[lo]))
        if e <= lo:
            return None  # even a single vertex busts T or the caps
        ends.append(e)
        lo = e
        if lo >= n:
            break
    if lo < n:
        return None
    while len(ends) < num_parts:  # empty trailing parts
        ends.append(n)
    return ends


def _ends_to_bounds(ends: List[int], num_nodes: int) -> np.ndarray:
    """Exclusive end indices -> inclusive (lo, hi) rows.  Empty parts are
    emitted at the END in the canonical (num_nodes, num_nodes - 1) encoding
    so bounds[:, 1] stays nondecreasing — the invariant to_padded's and
    halo_counts' searchsorted owner lookups rely on."""
    bounds = []
    lo = 0
    for e in ends:
        if e > lo:
            bounds.append((lo, e - 1))
            lo = e
    while len(bounds) < len(ends):
        bounds.append((num_nodes, num_nodes - 1))
    return np.asarray(bounds, dtype=np.int64)


def _caps_hi(row_ptr: np.ndarray, max_nodes: int, max_edges: int
             ) -> np.ndarray:
    """caps_hi[i]: largest exclusive end for a part starting at vertex i
    under the live-node and live-edge caps."""
    n = len(row_ptr) - 1
    idx = np.arange(n + 1, dtype=np.int64)
    by_nodes = np.minimum(idx + max_nodes, n)
    by_edges = np.searchsorted(row_ptr, row_ptr + max_edges, side="right") - 1
    return np.minimum(by_nodes, np.maximum(by_edges, idx))


def _parametric_cut(row_ptr: np.ndarray, num_parts: int, w: np.ndarray,
                    caps_hi: np.ndarray) -> Optional[List[int]]:
    """Stage 1: binary search on max part cost T with greedy packing."""
    n = len(row_ptr) - 1
    comb = w[0] * np.arange(n + 1, dtype=np.float64) \
        + w[1] * row_ptr.astype(np.float64)
    w_const = float(w[4])
    lo_T = (comb[-1] - comb[0]) / num_parts + w_const
    hi_T = comb[-1] - comb[0] + w_const
    best = _pack(comb, caps_hi, num_parts, hi_T, w_const)
    if best is None:
        return None  # caps infeasible even with one giant budget
    for _ in range(48):
        mid = 0.5 * (lo_T + hi_T)
        ends = _pack(comb, caps_hi, num_parts, mid, w_const)
        if ends is None:
            lo_T = mid
        else:
            hi_T, best = mid, ends
    return best


def _dp_refine(row_ptr: np.ndarray, num_parts: int, w: np.ndarray,
               caps_hi: np.ndarray, ends: List[int],
               window: int = _DP_WINDOW) -> List[int]:
    """Stage 2: exact min-max DP over boundary windows around ``ends``."""
    n = len(row_ptr) - 1
    comb = w[0] * np.arange(n + 1, dtype=np.float64) \
        + w[1] * row_ptr.astype(np.float64)
    w_const = float(w[4])

    def cost(a: int, b: int) -> float:  # part [a, b)
        if b <= a:
            return 0.0
        if b > caps_hi[a]:
            return np.inf
        return comb[b] - comb[a] + w_const

    # candidate positions per boundary p = 1..P-1 (boundary 0 fixed at 0,
    # boundary P fixed at n)
    cands = [np.array([0])]
    for p in range(num_parts - 1):
        c = np.unique(np.clip(
            np.arange(ends[p] - window, ends[p] + window + 1), 0, n))
        cands.append(c)
    cands.append(np.array([n]))

    INF = np.inf
    dp = [np.full(len(c), INF) for c in cands]
    arg = [np.zeros(len(c), np.int64) for c in cands]
    dp[0][0] = 0.0
    for p in range(1, num_parts + 1):
        prev, cur = cands[p - 1], cands[p]
        for i, b in enumerate(cur):
            best, bj = INF, 0
            for j, a in enumerate(prev):
                if dp[p - 1][j] >= best or a > b:
                    continue
                v = max(dp[p - 1][j], cost(int(a), int(b)))
                if v < best:
                    best, bj = v, j
            dp[p][i], arg[p][i] = best, bj
    if not np.isfinite(dp[num_parts][0]):
        return ends
    out = []
    j = 0
    for p in range(num_parts, 0, -1):
        out.append(int(cands[p][j]))
        j = int(arg[p][j])
    out.reverse()
    return out


def _halo_shift(row_ptr: np.ndarray, col_idx: np.ndarray, num_parts: int,
                model, caps_hi: np.ndarray, ends: List[int],
                rounds: int = _SHIFT_ROUNDS) -> List[int]:
    """Stage 3: greedy boundary shifting under the full (halo-aware) model."""
    n = len(row_ptr) - 1

    def feasible(e: List[int]) -> bool:
        lo = 0
        for b in e:
            if b < lo or (b > lo and b > caps_hi[lo]):
                return False
            lo = b
        return e[-1] == n

    def score(e: List[int]) -> float:
        X = part_features(row_ptr, col_idx, _ends_to_bounds(e, n))
        return float(model.predict(X).max())

    cur = list(ends)
    cur_score = score(cur)
    step = max(_NODE_ALIGN * 4, _NODE_ALIGN)
    for _ in range(rounds):
        improved = False
        X = part_features(row_ptr, col_idx, _ends_to_bounds(cur, n))
        worst = int(np.argmax(model.predict(X)))
        # shrink the worst part from either side (give to the neighbor)
        moves = []
        if worst >= 1:               # move left boundary right... no: raise it
            moves.append((worst - 1, +step))   # boundary b_{worst-1} up
        if worst < num_parts - 1:
            moves.append((worst, -step))       # boundary b_worst down
        for bi, d in moves:
            cand = list(cur)
            cand[bi] = int(np.clip(cand[bi] + d, 0, n))
            if not feasible(cand):
                continue
            s = score(cand)
            if s < cur_score - 1e-15:
                cur, cur_score, improved = cand, s, True
                break
        if not improved:
            if step <= _NODE_ALIGN:
                break
            step = max(step // 2 // _NODE_ALIGN * _NODE_ALIGN, _NODE_ALIGN)
    return cur


def propose_bounds(row_ptr: np.ndarray, col_idx: np.ndarray,
                   num_parts: int, model, max_nodes: int, max_edges: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Full search: returns (bounds [P, 2], predicted per-part times [P]).

    ``max_nodes``/``max_edges`` are the *live* caps implied by the frozen
    shard shape: shard_nodes - 1 and shard_edges.  Returns the static greedy
    feasibility fallback only if the caps reject everything (cannot happen
    when they come from an existing Partition of the same graph).
    """
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n = len(row_ptr) - 1
    w = model.search_weights()
    caps_hi = _caps_hi(row_ptr, int(max_nodes), int(max_edges))
    ends = _parametric_cut(row_ptr, num_parts, w, caps_hi)
    if ends is None:
        bounds = np.asarray(bounds_from_row_ptr(row_ptr, num_parts), np.int64)
        return bounds, model.predict(part_features(row_ptr, col_idx, bounds))
    ends = _dp_refine(row_ptr, num_parts, w, caps_hi, ends)
    if col_idx is not None:
        ends = _halo_shift(row_ptr, col_idx, num_parts, model, caps_hi, ends)
    bounds = _ends_to_bounds(ends, n)
    times = model.predict(part_features(row_ptr, col_idx, bounds))
    return bounds, np.asarray(times, dtype=np.float64)
