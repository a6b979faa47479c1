"""Successive-halving search over the launch lattice (roc_tpu/tune/
search.py:161-345, retargeted).

Three stages per (graph direction, variant, kernel, width), each cutting
the field before the per-candidate cost rises:

  stage 0 — SCREEN: price every candidate through the analytic model
    (surrogate.py).  Keep ``screen_keep``.
  stage 1 — TRIAL: one short measurement per survivor: the seeded
    surrogate in CI, a CUDA-event timing of the kernel on the card.  Keep
    ``final_keep``.
  stage 2 — CONFIRM: a longer measurement per finalist (3 averaged draws,
    or the median of 10 launches), and the winner, which replaces the
    default rule only when it beats the default's own confirmation.

:func:`halve` is that search over an abstract candidate list and two
callables (price, measure), so roc_tpu's own lattice and pricing can
drive it (tests/test_torch_tune.py).  Every trial is paired through the
calibration ledger (``obs/ledger.py``) under the models ``tune_trial``,
``tune_confirm`` and ``tune_probe``, keyed by (shape, variant, candidate,
stage).  A PROBE stage rides along (``REFIT_PROBES``): the halving's
survivors cluster, so refit solves its two rates from a designed set of
launches whose byte and row columns move apart (lane counts 8, 16, 32 at
a narrow and a wide row).  Default-rule timings are kept beside each
winner (``default_s``).

The sweep never reads the tuned store: each trial names its launch.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np

from roc_tpu_torch.obs.ledger import content_key, get_ledger
from roc_tpu_torch.tune import store as tstore
from roc_tpu_torch.tune import surrogate as S
from roc_tpu_torch.tune.lattice import (LaunchConfig, candidate_lattice,
                                        default_config)

# The CI shape: one small synthetic graph (roc_tpu's generator and spec
# discipline).  The card's shapes are Reddit's CSR and its transpose
# (``reddit_shapes``).
SHAPES_CI = [("mega_shard_scaled", 1024, 8192, 2)]

# The widths a sweep tunes when the caller names none: the main path's
# (GCN 602-256-41 sums at 256 and 41; GAT 602-64-41 with 4 heads attends
# at 4 x 64 and 1 x 41).
SUM_WIDTHS = (256, 41)
GAT_SHAPES = ((4, 64), (1, 41))


class Shape(NamedTuple):
    name: str
    num_rows: int
    table_rows: int
    edge_src: np.ndarray
    edge_dst: np.ndarray
    transposed: bool = False     # a backward direction: no GAT forward


class TrialRecord(NamedTuple):
    """One measured (or surrogate) trial with the columns refit solves
    from."""
    shape: str
    variant: str
    label: str
    kernel: str
    stage: str           # "trial" | "confirm" | "probe" | "default"
    byte_col: float
    row_col: float
    default_knobs: bool
    modeled_s: float
    trial_s: float


class Halving(NamedTuple):
    """A search's result: the winner, its confirmed and modeled seconds,
    and how many candidates each stage held."""
    winner: object
    confirm_s: float
    modeled_s: float
    screened: int
    survivors: int
    finalists: int


def synth_shape(name: str, num_rows: int, num_edges: int,
                seed: int) -> Shape:
    """Deterministic synthetic graph, roc_tpu's generator: seeded
    default_rng, dst-major stable sort for CSR order."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_rows, size=num_edges).astype(np.int64)
    dst = rng.integers(0, num_rows, size=num_edges).astype(np.int64)
    order = np.argsort(dst, kind="stable")
    return Shape(name, num_rows, num_rows, src[order], dst[order])


def direction_shapes(edge_src, edge_dst, num_rows: int,
                     table_rows: int) -> list:
    """The CSR's direction and its transpose, the roles swapped as
    roc_tpu swaps them (search.py:336-337), so each direction's graph key
    is roc_tpu's; the transpose's CSR (``from_edges`` of the swapped list,
    a stable sort) is ``graph.csr.Csr.transpose``'s."""
    es = np.ascontiguousarray(edge_src, np.int64)
    ed = np.ascontiguousarray(edge_dst, np.int64)
    return [Shape("fwd", num_rows, table_rows, es, ed),
            Shape("bwd", table_rows, num_rows, ed, es, True)]


def reddit_shapes(seed: int = 0) -> list:
    """Reddit's CSR and its transpose (``graph.datasets``' synthetic
    Reddit, 232,965 nodes, 23,526,073 edges)."""
    from roc_tpu_torch.graph import datasets
    g = datasets.get("reddit", seed=seed).graph
    return direction_shapes(g.col_idx, g.dst_idx, g.num_nodes, g.num_nodes)


#: Refit's designed experiment: default-edge sum launches whose columns
#: move apart.  At H = 256 the lane counts 32 and 16 gather the same bytes
#: over half the rows; at H = 41 (6 bf16 packs) 8, 16, 32 lanes gather
#: 4/3, 8/3 and 16/3 the row's bytes.  Only those the lattice admits at
#: the sweep's precision run.
REFIT_PROBES = ((256, 32), (256, 16), (41, 8), (41, 16), (41, 32))


def refit_probes(precision: str) -> list:
    """The probe LaunchConfigs that are admissible at ``precision``."""
    out = []
    for h, lanes in REFIT_PROBES:
        cfg = LaunchConfig("sum", (h,), precision, (lanes, 2))
        if cfg in candidate_lattice("sum", (h,), precision):
            out.append(cfg)
    return out


def halve(cands, price: Callable, measure: Callable, screen_keep: int = 16,
          final_keep: int = 4, label: Callable = lambda c: c.label,
          on_trial: Optional[Callable] = None) -> Optional[Halving]:
    """Successive halving over ``cands``: ``price(c)`` the screen's
    seconds (an infinite price drops c), ``measure(c, modeled, stage)``
    the trial's ("trial", then "confirm").  Ties break by list position in
    the screen and by ``label`` after.  ``on_trial(stage, c, modeled,
    measured)`` sees each measurement.  None when nothing is priced."""
    scored = []
    for i, c in enumerate(cands):
        t = price(c)
        if math.isfinite(t):
            scored.append((t, i, c))
    scored.sort(key=lambda r: (r[0], r[1]))
    survivors = scored[:screen_keep]
    if not survivors:
        return None
    tried = []
    for t_model, _, c in survivors:
        t = measure(c, t_model, "trial")
        if on_trial is not None:
            on_trial("trial", c, t_model, t)
        tried.append((t, t_model, c))
    tried.sort(key=lambda r: (r[0], label(r[2])))
    finalists = tried[:final_keep]
    confirmed = []
    for _, t_model, c in finalists:
        t = measure(c, t_model, "confirm")
        if on_trial is not None:
            on_trial("confirm", c, t_model, t)
        confirmed.append((t, t_model, c))
    confirmed.sort(key=lambda r: (r[0], label(r[2])))
    t_win, t_win_model, win = confirmed[0]
    return Halving(win, t_win, t_win_model, len(cands), len(survivors),
                   len(finalists))


def surrogate_measure(seed: int) -> Callable:
    """The CI measurement: roc_tpu's surrogate draws, averaged over 3 for
    the confirm stage and 96 for the probes (search.py:161-180)."""
    def measure(cfg, modeled: float, stage: str) -> float:
        draws = {"confirm": 3, "probe": 96}.get(stage, 1)
        label = cfg.label if hasattr(cfg, "label") else str(cfg)
        if draws == 1:
            return S.surrogate_seconds(modeled, seed, stage, label)
        return sum(S.surrogate_seconds(modeled, seed, f"{stage}{i}", label)
                   for i in range(draws)) / draws
    return measure


def device_measure(bench: S.DeviceBench) -> Callable:
    """The card's measurement: the median of 3 launches for a trial, of 10
    for a confirmation, a probe or the default rule (a sub-millisecond
    launch's median of 5 moved by up to 15 % between two readings of one
    launch on an H100)."""
    def measure(cfg, modeled: float, stage: str) -> float:
        return S.measure_seconds(cfg, bench, reps=3 if stage == "trial"
                                 else 10)
    return measure


def _trial_key(shape: Shape, variant: str, label: str, stage: str) -> str:
    return content_key(shape=shape.name, rows=shape.num_rows,
                       edges=len(shape.edge_src), variant=variant,
                       cand=label, stage=stage)


def _tasks(shape: Shape, sum_widths, gat_shapes) -> list:
    tasks = [("sum", (int(h),)) for h in sum_widths]
    if not shape.transposed:
        tasks += [("gat", (int(k), int(f))) for k, f in gat_shapes]
    return tasks


def sweep(shapes, storage_dtype: str = "bf16", fuse_linear: bool = False,
          seed: int = 0, device: bool = False, screen_keep: int = 16,
          final_keep: int = 4, sum_widths=SUM_WIDTHS, gat_shapes=GAT_SHAPES,
          watchdog=None, log=None, cuda_device=None):
    """Run the three-stage search over ``shapes`` (Shape tuples or
    (name, rows, edges, seed) specs) for every sum width and, over a
    forward direction, every GAT (K, F).  ``storage_dtype`` names the
    variant: "bf16" is fast (the staged bf16 plane), "fp32" exact.
    Returns (entries, trials): a store.py-shaped ``entries`` dict of
    winners and the TrialRecords.  Deterministic for device=False (no
    clocks, no unseeded randomness, sorted candidates)."""
    led = get_ledger()
    precision = tstore.precision_of(storage_dtype)
    vkey = tstore.variant_key(storage_dtype, fuse_linear)
    emit = log or (lambda *_: None)
    entries: dict = {}
    trials: list = []
    for spec in shapes:
        shape = spec if isinstance(spec, Shape) else synth_shape(*spec)
        if len(shape.edge_src) == 0:
            continue
        stats = S.CsrStats(shape.num_rows, len(shape.edge_src))
        if device:
            bench = S.DeviceBench(shape.edge_src, shape.edge_dst,
                                  shape.num_rows, shape.table_rows,
                                  cuda_device or "cuda", seed)
            measure = device_measure(bench)
        else:
            measure = surrogate_measure(seed)
        source = "device" if device else "surrogate"

        def record(stage, cfg, t_model, t, model=None):
            key = _trial_key(shape, vkey, cfg.label, stage)
            bcol, rcol = S.columns(cfg, stats)
            m = model or f"tune_{'confirm' if stage == 'default' else stage}"
            led.predict(m, key, t_model, "s")
            led.measure(m, key, t, "s", stage=stage, kernel=cfg.kernel,
                        byte_col=bcol, row_col=rcol, variant=vkey,
                        shape=shape.name,
                        default_knobs=S.default_knobs(cfg))
            trials.append(TrialRecord(shape.name, vkey, cfg.label,
                                      cfg.kernel, stage, bcol, rcol,
                                      S.default_knobs(cfg), t_model, t))

        found = entries.setdefault(
            tstore.graph_key(shape.edge_src, shape.edge_dst, shape.num_rows,
                             shape.table_rows), {}).setdefault(vkey, {})
        for kernel, dims in _tasks(shape, sum_widths, gat_shapes):
            cands = candidate_lattice(kernel, dims, precision)
            res = halve(cands, lambda c: S.analytic_seconds(c, stats),
                        measure, screen_keep, final_keep, on_trial=record)
            if res is None:
                continue
            # the default rule, measured as the finalists were; a candidate
            # replaces it only by beating it there
            base = default_config(kernel, dims, precision)
            t_model = S.analytic_seconds(base, stats)
            t_base = measure(base, t_model, "confirm")
            record("default", base, t_model, t_base)
            win, t_win, t_win_model = res.winner, res.confirm_s, res.modeled_s
            if not t_win < t_base:
                win, t_win, t_win_model = base, t_base, t_model
            emit(f"{shape.name}/{vkey}: {win.key} screened {res.screened} "
                 f"-> {res.survivors} -> {res.finalists}; winner "
                 f"{win.label} ({t_win * 1e3:.3f} ms confirmed, "
                 f"{t_win_model * 1e3:.3f} ms modeled; default "
                 f"{base.label} {t_base * 1e3:.3f} ms)")
            found[win.key] = {
                "launch": [int(v) for v in win.launch],
                "label": win.label,
                "modeled_s": float(t_win_model),
                "trial_s": float(t_win),
                "default_s": float(t_base),
                "source": source}
        if not fuse_linear:
            for cfg in refit_probes(precision):
                t_model = S.analytic_seconds(cfg, stats)
                record("probe", cfg, t_model, measure(cfg, t_model, "probe"))
    if watchdog is not None:
        for model, ratio in led.drain_ratios():
            watchdog.observe_calibration(model, ratio)
    return entries, trials


def autotune_graph(edge_src, edge_dst, num_rows: int, table_rows: int,
                   storage_dtype: str = "bf16", fuse_linear: bool = False,
                   seed: int = 0, device: bool = False, path: str = "",
                   sum_widths=SUM_WIDTHS, gat_shapes=GAT_SHAPES,
                   watchdog=None, log=None, cuda_device=None, records=None):
    """Tune one real graph in both directions (the backward sums over the
    transpose) and merge the winners into the tuned store, where the next
    ``DeviceCsr`` placement of this graph takes them.  Returns the graph's
    ``ops.aggregate.LaunchTable`` from the store, or None when nothing was
    written (an empty graph, or the store turned off).  ``records``, a
    list, receives the sweep's TrialRecords (for refit)."""
    if len(edge_src) == 0:
        return None
    shapes = direction_shapes(edge_src, edge_dst, num_rows, table_rows)
    entries, trials = sweep(shapes, storage_dtype=storage_dtype,
                            fuse_linear=fuse_linear, seed=seed,
                            device=device, sum_widths=sum_widths,
                            gat_shapes=gat_shapes, watchdog=watchdog,
                            log=log, cuda_device=cuda_device)
    if records is not None:
        records.extend(trials)
    p = path or tstore.tuned_store_path()
    if not p:
        return None
    tstore.merge_entries(p, entries, interpret=not device, seed=seed)
    return tstore.launch_table(edge_src, edge_dst, num_rows, table_rows,
                               storage_dtype, fuse_linear, path=p)
