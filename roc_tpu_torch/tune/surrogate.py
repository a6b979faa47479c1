"""Trial pricing: the analytic launch model, the seeded CI surrogate, and
the card's timing path (roc_tpu/tune/surrogate.py retargeted).

Three layers, one formula:

* ``analytic_seconds`` prices one launch on the card from the CSR's
  counts: the bytes its gathers move (each edge reads the source row's
  packs) over the rate ``byte_s`` (seconds a byte, ``obs/roofline.py``'s
  ``PEAK_BW`` by default), divided by the launch's lane use (``packs /
  (lanes x packs a lane x passes)``: a lane that owns no real pack still
  waits on its group's edges), plus a per-row term ``row_s`` for each
  lane group a row claims (its share of a warp, ``lanes / 32``, each
  pass).  The rates are parameters, never read from a table, so a
  measured table cannot leak into the CI sweep's arithmetic, and
  ``refit.py`` solves the inverse problem on the same columns.
  ``knob_factors`` holds the documented priors of what the columns do not
  see (edges in flight, a GAT lane's register load).

* ``surrogate_seconds`` is the CI pseudo-measurement: the analytic time
  times ``(1 + eps)`` with eps drawn from sha256 over (seed, salt,
  candidate label), byte for byte roc_tpu's (``noise_eps``), so the draw
  is independent of PYTHONHASHSEED and identical across processes and
  packages.

* ``measure_seconds`` times the real kernel on the card with CUDA events
  (warm-up outside the timed region, the median of ``reps``).  On any
  other device it raises SystemExit: CPU timings are not kernel rates
  (roc_tpu's refusal contract).

No TPU constant carries over (roc_tpu's ``_CHUNK_OVERHEAD_S``,
``_SLOT_DMA_S``, ``_MXU_EFF_FLOPS`` are the TPU's).  The CI rates below
are priors, not measurements: ``byte_s`` is the card's HBM data-sheet
rate, ``row_s`` an assumed 2 ns a warp-row; ``python -m roc_tpu_torch.tune
--device --refit`` measures both.
"""

from __future__ import annotations

import hashlib
import statistics
from typing import NamedTuple

import numpy as np

from roc_tpu_torch.obs.roofline import PEAK_BW

#: The generating rates, by refit-able name: what the CI surrogate
#: manufactures its timings from, so the refit acceptance test closes the
#: loop (sweep -> records -> refit -> these).
CONSTANTS = {"byte_s": 1.0 / PEAK_BW, "row_s": 2.0e-9}

#: Surrogate noise half-width (fractional).
NOISE = 0.02

#: Edges-in-flight priors on the byte term: one edge in flight leaves a
#: lane's loads unoverlapped (+5 %); four measured slower than two over the
#: transposed CSR (2.02 against 1.83 ms at H = 256, csrc/gather_tile.cuh's
#: kRowEdges note), so a modest +2 %.  The card's trials decide.
EDGE_PRIOR = {1: 1.05, 2: 1.0, 4: 1.02}
#: GAT forward prior: each pack a lane owns beyond the first holds
#: VEC + 1 more registers, fewer groups stay resident (+2 % a pack).
GAT_PACK_PRIOR = 0.02


class CsrStats(NamedTuple):
    """The counts a launch is priced from: rows summed, edges gathered."""
    rows: int
    edges: int


def columns(cfg, stats: CsrStats) -> tuple:
    """(byte column, row column) of one launch: the gathered bytes over the
    lane use, and the lane-group rows over a warp (each pass)."""
    g = cfg.geometry()
    use = g["packs"] / (g["lanes"] * g["ppl"] * g["passes"])
    row_bytes = g["packs"] * g["vec"] * g["itemsize"]
    return (stats.edges * row_bytes / use,
            stats.rows * g["passes"] * g["lanes"] / 32.0)


def knob_factors(cfg) -> tuple:
    """(row_factor, byte_factor) priors of a candidate (see EDGE_PRIOR and
    GAT_PACK_PRIOR).  Refit calibrates on knob-default sum trials only,
    so the priors never contaminate the recovered rates."""
    if cfg.kernel == "sum":
        return 1.0, EDGE_PRIOR[cfg.launch[1]]
    return 1.0, 1.0 + GAT_PACK_PRIOR * (cfg.launch[1] - 1)


def default_knobs(cfg) -> bool:
    """True for the candidates refit may solve from: sum launches at the
    default edges in flight."""
    return cfg.kernel == "sum" and cfg.launch[1] == 2


def analytic_seconds(cfg, stats: CsrStats,
                     byte_s: float = CONSTANTS["byte_s"],
                     row_s: float = CONSTANTS["row_s"]) -> float:
    """One launch at this configuration, the rates as parameters: the
    columns (the element width and bytes an element come with the
    candidate's kernel, width and precision) times the rates and the
    priors."""
    bcol, rcol = columns(cfg, stats)
    rf, bf = knob_factors(cfg)
    return bcol * byte_s * bf + rcol * row_s * rf


def noise_eps(seed: int, salt: str, label: str,
              width: float = NOISE) -> float:
    """Deterministic noise draw in [-width, +width]: sha256 over the
    (seed, salt, candidate) triple — PYTHONHASHSEED-independent, stable
    across platforms and processes, the root of the byte-identical
    tuned.json pin."""
    h = hashlib.sha256(f"{seed}|{salt}|{label}".encode()).digest()
    u = int.from_bytes(h[:8], "big") / float(1 << 64)
    return (2.0 * u - 1.0) * width


def surrogate_seconds(modeled: float, seed: int, salt: str,
                      label: str) -> float:
    """The CI pseudo-measurement for one trial."""
    return modeled * (1.0 + noise_eps(seed, salt, label))


class DeviceBench:
    """One graph direction's CSR on the card and the trial inputs of each
    width, made once and reused by every trial (seeded, Gaussian)."""

    def __init__(self, edge_src, edge_dst, num_rows: int, table_rows: int,
                 device, seed: int = 0):
        import torch
        from roc_tpu_torch.graph.csr import from_edges
        if num_rows != table_rows:
            raise ValueError("the card's trials take a square graph "
                             f"({num_rows} rows, {table_rows} table rows)")
        self.device = torch.device(device)
        g = from_edges(num_rows, np.asarray(edge_src), np.asarray(edge_dst))
        self.row_ptr = torch.as_tensor(g.row_ptr, device=self.device)
        self.col_idx = torch.as_tensor(g.col_idx, device=self.device)
        self.rows, self.table_rows = num_rows, table_rows
        self.seed = seed
        self._inputs: dict = {}

    def inputs(self, cfg) -> tuple:
        import torch
        if cfg.shape not in self._inputs:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            h = int(np.prod(cfg.shape))
            x = torch.randn((self.table_rows, h), generator=gen,
                            device=self.device)
            extra = ()
            if cfg.kernel == "gat":
                k = cfg.shape[0]
                extra = (torch.randn((self.table_rows, k), generator=gen,
                                     device=self.device),
                         torch.randn((self.rows, k), generator=gen,
                                     device=self.device))
            self._inputs[cfg.shape] = (x, *extra)
        return self._inputs[cfg.shape]

    def call(self, cfg):
        """One launch of ``cfg``'s kernel at its configuration."""
        from roc_tpu_torch.ops.kernels.aggregate_sum import aggregate_sum
        from roc_tpu_torch.ops.kernels.gat import gat_forward
        if cfg.kernel == "sum":
            (x,) = self.inputs(cfg)
            return aggregate_sum(x, self.row_ptr, self.col_idx,
                                 cfg.precision, cfg.launch)
        x, as_, ad = self.inputs(cfg)
        return gat_forward(x, as_, ad, self.row_ptr, self.col_idx, 0.2,
                           cfg.precision, (tuple(cfg.launch),))


def measure_seconds(cfg, bench: DeviceBench, reps: int = 3,
                    warmup: int = 2) -> float:
    """Time ``cfg`` on the card: ``warmup`` launches outside the timed
    region, then the median of ``reps`` launches, each between a pair of
    CUDA events.  Raises SystemExit off the card."""
    import torch
    if bench is None or bench.device.type != "cuda" or \
            not torch.cuda.is_available():
        raise SystemExit(
            "tune.measure_seconds: refusing to record CPU timings as "
            "kernel rates (the measured-table contract); run the "
            "surrogate sweep instead")
    for _ in range(max(warmup, 1)):
        bench.call(cfg)
    torch.cuda.synchronize(bench.device)
    times = []
    for _ in range(max(reps, 1)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        bench.call(cfg)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e-3)
    return statistics.median(times)
