"""The autotuner's candidate space: the Hopper kernels' launch parameters
(roc_tpu/tune/lattice.py retargeted).

roc_tpu's lattice crosses binned-plan Geometries (windows, chunk widths,
slots, flat units) with Pallas knobs (DMA size classes, pipeline depth,
mega on/off).  None of that exists on the card: the port's kernels walk a
CSR.  What they fix in code is how a row is spread over lanes, and that is
the space searched here, per kernel, width and precision:

* **the sum** (``csrc/aggregate_sum.cu:launch_sum``): ``lpr``, the lanes a
  row (8, 16 or 32), times ``edges``, the edges a lane group keeps in
  flight (1, 2 or 4).  The packs a lane a pass follow from ``lpr``
  (``packs_per_lane``).  The default rule is ``lanes_per_row`` and
  ``kRowEdges`` = 2.
* **the GAT forward** (``csrc/gat.cu:launch_fwd_group``): the lane group's
  (lanes, packs a lane) pair; the default rule is the first pair of
  ``FWD_GROUPS`` that covers the row.

A candidate is admissible when the library builds it (:func:`sum_built`
mirrors aggregate_sum.cu's instantiations, ``ops.kernels.gat.FWD_PAIRS``
gat.cu's) and it covers a row in no more passes than the default rule: a pass
re-walks the row's edges.  No candidate changes a bit: each lane sums its
packs over the row's edges in CSR order from 0 whatever the lane count and
the unroll, and the GAT forward's maxima take no order.

Not axes: ``ops/kernels/aggregate_sum.py:_CHUNK_TARGET_ELEMS`` sizes the
plain version's edge chunks and never reaches the card.  The megakernel
backward's u gather also keeps ``kRowEdges`` in flight, but its kernels
(``csrc/aggregate_linear.cu``) hold the tile GEMM, whose instantiations
would multiply that library's build; its launch stays fixed, so a
megakernel (``+fuse``) variant tunes the sum and GAT launches its run still
makes.

Everything is generated in sorted order: a candidate's ``label`` is the
surrogate's noise key and the search's tie-breaker, so the lattice's order
is part of the byte-identical tuned-store contract.
"""

from __future__ import annotations

from typing import NamedTuple

from roc_tpu_torch.ops.aggregate import gat_key, sum_key
from roc_tpu_torch.ops.kernels.gat import FWD_GROUPS, FWD_PAIRS

KERNELS = ("sum", "gat")
PRECISIONS = ("fast", "exact")
LANES = (8, 16, 32)
EDGES = (1, 2, 4)
ROW_EDGES = 2          # csrc/gather_tile.cuh:kRowEdges
MAX_PACKS_BF16 = 3     # csrc/gather_tile.cuh:kMaxPacks
MAX_PACKS_F32 = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def lanes_per_row(packs: int) -> int:
    """csrc/gather_tile.cuh:lanes_per_row: the fewest of 8, 16, 32 lanes
    that cover a row's packs in one pass."""
    return 8 if packs <= 8 else 16 if packs <= 16 else 32


def packs_per_lane(packs: int, lanes: int, itemsize: int) -> int:
    """csrc/gather_tile.cuh:packs_per_lane: packs a lane owns a pass, as
    many as the row needs up to 3 bf16 or 4 fp32 packs."""
    big = MAX_PACKS_BF16 if itemsize == 2 else MAX_PACKS_F32
    per = _cdiv(packs, lanes)
    return per if per <= 3 else big


def sum_vec(h: int, precision: str) -> tuple:
    """(elements a pack, bytes an element) of the sum's gather at width
    ``h``: fast sums a staged bf16 plane in 8-element packs; exact reads a
    contiguous x in place, in the widest of 4, 2, 1 floats dividing H
    (``ops/kernels/aggregate_sum.py:_vec_width``)."""
    if precision == "fast":
        return 8, 2
    return next(v for v in (4, 2, 1) if h % v == 0), 4


def sum_built(vec: int, itemsize: int, lpr: int, ppl: int,
              edges: int) -> bool:
    """Whether csrc/aggregate_sum.cu builds the sum at this launch: every
    lpr, packs and edges where it gathers a bf16 plane or 4-float packs,
    the default rule only (one pack a lane below 32 lanes, 2 edges) at 2- and
    1-float packs."""
    tunable = itemsize == 2 or vec == 4
    if lpr not in LANES or edges not in EDGES:
        return False
    if edges != ROW_EDGES and not tunable:
        return False
    if ppl == 1:
        return True
    if not tunable and lpr != 32:
        return False
    return ppl in (2, 3) or (ppl == 4 and itemsize == 4)


def gat_vec(k: int, f: int) -> tuple:
    """(vec, packs a row) of the GAT forward on a contiguous x of K heads of
    F (``ops/kernels/gat.py:forward_geometry``: a single head whose rows are
    not 16-byte aligned is staged to 4-float packs)."""
    vec = next(v for v in (4, 2, 1) if f % v == 0 and (k * f) % v == 0)
    if k == 1 and vec < 4:
        vec = 4
    return vec, _cdiv(k * f, vec)


def _group_of(packs: int, table) -> tuple:
    return next(((n, q) for n, q in table if packs <= n * q), table[-1])


class LaunchConfig(NamedTuple):
    """One candidate: a kernel at one width and precision, and its launch
    pair: the sum's (lanes a row, edges in flight), the GAT forward's
    (lanes, packs a lane)."""
    kernel: str            # "sum" | "gat"
    shape: tuple           # sum: (H,); gat: (K, F)
    precision: str         # "fast" | "exact"
    launch: tuple          # the pair the wrapper passes

    @property
    def label(self) -> str:
        """Stable identity string: the surrogate's noise key and the
        search's tie-breaker, so it must determine the candidate."""
        dims = "x".join(str(int(v)) for v in self.shape)
        a, b = self.launch
        tag = f"l{a}.e{b}" if self.kernel == "sum" else f"g{a}.p{b}"
        return f"{self.kernel}/{dims}/{self.precision}|{tag}"

    @property
    def key(self) -> str:
        """The launch table's key (``ops.aggregate.sum_key``/``gat_key``)."""
        return sum_key(*self.shape) if self.kernel == "sum" else \
            gat_key(*self.shape)

    def geometry(self) -> dict:
        """How the launch covers a row: elements a pack ``vec``, bytes an
        element, packs a row, ``lanes``, packs a lane ``ppl`` and
        ``passes`` over the row."""
        if self.kernel == "sum":
            vec, itemsize = sum_vec(self.shape[0], self.precision)
            packs = _cdiv(self.shape[0], vec)
            lanes, edges = self.launch
            ppl = packs_per_lane(packs, lanes, itemsize)
        else:
            vec, packs = gat_vec(*self.shape)
            itemsize, (lanes, ppl) = 4, self.launch
        return {"vec": vec, "itemsize": itemsize, "packs": packs,
                "lanes": lanes, "ppl": ppl,
                "passes": _cdiv(packs, lanes * ppl)}

    def built(self) -> bool:
        """Whether the library builds this launch (a candidate that is not
        built raises when launched)."""
        if self.kernel == "gat":
            return tuple(self.launch) in FWD_PAIRS[gat_vec(*self.shape)[0]]
        if self.launch[0] not in LANES:
            return False
        g = self.geometry()
        return sum_built(g["vec"], g["itemsize"], g["lanes"], g["ppl"],
                         self.launch[1])


def default_config(kernel: str, shape, precision: str) -> LaunchConfig:
    """The default rule as a candidate."""
    shape = tuple(int(v) for v in shape)
    if kernel == "sum":
        vec, _ = sum_vec(shape[0], precision)
        pair = (lanes_per_row(_cdiv(shape[0], vec)), ROW_EDGES)
    else:
        pair = _group_of(gat_vec(*shape)[1], FWD_GROUPS)
    return LaunchConfig(kernel, shape, precision, pair)


def candidate_lattice(kernel: str, shape, precision: str = "fast") -> list:
    """Every admissible LaunchConfig of ``kernel`` at ``shape`` ((H,) for
    the sum, (K, F) for the GAT forward) and ``precision``, sorted by
    label: built by the library and covering a row in no more passes than
    the default rule."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel={kernel!r}: one of {KERNELS}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: fast|exact")
    shape = tuple(int(v) for v in shape)
    if len(shape) != (1 if kernel == "sum" else 2) or min(shape) < 1:
        raise ValueError(f"{kernel} shape {shape}: (H,) for the sum, "
                         f"(K, F) for the GAT forward")
    limit = default_config(kernel, shape, precision).geometry()["passes"]
    if kernel == "sum":
        pairs = [(n, e) for n in LANES for e in EDGES]
    else:
        pairs = list(FWD_PAIRS[gat_vec(*shape)[0]])
    cfgs = [c for c in (LaunchConfig(kernel, shape, precision, p)
                        for p in pairs)
            if c.built() and c.geometry()["passes"] <= limit]
    cfgs.sort(key=lambda c: c.label)
    return cfgs
