"""GAT attention: the CUDA kernels, their loader and their plain versions.

Features are ``x`` [T, H] with H = K * F (K heads of F features, head k in
columns [k*F, (k+1)*F)), the layout of the JAX package's fused kernels
(``roc_tpu/ops/pallas/gat.py``, heads stacked on the lane axis).  K is read
from the score tensors' second dimension.  Entry points, each the function
of a TPU kernel (or of the score its body computes):

  gat_score(x, a_src)                  as[t, k] = sum_f x[t, kF+f] a_src[k, f],
                                       in f order from 0, each product rounded
                                       before its add (``gat_score_serial``)
                                       (``_chunk_score``, gat.py:310)
  gat_forward(x, as_, ad, row_ptr, col_idx, slope, precision)
                                       -> (out [N, H], m [N, K], z [N, K]):
                                       q = ad[v] + as[u], s = lrelu(q),
                                       m = max s, e = exp(s - m), z = sum e,
                                       out = sum e x[u] / max(z, 1e-15)
                                       (``_gat_max_kernel`` + ``_gat_sum_kernel``);
                                       x may be a column slice.  The kernel's
                                       geometry is ``forward_geometry``'s;
                                       where it stages, ``gat_stage(x)``
                                       first writes x as an fp32 plane of
                                       16-byte rows (its own launch of
                                       aggregate_sum's staging kernel)
  gat_bwd_src(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx, slope, precision)
                                       -> (dtable [T, H] = sum over out-edges of
                                       e du[v], dast [T, K] = sum of dq,
                                       dq [E, K]): the per-edge score gradient
                                       dq = e lrelu'(q) (sum_f du[v] x[u] + dz[v])
                                       formed once, from the one gather of
                                       du[v], in transposed edge order
                                       (``_gat_bwd_src_kernel``); the
                                       kernel's lane group is
                                       ``src_geometry``'s
  gat_bwd_dst(dq, t_pos, row_ptr, col_idx)
                                       -> dadl [N, K] = sum of dq over in-edges:
                                       forward edge e's row of dq is
                                       dq[t_pos[e]] (``_gat_bwd_dst_kernel``)

The backward runs src, then dst, as the JAX package's reference backward
(``roc_tpu/ops/edge.py:_gat_plan_bwd``) forms dq once and sums it twice.
``gat_bwd_dst_plain`` and ``gat_bwd_src_plain`` are the function's plain
versions (dadl; dtable and dast); ``gat_bwd_src_dq_plain`` and
``gat_dadl_plain`` are the plain twins of the two kernels, and
``gat_dq_plain`` forms dq over the forward CSR, in its edge order.

lrelu'(q) is 1 for q >= 0 and ``slope`` below, as in the JAX package
(edge.py:479).  Precision contract (gat.py:433-438): "fast" gives the
products e * x (forward) and e * du (dtable) one bf16 rounding before their
fp32 sums; "exact" is fp32 throughout; scores, maxima, normalizers and the
score gradients are fp32 in both.

On a CUDA tensor each wrapper launches its kernel from ``csrc/gat.cu`` or
raises; on a CPU tensor it runs the plain version, which gathers in edge
chunks (unchunked, [E, K, F] at the Reddit shape is 24 GB).  Each wrapper's
``launches`` counts kernel launches; beside it ``gat_forward.sweeps`` counts
pass 1's sweeps of a row's edges (one for each 4 heads' maxima, so two a
launch at K = 8), ``gat_bwd_src.narrow_launches`` the src kernel's
launches whose lane group is under a warp (16 lanes at H = 64),
``gat_bwd_dst.dq_passes`` the dst kernel's passes over
the rows of dq, one for each group of heads ``dst_head_groups`` gives (one
a launch at K in {1, 2, 4, 8}, two at K = 12 or 16, K at an odd K), and
``gat_bwd_dst.head_loops`` the launches that still take a head a pass (an
odd K above 1).  Index bounds are the caller's, as for ``aggregate_sum``
(the graph data validates the CSR once).
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple, Tuple

import torch

from roc_tpu_torch.ops.kernels.aggregate_sum import (_CHUNK_TARGET_ELEMS,
                                                     _check_csr,
                                                     check_precision,
                                                     plane_launch,
                                                     stage_plain)
from roc_tpu_torch.ops.kernels.build import (CudaLibrary, _csr_int64,
                                             _require_cuda)

# Normalizer guard of every softmax division (roc_tpu/ops/edge.py:39): live
# rows have z >= 1 by the max shift; edgeless rows divide 0 by it.
Z_GUARD = 1e-15


def _bind(lib: ctypes.CDLL) -> None:
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    for name, args in (
            ("roc_gat_score", [p, p, p, ll, i, i, i, p]),
            ("roc_gat_forward", [p, p, p, ll, p, p, p, p, p, ll, i, i, f, i,
                                 i, i, i, p, p]),
            ("roc_gat_bwd_dst", [p, p, p, p, ll, i, p]),
            ("roc_gat_bwd_src", [p, p, p, p, p, p, p, p, p, ll, i, i, i, f,
                                 i, i, i, i, p, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("gat.cu", _bind)


def _lrelu(q: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(q >= 0, q, q * slope)


def _heads(x: torch.Tensor, scores: torch.Tensor) -> Tuple[int, int]:
    """(K, F) from x [T, H] and a [rows, K] score tensor."""
    if x.dim() != 2 or scores.dim() != 2:
        raise ValueError(f"x must be [T, H] and scores [rows, K], got "
                         f"{tuple(x.shape)} and {tuple(scores.shape)}")
    k = scores.shape[1]
    if k < 1 or x.shape[1] % k:
        raise ValueError(f"H = {x.shape[1]} is not a multiple of K = {k}")
    return k, x.shape[1] // k


def _check_f32(*tensors) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"the GAT kernels take float32 tensors, got "
                             f"{t.dtype}")


def _check_node_tensors(n: int, k: int, h: int, per_head: dict,
                        per_column: dict) -> None:
    """Each of ``per_head`` [n, K] and each of ``per_column`` [n, H]."""
    for want, group in (((n, k), per_head), ((n, h), per_column)):
        for name, v in group.items():
            if tuple(v.shape) != want:
                raise ValueError(f"{name} must be {list(want)}, got "
                                 f"{tuple(v.shape)}")


def _check_shapes(x, as_, ad, row_ptr, col_idx, per_head=None,
                  per_column=None) -> None:
    """x [T, H], as_ [T, K], ad and each of ``per_head`` [N, K], each of
    ``per_column`` [N, H], against the CSR's N destination rows."""
    per_head, per_column = per_head or {}, per_column or {}
    _check_csr(x, row_ptr, col_idx)
    k, _ = _heads(x, as_)
    n, (t, h) = row_ptr.numel() - 1, x.shape
    if tuple(as_.shape) != (t, k):
        raise ValueError(f"as_ must be [{t}, K], got {tuple(as_.shape)}")
    _check_node_tensors(n, k, h, {"ad": ad, **per_head}, per_column)
    _check_f32(x, as_, ad, *per_head.values(), *per_column.values())


def _check_src_shapes(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx) -> None:
    """x [T, H] and as_ [T, K] against the transposed CSR's T source rows;
    ad, m, dz [N, K] and du [N, H] over the N destination rows."""
    _check_csr(x, t_row_ptr, t_col_idx)
    k, _ = _heads(x, as_)
    (t, h), n = x.shape, du.shape[0] if du.dim() == 2 else -1
    if t_row_ptr.numel() - 1 != t or tuple(as_.shape) != (t, k):
        raise ValueError(f"gat_bwd_src: x {tuple(x.shape)} and as_ "
                         f"{tuple(as_.shape)} disagree with a transposed "
                         f"CSR of {t_row_ptr.numel() - 1} rows")
    _check_node_tensors(n, k, h, {"ad": ad, "m": m, "dz": dz}, {"du": du})
    _check_f32(x, as_, ad, m, du, dz)


def _check_edge_map(t_pos: torch.Tensor, col_idx: torch.Tensor) -> None:
    if (t_pos.dim() != 1 or t_pos.dtype != torch.int32
            or t_pos.numel() != col_idx.numel()
            or t_pos.device != col_idx.device):
        raise ValueError(f"t_pos must be the CSR's [E] int32 edge map "
                         f"beside col_idx ({col_idx.numel()} edges on "
                         f"{col_idx.device}), got {t_pos.dtype} of shape "
                         f"{tuple(t_pos.shape)} on {t_pos.device}")


def _check_dq(dq: torch.Tensor, t_pos: torch.Tensor, row_ptr: torch.Tensor,
              col_idx: torch.Tensor) -> None:
    """dq [E, K] float32, E the CSR's edges, and the edge map t_pos, on the
    CSR's device."""
    if dq.dim() != 2 or dq.shape[0] != col_idx.numel() or dq.shape[1] < 1:
        raise ValueError(f"dq must be [E, K] with E = {col_idx.numel()}, "
                         f"got {tuple(dq.shape)}")
    _check_csr(dq, row_ptr, col_idx)
    _check_f32(dq)
    _check_edge_map(t_pos, col_idx)


def _edge_spans(row_ptr: torch.Tensor, col_idx: torch.Tensor, width: int
                ) -> Iterator[Tuple[slice, torch.Tensor, torch.Tensor]]:
    """(span, row, col): the edges [lo, hi) as a slice and their int64 row
    and column ids, in chunks whose gathered [chunk, width] block stays
    near 2^25 elements."""
    num_edges = col_idx.numel()
    chunk = max(_CHUNK_TARGET_ELEMS // max(width, 1), 1024)
    for lo in range(0, num_edges, chunk):
        hi = min(lo + chunk, num_edges)
        e = torch.arange(lo, hi, dtype=row_ptr.dtype, device=row_ptr.device)
        yield (slice(lo, hi), torch.searchsorted(row_ptr, e, right=True) - 1,
               col_idx[lo:hi].long())


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32) if precision == "fast" \
        else t


# -- plain versions ---------------------------------------------------------

def gat_score_plain(x: torch.Tensor, a_src: torch.Tensor) -> torch.Tensor:
    """as[t, k] = sum_f x[t, kF + f] a_src[k, f], on any device."""
    if a_src.dim() != 2 or x.dim() != 2 or x.shape[1] != a_src.numel():
        raise ValueError(f"x [T, K*F] and a_src [K, F] disagree: "
                         f"{tuple(x.shape)}, {tuple(a_src.shape)}")
    _check_f32(x, a_src)
    k, f = a_src.shape
    return (x.view(-1, k, f) * a_src).sum(-1)


def gat_score_serial(x: torch.Tensor, a_src: torch.Tensor) -> torch.Tensor:
    """The source score in the kernel's order and rounding: for each head,
    from 0, add the rounded product of feature f, f = 0, 1, ...  A check of
    the kernel's bits (``chip_smoke.py``, the tests); no path runs it."""
    k, f = a_src.shape
    xv = x.view(-1, k, f)
    acc = torch.zeros((x.shape[0], k), dtype=torch.float32, device=x.device)
    for i in range(f):
        acc = acc + xv[:, :, i] * a_src[:, i]
    return acc


def gat_forward_plain(x, as_, ad, row_ptr, col_idx, slope: float = 0.2,
                      precision: str = "exact"):
    """The plain forward on any device: the two-pass softmax, its maxima
    by ``scatter_reduce_`` and its sums by ``index_add_`` in edge chunks."""
    _check_shapes(x, as_, ad, row_ptr, col_idx)
    check_precision(precision, x.dtype)
    k, f = _heads(x, as_)
    n, h = row_ptr.numel() - 1, x.shape[1]
    m = torch.full((n, k), float("-inf"), device=x.device)
    for _, rows, cols in _edge_spans(row_ptr, col_idx, k):
        s = _lrelu(ad[rows] + as_[cols], slope)
        m.scatter_reduce_(0, rows[:, None].expand(-1, k), s, "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = torch.zeros((n, k), device=x.device)
    u = torch.zeros((n, h), device=x.device)
    for _, rows, cols in _edge_spans(row_ptr, col_idx, h):
        e = torch.exp(_lrelu(ad[rows] + as_[cols], slope) - m[rows])
        z.index_add_(0, rows, e)
        t = (e[:, :, None] * x[cols].view(-1, k, f)).view(-1, h)
        u.index_add_(0, rows, _round(t, precision))
    out = u.view(n, k, f) / torch.clamp_min(z, Z_GUARD)[:, :, None]
    return out.view(n, h), m, z


def _dq(q, e, du_e, x_e, dz_e, k, f, slope):
    """Per-edge score gradient e lrelu'(q) (sum_f du x + dz), fp32."""
    de = (du_e.view(-1, k, f) * x_e.view(-1, k, f)).sum(-1) + dz_e
    return e * de * torch.where(q >= 0, 1.0, slope)


def gat_bwd_dst_plain(x, as_, ad, m, du, dz, row_ptr, col_idx,
                      slope: float = 0.2) -> torch.Tensor:
    """dadl over the forward CSR, on any device."""
    _check_shapes(x, as_, ad, row_ptr, col_idx, {"m": m, "dz": dz},
                  {"du": du})
    k, f = _heads(x, as_)
    dadl = torch.zeros((row_ptr.numel() - 1, k), device=x.device)
    for _, rows, cols in _edge_spans(row_ptr, col_idx, x.shape[1]):
        q = ad[rows] + as_[cols]
        e = torch.exp(_lrelu(q, slope) - m[rows])
        dadl.index_add_(0, rows, _dq(q, e, du[rows], x[cols], dz[rows], k, f,
                                     slope))
    return dadl


def _src_plain(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx, slope,
               precision, with_dq: bool):
    """dtable, dast and, when asked, dq in transposed edge order."""
    _check_src_shapes(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx)
    check_precision(precision, x.dtype)
    k, f = _heads(x, as_)
    t, h = x.shape
    dtable = torch.zeros((t, h), device=x.device)
    dast = torch.zeros((t, k), device=x.device)
    dq = (torch.empty((t_col_idx.numel(), k), device=x.device) if with_dq
          else None)
    for span, rows, cols in _edge_spans(t_row_ptr, t_col_idx, h):
        q = ad[cols] + as_[rows]
        e = torch.exp(_lrelu(q, slope) - m[cols])
        g = du[cols]
        prod = (e[:, :, None] * g.view(-1, k, f)).view(-1, h)
        dtable.index_add_(0, rows, _round(prod, precision))
        dqc = _dq(q, e, g, x[rows], dz[cols], k, f, slope)
        dast.index_add_(0, rows, dqc)
        if dq is not None:
            dq[span] = dqc
    return dtable, dast, dq


def gat_bwd_src_plain(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx,
                      slope: float = 0.2, precision: str = "exact"):
    """(dtable, dast) over the transposed CSR (row u, its destinations v),
    on any device."""
    return _src_plain(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx, slope,
                      precision, False)[:2]


def gat_bwd_src_dq_plain(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx,
                         slope: float = 0.2, precision: str = "exact"):
    """The plain twin of the src kernel, on any device: (dtable, dast) as
    :func:`gat_bwd_src_plain`, and dq [E, K], each edge's score gradient
    in transposed edge order."""
    return _src_plain(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx, slope,
                      precision, True)


def gat_dq_plain(x, as_, ad, m, du, dz, row_ptr, col_idx,
                 slope: float = 0.2) -> torch.Tensor:
    """dq [E, K] over the forward CSR, in its edge order, on any device."""
    _check_shapes(x, as_, ad, row_ptr, col_idx, {"m": m, "dz": dz},
                  {"du": du})
    k, f = _heads(x, as_)
    dq = torch.empty((col_idx.numel(), k), device=x.device)
    for span, rows, cols in _edge_spans(row_ptr, col_idx, x.shape[1]):
        q = ad[rows] + as_[cols]
        e = torch.exp(_lrelu(q, slope) - m[rows])
        dq[span] = _dq(q, e, du[rows], x[cols], dz[rows], k, f, slope)
    return dq


def gat_dadl_plain(dq: torch.Tensor, t_pos: torch.Tensor,
                   row_ptr: torch.Tensor, col_idx: torch.Tensor
                   ) -> torch.Tensor:
    """The plain twin of the dst kernel, on any device: dadl [N, K], the
    sum over each destination's in-edges e of dq[t_pos[e]] (dq in
    transposed edge order)."""
    _check_dq(dq, t_pos, row_ptr, col_idx)
    dadl = torch.zeros((row_ptr.numel() - 1, dq.shape[1]), device=dq.device)
    for span, rows, _ in _edge_spans(row_ptr, col_idx, dq.shape[1]):
        dadl.index_add_(0, rows, dq[t_pos[span].long()])
    return dadl


# -- the kernels ------------------------------------------------------------

def _vec_width(h: int, *packed: torch.Tensor) -> int:
    """Widest vector (floats per lane) that divides ``h`` (H, or F where a
    pack must lie in one head) and keeps every row start of each tensor
    read or written in packs aligned."""
    for v in (4, 2, 1):
        if h % v == 0 and all(t.data_ptr() % (v * 4) == 0 for t in packed):
            return v
    return 1


def gat_score(x: torch.Tensor, a_src: torch.Tensor) -> torch.Tensor:
    """as [T, K] from x [T, K*F] and a_src [K, F].  Launches the CUDA kernel
    for CUDA tensors, runs the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return gat_score_plain(x, a_src)
    if a_src.dim() != 2 or x.dim() != 2 or x.shape[1] != a_src.numel():
        raise ValueError(f"x [T, K*F] and a_src [K, F] disagree: "
                         f"{tuple(x.shape)}, {tuple(a_src.shape)}")
    _check_f32(x, a_src)
    _require_cuda("gat_score", x, a_src)
    k, f = a_src.shape
    out = torch.empty((x.shape[0], k), device=x.device)
    if x.shape[0] == 0:
        return out
    LIBRARY.launch(gat_score, "roc_gat_score", x.device, x.data_ptr(),
                   a_src.data_ptr(), out.data_ptr(), x.shape[0], k, f,
                   int(x.data_ptr() % 16 == 0))
    return out


# (lanes, packs a lane a pass) of the forward's lane groups, narrowest
# first: a row takes the first pair whose lanes * packs cover its packs, or
# the last in several passes (csrc/gat.cu:launch_fwd_group)
FWD_GROUPS = ((8, 1), (16, 1), (16, 3), (32, 2))

# The src kernel's, read by the same rule (csrc/gat.cu:launch_src_group):
# the forward's but (16, 3), which at layer 2's 41 columns in 1-float packs
# read slower than a warp of two (PERF.md row 12)
SRC_GROUPS = ((8, 1), (16, 1), (32, 2))


def _lane_group(packs: int, table) -> Tuple[int, int]:
    """The first (lanes, packs) of ``table`` that covers a row of
    ``packs`` packs, else its last (the row in several passes)."""
    return next(((n, q) for n, q in table if packs <= n * q), table[-1])

# The pairs csrc/gat.cu builds, by pack width: FWD_GROUPS at every width,
# and three more at 4-float packs (the main path's) that the autotuner may
# choose (roc_tpu_torch/tune/lattice.py).  Any other pair raises.
FWD_PAIRS = {4: FWD_GROUPS + ((8, 2), (16, 4), (32, 1)),
             2: FWD_GROUPS, 1: FWD_GROUPS}


class FwdGeometry(NamedTuple):
    """How ``gat_fwd_rows`` covers a row: ``vec`` floats a pack, ``lanes``
    lanes a row, ``packs`` packs a lane a pass, gathered from x in place
    (row stride ``ld``) or, ``staged``, from a plane of ``ld`` columns."""
    vec: int
    lanes: int
    packs: int
    staged: bool
    ld: int


def forward_geometry(k: int, f: int, ld: int, ptr: int,
                     groups=None) -> FwdGeometry:
    """The forward kernel's geometry for K heads of F over x whose rows are
    ``ld`` floats apart from address ``ptr``.  ``vec`` is the widest of 4,
    2, 1 floats that divides F (so a pack lies in one head and takes one
    weight) and ld and the address's alignment.  A K = 1 row that is not
    16-byte aligned (layer 2's 41 columns) is gathered from an fp32 plane
    of ld4(H) columns, staged once a forward (``gat_stage``), as 4-float
    packs (chip_variants.py's gat_fwd_in_place_at_41 reads the in-place
    gather slower).  ``groups`` is a (lanes, packs) table read as
    ``FWD_GROUPS`` is, in its place (the autotuner's pair); a pair the
    library does not build at ``vec`` raises."""
    h = k * f
    vec = next(v for v in (4, 2, 1)
               if f % v == 0 and ld % v == 0 and ptr % (4 * v) == 0)
    staged = k == 1 and vec < 4
    if staged:
        vec, ld = 4, (h + 3) // 4 * 4
    packs = -(-h // vec)
    table = FWD_GROUPS if groups is None else tuple(
        (int(n), int(q)) for n, q in groups)
    lanes, per = _lane_group(packs, table)
    if (lanes, per) not in FWD_PAIRS[vec]:
        raise ValueError(f"gat_forward: lane group {(lanes, per)} is not "
                         f"built at {vec}-float packs "
                         f"({FWD_PAIRS[vec]})")
    return FwdGeometry(vec, lanes, per, staged, ld)


def gat_stage(x: torch.Tensor) -> torch.Tensor:
    """The forward's staged plane [T, ld4(H)] of x [T, H] (rows
    ``x.stride(0)`` apart): x's columns in fp32, then 0, the exact plane of
    ``aggregate_sum.stage_plain``.  Launches aggregate_sum's staging kernel
    for CUDA tensors (counted here), runs ``stage_plain`` for CPU tensors."""
    if x.device.type == "cpu":
        return stage_plain(x, precision="exact")
    _check_f32(x)
    _require_cuda("gat_stage", rows=(x,))
    return plane_launch(x, "exact", gat_stage)


def _forward_launch(x, as_, ad, row_ptr, col_idx, slope, precision,
                    geo: FwdGeometry):
    """The kernel at geometry ``geo``, staging x first where it says so:
    (out, m, z)."""
    k, f = _heads(x, as_)
    n, h = row_ptr.numel() - 1, x.shape[1]
    out = torch.empty((n, h), device=x.device)
    m = torch.empty((n, k), device=x.device)
    z = torch.empty((n, k), device=x.device)
    if n == 0:
        return out, m, z
    src = gat_stage(x) if geo.staged else x
    claimed = torch.zeros(1, dtype=torch.int32, device=x.device)  # rows taken
    LIBRARY.launch(gat_forward, "roc_gat_forward", x.device,
                   row_ptr.data_ptr(), col_idx.data_ptr(), src.data_ptr(),
                   geo.ld, as_.data_ptr(), ad.data_ptr(), out.data_ptr(),
                   m.data_ptr(), z.data_ptr(), n, k, f, float(slope),
                   int(precision == "fast"), geo.vec, geo.lanes, geo.packs,
                   claimed.data_ptr())
    gat_forward.sweeps += -(-k // 4)   # pass 1: one sweep each 4 heads
    return out, m, z


def gat_forward(x, as_, ad, row_ptr, col_idx, slope: float = 0.2,
                precision: str = "exact", groups=None):
    """(out [N, H], m [N, K], z [N, K]) over the in-edge CSR; x may be a
    column slice (rows ``x.stride(0)`` apart).  Launches the CUDA kernel
    (after ``gat_stage`` where ``forward_geometry`` stages x) for CUDA
    tensors, runs the plain version for CPU tensors.  ``groups`` is
    ``forward_geometry``'s (None: ``FWD_GROUPS``; the autotuner's pair
    comes from ``ops.DeviceCsr.gat_groups``)."""
    if x.device.type == "cpu":
        return gat_forward_plain(x, as_, ad, row_ptr, col_idx, slope,
                                 precision)
    _check_shapes(x, as_, ad, row_ptr, col_idx)
    check_precision(precision, x.dtype)
    _require_cuda("gat_forward", as_, ad, row_ptr, col_idx, rows=(x,))
    _csr_int64("gat_forward", row_ptr)
    if row_ptr.numel() > 1 << 30:   # the kernel claims rows with an int32
        raise ValueError(f"gat_forward takes fewer than 2^30 rows, got "
                         f"{row_ptr.numel() - 1}")
    k, f = _heads(x, as_)
    return _forward_launch(x, as_, ad, row_ptr, col_idx, slope, precision,
                           forward_geometry(k, f, x.stride(0), x.data_ptr(),
                                            groups))


def _state_rows(dz: torch.Tensor, ad: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """[N, P] rows (dz | ad | m | 0), P = 3K rounded up to 4: each
    destination's state as the src kernel loads it, in 16-byte packs."""
    n, k = dz.shape
    st = torch.empty((n, (3 * k + 3) // 4 * 4), device=dz.device)
    for i, t in enumerate((dz, ad, m)):
        st[:, i * k:(i + 1) * k] = t
    st[:, 3 * k:] = 0
    return st


class SrcGeometry(NamedTuple):
    """How ``gat_bwd_src_rows`` covers a source row: ``vec`` floats a pack,
    ``lanes`` lanes a row, ``packs`` packs a lane a tile."""
    vec: int
    lanes: int
    packs: int


def src_geometry(k: int, f: int, x: torch.Tensor,
                 du: torch.Tensor) -> SrcGeometry:
    """The src kernel's geometry for K heads of F: ``vec`` the widest of 4,
    2, 1 floats that divides F and keeps x's and du's rows aligned (dtable
    comes fresh from the allocator, aligned), and the lane group the
    forward's rule gives from ``SRC_GROUPS`` over the row's ceil(H / vec)
    packs: 16 lanes of one 4-float pack at H = 64, a warp of two packs a
    lane at layer 2's 41 one-float packs and over 256-column tiles at
    H = 256 and beyond."""
    vec = _vec_width(f, x, du)
    return SrcGeometry(vec, *_lane_group(-(-k * f // vec), SRC_GROUPS))


def _src_launch(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx, slope,
                precision, geo: SrcGeometry):
    """The src kernel at geometry ``geo``: (dtable, dast, dq).  A lane
    group the library does not build raises."""
    k, f = _heads(x, as_)
    t, h = x.shape
    dtable = torch.empty((t, h), device=x.device)
    dast = torch.empty((t, k), device=x.device)
    dq = torch.empty((t_col_idx.numel(), k), device=x.device)
    if t == 0:
        return dtable, dast, dq
    st = _state_rows(dz, ad, m)
    claimed = torch.zeros(1, dtype=torch.int32, device=x.device)  # rows taken
    LIBRARY.launch(gat_bwd_src, "roc_gat_bwd_src", x.device,
                   t_row_ptr.data_ptr(), t_col_idx.data_ptr(), x.data_ptr(),
                   as_.data_ptr(), st.data_ptr(), du.data_ptr(),
                   dtable.data_ptr(), dast.data_ptr(), dq.data_ptr(), t, k,
                   f, st.shape[1], float(slope), int(precision == "fast"),
                   geo.vec, geo.lanes, geo.packs, claimed.data_ptr())
    gat_bwd_src.narrow_launches += geo.lanes < 32
    return dtable, dast, dq


def gat_bwd_src(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx,
                slope: float = 0.2, precision: str = "exact"):
    """(dtable [T, H], dast [T, K], dq [E, K]) over the transposed CSR,
    dq in its edge order.  Launches the CUDA kernel, in ``src_geometry``'s
    lane group, for CUDA tensors, runs the plain twin for CPU tensors."""
    if x.device.type == "cpu":
        return gat_bwd_src_dq_plain(x, as_, ad, m, du, dz, t_row_ptr,
                                    t_col_idx, slope, precision)
    _check_src_shapes(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx)
    check_precision(precision, x.dtype)
    _require_cuda("gat_bwd_src", x, as_, ad, m, du, dz, t_row_ptr, t_col_idx)
    _csr_int64("gat_bwd_src", t_row_ptr)
    if t_row_ptr.numel() > 1 << 30:   # the kernel claims rows with an int32
        raise ValueError(f"gat_bwd_src takes fewer than 2^30 rows, got "
                         f"{t_row_ptr.numel() - 1}")
    k, f = _heads(x, as_)
    return _src_launch(x, as_, ad, m, du, dz, t_row_ptr, t_col_idx, slope,
                       precision, src_geometry(k, f, x, du))


def dst_head_groups(k: int) -> Tuple[int, ...]:
    """The heads ``gat_bwd_dst_rows`` sums in each of its passes over the
    in-edges' dq rows, in column order, for the ``dq_passes`` and
    ``head_loops`` counters: the whole row at K in {1, 2, 4, 8}; at any
    other even K groups of 8, then 4, then 2, each loaded in 16- or 8-byte
    packs; at an odd K a head a pass.  The kernel's dispatch
    (``csrc/gat.cu:sum_head_groups``) takes these groups.  Every plan sums
    each head in the same order, so it decides the bytes read and not the
    bits: the card test holds each branch bitwise against one-head
    launches."""
    if k % 2:
        return (1,) * k
    return (8,) * (k // 8) + (4,) * (k % 8 // 4) + (2,) * (k % 4 // 2)


def gat_bwd_dst(dq: torch.Tensor, t_pos: torch.Tensor, row_ptr: torch.Tensor,
                col_idx: torch.Tensor) -> torch.Tensor:
    """dadl [N, K], the sum over each destination's in-edges e of
    dq[t_pos[e]] (dq [E, K] in transposed edge order, as ``gat_bwd_src``
    gives it).  Launches the CUDA kernel for CUDA tensors, runs the plain
    twin for CPU tensors."""
    if dq.device.type == "cpu":
        return gat_dadl_plain(dq, t_pos, row_ptr, col_idx)
    _check_dq(dq, t_pos, row_ptr, col_idx)
    _require_cuda("gat_bwd_dst", dq, t_pos, row_ptr, col_idx)
    _csr_int64("gat_bwd_dst", row_ptr)
    if dq.data_ptr() % 16:
        raise ValueError("gat_bwd_dst: dq must start 16-byte aligned")
    n, k = row_ptr.numel() - 1, dq.shape[1]
    dadl = torch.empty((n, k), device=dq.device)
    if n == 0:
        return dadl
    LIBRARY.launch(gat_bwd_dst, "roc_gat_bwd_dst", dq.device,
                   row_ptr.data_ptr(), t_pos.data_ptr(), dq.data_ptr(),
                   dadl.data_ptr(), n, k)
    groups = dst_head_groups(k)
    gat_bwd_dst.dq_passes += len(groups)
    gat_bwd_dst.head_loops += k > 1 and len(groups) == k
    return dadl


gat_score.launches = 0
gat_stage.launches = 0
gat_forward.launches = 0
gat_forward.sweeps = 0
gat_bwd_dst.launches = 0
gat_bwd_dst.dq_passes = 0
gat_bwd_dst.head_loops = 0
gat_bwd_src.launches = 0
gat_bwd_src.narrow_launches = 0
