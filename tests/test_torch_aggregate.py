"""The port's sum aggregation (roc_tpu_torch/ops) against roc_tpu's.

Same numpy-seeded inputs through ``roc_tpu.ops.scatter_gather`` (the xla
backend, fp32) and ``roc_tpu.ops.scatter_gather_binned`` (the Pallas
kernels in interpret mode, as tests/test_binned.py runs them) and through
the port.  On the CPU the port's wrapper runs its plain version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py and by the ``cuda``-marked test below.

Tolerances, relative to each row's max-abs:
  exact vs fp32 xla        1e-5   fp32 sums in another order
  fast vs binned fast      1e-5   both round each feature once to bf16 at
                                  the same point; only the order differs
  fast vs fp32 xla         5e-3   one designed bf16 rounding (2^-9)
  integer data             bitwise
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roc_tpu import ops as jops
from roc_tpu.graph import csr as jcsr
from roc_tpu_torch import ops
from roc_tpu_torch.graph.csr import add_self_edges, from_edges
from roc_tpu_torch.ops.kernels import aggregate_sum as K


@pytest.fixture(autouse=True)
def _binned_runs_under_jax_0_9(monkeypatch):
    """run_binned's one-shot eager warning calls jax.core.trace_state_clean,
    which jax 0.9.0 no longer exports; marking the warning as given skips
    the call (ROADMAP queue C)."""
    from roc_tpu.ops.pallas import binned
    monkeypatch.setattr(binned, "_EAGER_WARNED", [True])


def _row_rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).max(axis=1)
    s = np.abs(want).max(axis=1)
    return float(np.where(d == 0, 0.0, d / np.where(s == 0, 1.0, s)).max())


def _random_graph(n=300, e=2000, seed=5, hub=True):
    """Random multigraph with a hub destination and some empty rows."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 20, e)       # the last 20 rows stay empty
    if hub:
        dst[: e // 5] = 7
    return from_edges(n, src, dst)


def _ring_graph(n=64):
    """Every in-degree exactly 4 (tests/test_stream_tiers.py's fixture)."""
    src = np.concatenate([(np.arange(n) + k) % n for k in (1, 17, 33)])
    dst = np.tile(np.arange(n), 3)
    g = add_self_edges(from_edges(n, src, dst))
    assert np.unique(np.diff(g.row_ptr)).tolist() == [4]
    return g


def _port(x, g, precision, aggr="sum"):
    csr = ops.DeviceCsr.from_csr(g, "cpu")
    return ops.scatter_gather(torch.as_tensor(x), csr, aggr,
                              precision).numpy()


def _xla(x, g, aggr="sum"):
    return np.asarray(jops.scatter_gather(
        jnp.asarray(x), jnp.asarray(g.col_idx), jnp.asarray(g.dst_idx),
        g.num_nodes, aggr))


def _binned(x, g, precision):
    plans = jops.build_binned_plans(g.col_idx, g.dst_idx, g.num_nodes,
                                    g.num_nodes)
    return np.asarray(jops.scatter_gather_binned(
        jnp.asarray(x), plans, True, precision))


@pytest.mark.parametrize("h", [41, 128])
def test_exact_matches_xla(h):
    g = _random_graph()
    x = np.random.default_rng(1).standard_normal((g.num_nodes, h),
                                                 dtype=np.float32)
    assert _row_rel_err(_port(x, g, "exact"), _xla(x, g)) <= 1e-5


@pytest.mark.parametrize("h", [41, 128])
def test_fast_is_one_bf16_rounding_of_xla(h):
    g = _random_graph()
    x = np.random.default_rng(2).standard_normal((g.num_nodes, h),
                                                 dtype=np.float32)
    fast, ref = _port(x, g, "fast"), _xla(x, g)
    assert _row_rel_err(fast, ref) <= 5e-3
    # and it really rounds: fast is measurably off fp32 where exact is not
    assert _row_rel_err(fast, ref) > 10 * _row_rel_err(
        _port(x, g, "exact"), ref)


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("h", [41, 128])
def test_matches_binned_interpret(h, precision):
    g = _random_graph(n=700, e=5000)
    x = np.random.default_rng(3).standard_normal((g.num_nodes, h),
                                                 dtype=np.float32)
    assert _row_rel_err(_port(x, g, precision),
                        _binned(x, g, precision)) <= 1e-5


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("h", [41, 128])
def test_integer_fixture_bitwise(h, precision):
    g = _ring_graph()
    x = np.random.default_rng(0).integers(0, 2, (g.num_nodes, h)).astype(
        np.float32)
    out = _port(x, g, precision)
    np.testing.assert_array_equal(out, _xla(x, g))
    np.testing.assert_array_equal(out, _binned(x, g, precision))


@pytest.mark.parametrize("aggr", ["avg", "max", "min"])
def test_other_aggrs_match_xla(aggr):
    """avg = sum / in-degree; max/min zero the empty rows."""
    g = _random_graph()
    x = np.random.default_rng(4).standard_normal((g.num_nodes, 16),
                                                 dtype=np.float32)
    out = _port(x, g, "exact", aggr)
    assert np.all(out[-20:] == 0)
    assert _row_rel_err(out, _xla(x, g, aggr)) <= 1e-5
    plain = ops.scatter_gather_plain(torch.as_tensor(x),
                                     ops.DeviceCsr.from_csr(g, "cpu"), aggr)
    np.testing.assert_array_equal(plain.numpy(), out)


def _extreme_grads(x, g, cot, aggr):
    """d<out, cot>/dx of the max/min aggregation: the port's autograd and
    ``jax.vjp`` of roc_tpu's xla ``scatter_gather``."""
    xt = torch.tensor(x, requires_grad=True)
    out = ops.scatter_gather(xt, ops.DeviceCsr.from_csr(g, "cpu"), aggr,
                             "exact")
    out.backward(torch.as_tensor(cot))
    _, vjp = jax.vjp(lambda xx: jops.scatter_gather(
        xx, jnp.asarray(g.col_idx), jnp.asarray(g.dst_idx), g.num_nodes,
        aggr), jnp.asarray(x))
    return xt.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("aggr", ["max", "min"])
def test_extreme_vjp_matches_roc_tpu_at_ties(aggr):
    """Tie-heavy integer data: features in {-1, 0, 1} (so most rows tie,
    and many rows' extreme is exactly 0), a row whose sources are all
    zero, and empty rows.  The gradient is shared among the tied sources
    only, as roc_tpu's segment max/min shares it."""
    g = _random_graph()
    rng = np.random.default_rng(12)
    x = rng.integers(-1, 2, (g.num_nodes, 6)).astype(np.float32)
    x[g.col_idx[g.row_ptr[7]:g.row_ptr[8]], 0] = 0.0    # the hub: all 0
    cot = rng.integers(-3, 4, (g.num_nodes, 6)).astype(np.float32)
    ours = ops.scatter_gather(torch.as_tensor(x),
                              ops.DeviceCsr.from_csr(g, "cpu"), aggr,
                              "exact").numpy()
    assert (ours == 0).mean() > 0.05 and np.all(ours[-20:] == 0)
    got, want = _extreme_grads(x, g, cot, aggr)
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got - want).max() <= 1e-6 * scale


@pytest.mark.parametrize("aggr,values,want", [
    ("max", [0.0, -1.0, -1.0], [1.0, 0.0, 0.0]),
    ("max", [0.0, 0.0, -1.0], [0.5, 0.5, 0.0]),
    ("min", [0.0, 1.0, 1.0], [1.0, 0.0, 0.0]),
    ("min", [0.0, 0.0, 1.0], [0.5, 0.5, 0.0])])
def test_extreme_gradient_at_a_zero_extreme(aggr, values, want):
    """One destination row with three sources whose extreme is exactly 0:
    only the sources that reach it share the gradient."""
    g = from_edges(4, np.array([1, 2, 3]), np.array([0, 0, 0]))
    x = np.array([[5.0]] + [[v] for v in values], np.float32)
    cot = np.array([[1.0], [0.0], [0.0], [0.0]], np.float32)
    got, ref = _extreme_grads(x, g, cot, aggr)
    np.testing.assert_array_equal(got[1:, 0], np.float32(want))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("precision", ["medium", "bf16", ""])
def test_unknown_precision_raises(precision):
    g = _random_graph()
    x = torch.zeros((g.num_nodes, 4))
    with pytest.raises(ValueError, match="precision"):
        _port(x.numpy(), g, precision)
    csr = ops.DeviceCsr.from_csr(g, "cpu")
    with pytest.raises(ValueError, match="precision"):
        K.aggregate_sum(x, csr.row_ptr, csr.col_idx, precision)


def test_wrapper_rejects_bad_inputs():
    g = _random_graph()
    csr = ops.DeviceCsr.from_csr(g, "cpu")
    x = torch.zeros((g.num_nodes, 4))
    with pytest.raises(ValueError, match="col_idx"):
        K.aggregate_sum(x, csr.row_ptr, csr.col_idx.long())
    with pytest.raises(ValueError, match="row_ptr"):
        K.aggregate_sum(x, csr.row_ptr.float(), csr.col_idx)
    with pytest.raises(ValueError, match="H"):
        K.aggregate_sum(x[None], csr.row_ptr, csr.col_idx)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        K.aggregate_sum(x.double(), csr.row_ptr, csr.col_idx, "exact")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.aggregate_sum(x.to("meta"), csr.row_ptr.to("meta"),
                        csr.col_idx.to("meta"))
    assert K.aggregate_sum.launches == 0    # the CPU never launches


def test_plain_chunks_over_edges(monkeypatch):
    """Edge chunking changes nothing: many tiny chunks give the same sums
    as one (bitwise on integers, fp32 order otherwise)."""
    g = _random_graph(n=500, e=6000)
    rng = np.random.default_rng(6)
    csr = ops.DeviceCsr.from_csr(g, "cpu")
    xs = [torch.as_tensor(rng.integers(0, 3, (g.num_nodes, 8)).astype(
              np.float32)),
          torch.as_tensor(rng.standard_normal((g.num_nodes, 8),
                                              dtype=np.float32))]
    whole = [K.aggregate_sum_plain(x, csr.row_ptr, csr.col_idx, "exact")
             for x in xs]
    monkeypatch.setattr(K, "_CHUNK_TARGET_ELEMS", 8)    # 1024-edge chunks
    parts = [K.aggregate_sum_plain(x, csr.row_ptr, csr.col_idx, "exact")
             for x in xs]
    assert torch.equal(parts[0], whole[0])
    assert _row_rel_err(parts[1], whole[1]) <= 1e-6


def test_bf16_input_fast_equals_exact():
    """A bf16 input is already rounded: both precisions agree, bitwise,
    and the output stays bf16 (binned.py:3713)."""
    g = _random_graph()
    csr = ops.DeviceCsr.from_csr(g, "cpu")
    x = torch.randn((g.num_nodes, 12),
                    generator=torch.Generator().manual_seed(0)).bfloat16()
    fast = K.aggregate_sum(x, csr.row_ptr, csr.col_idx, "fast")
    exact = K.aggregate_sum(x, csr.row_ptr, csr.col_idx, "exact")
    assert fast.dtype == torch.bfloat16 and torch.equal(fast, exact)


def test_csr_matches_roc_tpu():
    rng = np.random.default_rng(9)
    n = 200
    src, dst = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    ours = add_self_edges(from_edges(n, src, dst))
    ref = jcsr.add_self_edges(jcsr.from_edges(n, src, dst))
    for a, b in ((ours, ref), (ours.transpose(), ref.transpose())):
        assert a.row_ptr.tobytes() == b.row_ptr.tobytes()
        assert a.col_idx.tobytes() == b.col_idx.tobytes()
    assert ours.in_degrees.tobytes() == ref.in_degrees.tobytes()
    assert ours.dst_idx.tobytes() == ref.dst_idx.tobytes()


def test_transpose_is_the_backward():
    """Aggregating over the transposed CSR is the vector-Jacobian product
    of aggregating over the CSR: <A x, y> == <x, A^T y>."""
    g = _random_graph()
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.integers(0, 3, (g.num_nodes, 5)).astype(
        np.float32))
    y = torch.as_tensor(rng.integers(0, 3, (g.num_nodes, 5)).astype(
        np.float32))
    fwd = ops.DeviceCsr.from_csr(g, "cpu")
    bwd = ops.DeviceCsr.from_csr(g.transpose(), "cpu")
    ax = K.aggregate_sum(x, fwd.row_ptr, fwd.col_idx, "exact")
    aty = K.aggregate_sum(y, bwd.row_ptr, bwd.col_idx, "exact")
    assert float((ax * y).sum()) == float((x * aty).sum())


def _specials(x: np.ndarray) -> np.ndarray:
    """x with NaN, +inf, -inf and -0.0 planted in a few rows (one of them a
    hub source), so some sums are NaN, some infinite, some a signed 0."""
    x = x.copy()
    x[3, 0] = np.nan
    x[4, -1] = np.inf
    x[5, x.shape[1] // 2] = -np.inf
    x[6, :] = -0.0
    x[7, 0] = -0.0
    return x


@pytest.mark.parametrize("data", ["integer", "gaussian"])
@pytest.mark.parametrize("h", [1, 41, 256, 602])
def test_staged_plane_gathered_exact_is_fast(h, data):
    """The card's fast path stages x once as a padded bf16 plane
    (``stage_plain`` is its plain twin) and sums the plane's rows in fp32:
    that equals the plain fast sum (one bf16 rounding per element, applied
    per edge) bit for bit, NaN, infinities and -0.0 included, and the
    plane's padding columns (H .. ld8(H)) sum to exactly 0, so a padding
    column never reaches a real one."""
    g = _random_graph(n=300, e=2000)
    csr = ops.DeviceCsr.from_csr(g, "cpu")
    rng = np.random.default_rng(h)
    x = (rng.integers(-300, 301, (g.num_nodes, h)) if data == "integer"
         else rng.standard_normal((g.num_nodes, h))).astype(np.float32)
    x = torch.as_tensor(_specials(x))
    plane = K.stage_plain(x)
    ld = -(-h // 8) * 8
    assert plane.dtype == torch.bfloat16 and plane.shape == (g.num_nodes, ld)
    assert bool((plane[:, h:] == 0).all())
    got = K.aggregate_sum_plain(plane.float(), csr.row_ptr, csr.col_idx,
                                "exact")
    want = K.aggregate_sum_plain(x, csr.row_ptr, csr.col_idx, "fast")
    assert torch.equal(got[:, :h].view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[:, h:].view(torch.int32),
                       torch.zeros_like(got[:, h:]).view(torch.int32))
    assert bool(torch.isnan(want).any()) and bool(torch.isinf(want).any())


def test_stage_plane_on_the_cpu_is_its_plain_twin():
    """On a CPU tensor stage_plane runs stage_plain and launches nothing;
    a column slice of a wider tensor (rows x.stride(0) apart) is staged as
    its own rows."""
    rng = np.random.default_rng(2)
    base = torch.as_tensor(rng.standard_normal((50, 48)).astype(np.float32))
    x = base[:, 3:44]
    before = K.stage_plane.launches
    got = K.stage_plane(x)
    assert torch.equal(got, K.stage_plain(x.contiguous()))
    assert got.shape == (50, 48) and K.stage_plane.launches == before


def test_forward_launches_count_the_stagings():
    """forward_launches also counts the stagings: in fast (the default)
    each sum aggregation and each megakernel stages its input once, in
    exact none does."""
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.train.graph_data import forward_launches
    gcn = build_model("gcn", [8, 16, 4], 0.0)
    assert forward_launches(gcn, False, "fast")["stage_plane"] == 2
    assert forward_launches(gcn, True, "fast") == {
        "aggregate_sum": 0, "gat_score": 0, "gat_stage": 0, "gat_forward": 0,
        "aggregate_linear": 2, "stage_plane": 2}
    assert forward_launches(gcn, False, "exact")["stage_plane"] == 0
    assert forward_launches(gcn) == forward_launches(gcn, False, "fast")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_kernel_matches_plain_on_card(precision):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = _random_graph(n=3000, e=40000)
    csr = ops.DeviceCsr.from_csr(g, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h in (41, 256, 602):
        x = torch.randn((g.num_nodes, h), generator=gen, device="cuda")
        xi = torch.randint(0, 2, (g.num_nodes, h), generator=gen,
                           device="cuda").float()
        args = (csr.row_ptr, csr.col_idx, precision)
        assert torch.equal(K.aggregate_sum(xi, *args),
                           K.aggregate_sum_plain(xi, *args))
        assert _row_rel_err(K.aggregate_sum(x, *args).cpu(),
                            K.aggregate_sum_plain(x, *args).cpu()) <= 1e-5
