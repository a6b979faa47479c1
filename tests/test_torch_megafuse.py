"""The port's whole-layer megakernel (roc_tpu_torch) against roc_tpu's.

The plain versions of the two kernels (``aggregate_linear_plain``,
``aggregate_linear_bwd_plain``) and the autograd Function around them
(``ops.scatter_gather_linear``) are held against ``jax.vjp`` of
``roc_tpu.ops.scatter_gather_linear_binned`` in interpret mode, on plans
built with the flat geometry of tests/test_mega_bwd.py, whose spy on
``_mega_bwd_run`` proves the JAX fused backward ran.  On the CPU the port's
wrappers run the plain versions; the CUDA kernels are held against them on
the card by chip_smoke.py and the ``cuda``-marked test below.

Tolerances:
  integer data (the dominance construction, exact)   bitwise: every sum is
                                                     an exact fp32 integer
  Gaussian data, both precisions                     1e-5 of each row's
                                                     max-abs: fp32 sums and
                                                     GEMMs in another order;
                                                     both round each gathered
                                                     element once in fast
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roc_tpu import ops as jops
from roc_tpu.models import build_gcn as jbuild_gcn
from roc_tpu.models.model import Model as JModel
from roc_tpu.models.model import mega_matches as jmega_matches
from roc_tpu.ops.pallas import binned as B
from roc_tpu_torch import ops
from roc_tpu_torch.models import build_gcn
from roc_tpu_torch.models.model import Model, mega_matches
from roc_tpu_torch.ops.kernels import aggregate_linear as KL
from roc_tpu_torch.ops.kernels.aggregate_sum import (aggregate_sum_plain,
                                                     stage_plain)

GF = B.Geometry(sb=256, ch=512, slot=128, rb=256, ch2=512, grt=1 << 14,
                flat=1)
_ORIG_BWD_RUN = B._mega_bwd_run


@pytest.fixture(autouse=True)
def _binned_runs_under_jax_0_9(monkeypatch):
    """run_binned's one-shot eager warning calls jax.core.trace_state_clean,
    which jax 0.9.0 no longer exports; marking the warning as given skips
    the call (ROADMAP queue C)."""
    monkeypatch.setattr(B, "_EAGER_WARNED", [True])
    monkeypatch.delenv("ROC_MEGA_BWD", raising=False)


def _row_rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).max(axis=1)
    s = np.abs(want).max(axis=1)
    return float(np.where(d == 0, 0.0, d / np.where(s == 0, 1.0, s)).max())


def _device_csr(src, dst, n, t) -> ops.DeviceCsr:
    """Both directions of a rectangular edge list (dst sorted): n
    destination rows over a t-row source table."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    rp = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=rp[1:])
    order = np.argsort(src, kind="stable")
    trp = np.zeros(t + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=t), out=trp[1:])
    return ops.DeviceCsr(torch.as_tensor(rp), torch.as_tensor(
        src.astype(np.int32)), torch.as_tensor(trp),
        torch.as_tensor(dst[order].astype(np.int32)))


def _dom_graph(n, t, e, h, ho, M, lox, hix, low, hiw, seed):
    """tests/test_mega_bwd.py's construction: integer data with no zero
    pre-activation (x[:, 0] == 1 and a dominant first weight row)."""
    assert M > (h - 1) * max(abs(lox), hix) * max(abs(low), hiw)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, t, e).astype(np.int64)
    dst = np.sort(np.concatenate([np.arange(n, dtype=np.int64),
                                  rng.integers(0, n, e - n)]))
    x = rng.integers(lox, hix + 1, (t, h)).astype(np.float32)
    x[:, 0] = 1.0
    w = rng.integers(low, hiw + 1, (h, ho)).astype(np.float32)
    w[0, :] = M * np.where(rng.integers(0, 2, ho) > 0, 1.0, -1.0)
    return src, dst, x, w


def _jax_layer(src, dst, n, t, x, w, g, precision, act, monkeypatch):
    """(y, gx, gw) through roc_tpu's megakernel custom VJP, interpret
    mode; asserts the fused backward ran."""
    plans = jops.build_binned_plans(src, dst, n, t, geom=GF)
    calls = []
    monkeypatch.setattr(
        B, "_mega_bwd_run",
        lambda *a, **k: (calls.append(1), _ORIG_BWD_RUN(*a, **k))[1])
    y, vjp = jax.vjp(
        lambda xx, ww: jops.scatter_gather_linear_binned(
            xx, ww, plans, True, precision, act),
        jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(g))
    assert calls, "roc_tpu's fused backward fell back to the replay"
    return np.asarray(y), np.asarray(gx), np.asarray(gw)


def _port_plain(csr, x, w, g, precision, act):
    """(y, gx, gw) from the plain versions, dW = x^T u as the Function
    computes it."""
    x, w, g = (torch.as_tensor(a) for a in (x, w, g))
    y = KL.aggregate_linear_plain(x, w, csr.row_ptr, csr.col_idx, precision,
                                  act)
    u, dx = KL.aggregate_linear_bwd_plain(g, y, w, csr.t_row_ptr,
                                          csr.t_col_idx, precision,
                                          relu=act == "relu")
    return y.numpy(), dx.numpy(), ops.linear(x.t(), u).numpy()


def _port_autograd(csr, x, w, g, precision, act):
    """(y, gx, gw) through the port's autograd Function."""
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = ops.scatter_gather_linear(xt, wt, csr, precision, act)
    y.backward(torch.as_tensor(g))
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_versions_bitwise_vs_roc_tpu_on_integers(act, seed,
                                                       monkeypatch):
    n, t, e, h, ho = 96, 128, 800, 64, 32
    src, dst, x, w = _dom_graph(n, t, e, h, ho, 800, -4, 4, -3, 3, seed)
    g = np.random.default_rng(seed + 50).integers(-3, 4, (n, ho)) \
        .astype(np.float32)
    want = _jax_layer(src, dst, n, t, x, w, g, "exact", act, monkeypatch)
    csr = _device_csr(src, dst, n, t)
    for got in (_port_plain(csr, x, w, g, "exact", act),
                _port_autograd(csr, x, w, g, "exact", act)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_plain_versions_match_roc_tpu_on_gaussian(precision, act,
                                                  monkeypatch):
    n = t = 500
    e, h, ho = 3500, 48, 24
    rng = np.random.default_rng(5)
    src = rng.integers(0, t, e).astype(np.int64)
    dst = rng.integers(0, n, e).astype(np.int64)
    dst[: e // 4] = 7            # a hub destination
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    x = rng.standard_normal((t, h)).astype(np.float32)
    w = rng.standard_normal((h, ho)).astype(np.float32)
    g = rng.standard_normal((n, ho)).astype(np.float32)
    want = _jax_layer(src, dst, n, t, x, w, g, precision, act, monkeypatch)
    csr = _device_csr(src, dst, n, t)
    for got in (_port_plain(csr, x, w, g, precision, act),
                _port_autograd(csr, x, w, g, precision, act)):
        for a, b in zip(got, want):
            assert _row_rel_err(a, b) <= 1e-5


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_versions_bitwise_vs_roc_tpu_on_integers_fast(act, seed,
                                                            monkeypatch):
    """The dominance fixture in "fast": its integers are bf16-exact, so the
    one rounding of the staged cotangent changes nothing on either side."""
    n, t, e, h, ho = 96, 128, 800, 64, 32
    src, dst, x, w = _dom_graph(n, t, e, h, ho, 800, -4, 4, -3, 3, seed)
    g = np.random.default_rng(seed + 50).integers(-3, 4, (n, ho)) \
        .astype(np.float32)
    want = _jax_layer(src, dst, n, t, x, w, g, "fast", act, monkeypatch)
    csr = _device_csr(src, dst, n, t)
    for got in (_port_plain(csr, x, w, g, "fast", act),
                _port_autograd(csr, x, w, g, "fast", act)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("h,ho,act", [(602, 256, "relu"), (256, 41, "none")])
def test_plain_forward_bitwise_vs_roc_tpu_at_ragged_widths(h, ho, act,
                                                           precision,
                                                           monkeypatch):
    """The widths whose rows fill no whole 16-byte pack: 602 % 4 == 2 (fp32)
    and 602 % 8 == 2, 41 % 8 == 1 (bf16), so the card stages x into a padded
    plane and pads W to whole packs.  On the dominance fixture's integers
    (every sum exact in fp32) the plain forward, and the staged plane's twin
    summed in exact then multiplied (the card's arithmetic), both equal
    roc_tpu's interpreted megakernel forward bit for bit (a spy asserts
    the Pallas megakernel ran, not the two-pass fallback)."""
    n, t, e = 48, 64, 400
    M = 8000 if h == 602 else 4000
    src, dst, x, w = _dom_graph(n, t, e, h, ho, M, -4, 4, -3, 3, 7)
    plans = jops.build_binned_plans(src, dst, n, t, geom=GF)
    calls, mega_run = [], B._mega_run
    monkeypatch.setattr(
        B, "_mega_run",
        lambda *a, **k: (calls.append(1), mega_run(*a, **k))[1])
    want = np.asarray(jops.scatter_gather_linear_binned(
        jnp.asarray(x), jnp.asarray(w), plans, True, precision, act))
    assert calls, "roc_tpu's megakernel forward fell back to two passes"
    csr = _device_csr(src, dst, n, t)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    got = KL.aggregate_linear_plain(xt, wt, csr.row_ptr, csr.col_idx,
                                    precision, act)
    np.testing.assert_array_equal(got.numpy(), want)
    if precision == "fast":
        staged = aggregate_sum_plain(stage_plain(xt).float(), csr.row_ptr,
                                     csr.col_idx, "exact")[:, :h]
        np.testing.assert_array_equal(ops.linear(staged, wt, act).numpy(),
                                      want)


def _old_bwd_u(g, y, t_row_ptr, t_col_idx, precision, relu):
    """The backward's u as the plain version computed it before the
    cotangent was staged: the mask, then the sum at the precision (one
    bf16 rounding of each gathered element in "fast")."""
    gm = torch.where(y > 0, g, torch.zeros_like(g)) if relu else g
    return aggregate_sum_plain(gm, t_row_ptr, t_col_idx, precision)


def _int32(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_staged_cotangent_sums_to_the_old_per_edge_mask_and_round(precision,
                                                                   relu):
    """u from the staged plane (masked and rounded once per source row)
    equals u from the old per-edge mask and round, bit for bit, with NaN
    and -0.0 in g and ties (y == +-0) in y."""
    rng = np.random.default_rng(17)
    n, e, ho = 80, 900, 19
    src = rng.integers(0, n, e)
    dst = np.sort(rng.integers(0, n, e))
    csr = _device_csr(src, dst, n, n)
    g = torch.as_tensor(rng.standard_normal((n, ho)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((n, ho)).astype(np.float32))
    g[3, 2], g[4, 1], g[5, :4], g[7, 1] = float("nan"), float("nan"), \
        -0.0, 1e-40
    # g[3, 2]'s NaN passes the mask, g[4, 1]'s is masked off
    y[3, 2], y[4, 1], y[5, 1], y[9, :3], y[3, 0] = 1.0, -1.0, 0.0, -0.0, 0.0
    staged = KL.stage_cotangent_plain(g, y, precision, relu)
    assert staged.dtype == torch.float32
    got = aggregate_sum_plain(staged, csr.t_row_ptr, csr.t_col_idx, "exact")
    via_bwd, _ = KL.aggregate_linear_bwd_plain(
        g, y, torch.ones(4, ho), csr.t_row_ptr, csr.t_col_idx, precision,
        relu, need_dx=False)
    want = _old_bwd_u(g, y, csr.t_row_ptr, csr.t_col_idx, precision, relu)
    assert torch.isnan(want).any()
    for u in (got, via_bwd):
        assert torch.equal(torch.isnan(u), torch.isnan(want))
        keep = ~torch.isnan(want)
        assert torch.equal(_int32(u)[keep], _int32(want)[keep])
    # the staged -0.0 survives the mask and the rounding where y > 0
    assert torch.equal(_int32(staged[5, 2:4]),
                       _int32(torch.where(y[5, 2:4] > 0, -0.0, 0.0)
                              if relu else torch.full((2,), -0.0)))


def test_stage_cotangent_takes_the_plain_version_on_the_cpu():
    g = torch.tensor([[1.0 + 2 ** -12, -2.0, float("nan")]])
    y = torch.tensor([[1.0, 0.0, 3.0]])
    got = KL.stage_cotangent(g, y, "fast", True)
    assert torch.equal(got[:, :2], torch.tensor([[1.0, 0.0]]))
    assert torch.isnan(got[0, 2])
    assert torch.equal(KL.stage_cotangent(g, y, "exact", False)[:, :2],
                       g[:, :2])
    assert KL.stage_cotangent.launches == 0      # the CPU never launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        KL.stage_cotangent(g.to("meta"), y.to("meta"), "fast", True)
    with pytest.raises(ValueError, match="precision"):
        KL.stage_cotangent(g, y, "bf16", True)


def test_backward_skips_dx_when_the_input_takes_no_gradient():
    """A layer whose input needs no gradient (the first layer's dropout of
    the features) asks the backward for u alone; dW is unchanged."""
    rng = np.random.default_rng(3)
    n, e, h, ho = 64, 400, 12, 5
    src = rng.integers(0, n, e)
    dst = np.sort(rng.integers(0, n, e))
    csr = _device_csr(src, dst, n, n)
    x = torch.as_tensor(rng.standard_normal((n, h)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((h, ho)).astype(np.float32),
                     requires_grad=True)
    u, dx = KL.aggregate_linear_bwd_plain(
        torch.ones(n, ho), None, w.detach(), csr.t_row_ptr, csr.t_col_idx,
        "exact", need_dx=False)
    assert dx is None and u.shape == (n, ho)
    ops.scatter_gather_linear(x, w, csr, "exact", "relu").sum().backward()
    w2 = w.detach().clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    ops.scatter_gather_linear(x2, w2, csr, "exact", "relu").sum().backward()
    assert torch.equal(w.grad, w2.grad) and x2.grad is not None


def test_plain_versions_validate_inputs():
    csr = _device_csr([0, 1], [0, 1], 2, 2)
    x, w = torch.zeros(2, 3), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="activation"):
        KL.aggregate_linear(x, w, csr.row_ptr, csr.col_idx, "exact", "elu")
    with pytest.raises(ValueError, match="precision"):
        KL.aggregate_linear(x, w, csr.row_ptr, csr.col_idx, "bf16")
    with pytest.raises(ValueError, match="float32"):
        KL.aggregate_linear(x.double(), w, csr.row_ptr, csr.col_idx)
    with pytest.raises(ValueError, match="cuda or cpu"):
        KL.aggregate_linear(x.to("meta"), w.to("meta"),
                            csr.row_ptr.to("meta"), csr.col_idx.to("meta"))
    assert KL.aggregate_linear.launches == 0     # the CPU never launches
    assert KL.aggregate_linear_bwd.launches == 0


def _chain_models(model_cls):
    """A hand-built aggregate -> linear -> relu chain (the direct shape),
    then a second layer whose linear carries its own relu."""
    m = model_cls(8)
    t = m.scatter_gather(m.input, "sum")
    t = m.relu(m.linear(t, 16))
    m.end_layer()
    t = m.scatter_gather(t, "avg")
    t = m.linear(t, 4, activation="relu")
    m.end_layer()
    m.softmax_cross_entropy(t)
    return m


def _records(found):
    return {i: (r["aggregate"].out, r["linear"].attrs["param"],
                r["activation"], r["final"].out, r["skip"], r["fold"],
                r["gone"]) for i, r in found.items()}


@pytest.mark.parametrize("layers", [[8, 16, 4], [8, 16, 16, 4],
                                    [602, 256, 41], "chain"])
def test_mega_matches_equal_roc_tpu(layers):
    if layers == "chain":
        ours, ref = _chain_models(Model), _chain_models(JModel)
    else:
        ours, ref = build_gcn(layers, 0.5), jbuild_gcn(layers, 0.5)
    got, want = _records(mega_matches(ours)), _records(jmega_matches(ref))
    assert got == want and got
    if layers == "chain":
        assert {r[5] for r in got.values()} == {False}
    else:
        assert {r[5] for r in got.values()} == {True}
        assert len(got) == len(layers) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_kernels_match_plain_on_card(precision):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    n, e = 3000, 40000
    src = rng.integers(0, n, e)
    dst = np.sort(rng.integers(0, n, e))
    cpu = _device_csr(src, dst, n, n)
    csr = ops.DeviceCsr(*(a.cuda() for a in cpu))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, ho, act in ((602, 256, "relu"), (256, 41, "none")):
        relu = act == "relu"
        for integer in (True, False):
            if integer:
                x = torch.randint(0, 2, (n, h), generator=gen, device="cuda")
                w = torch.randint(-2, 3, (h, ho), generator=gen,
                                  device="cuda")
                g = torch.randint(-3, 4, (n, ho), generator=gen,
                                  device="cuda")
                x, w, g = x.float(), w.float(), g.float()
            else:
                x = torch.randn((n, h), generator=gen, device="cuda")
                w = torch.randn((h, ho), generator=gen, device="cuda")
                g = torch.randn((n, ho), generator=gen, device="cuda")
            y = KL.aggregate_linear(x, w, csr.row_ptr, csr.col_idx,
                                    precision, act)
            y0 = KL.aggregate_linear_plain(x, w, csr.row_ptr, csr.col_idx,
                                           precision, act)
            got = KL.aggregate_linear_bwd(g, y0, w, csr.t_row_ptr,
                                          csr.t_col_idx, precision, relu)
            want = KL.aggregate_linear_bwd_plain(
                g, y0, w, csr.t_row_ptr, csr.t_col_idx, precision, relu)
            for a, b in ((y, y0), *zip(got, want)):
                if integer:
                    assert torch.equal(a, b)
                else:
                    assert _row_rel_err(a.cpu(), b.cpu()) <= 1e-5
