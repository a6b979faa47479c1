"""The port's cross-layer fusion regions (roc_tpu_torch) against roc_tpu's.

The region kernels' plain versions (``xlayer_fwd_plain``,
``xlayer_bwd_plain``), the autograd Function around them
(``ops.region_linear``), the ``mega_regions`` planner, the ``-fusion-depth``
flag, the trainer on the region path and the frozen forward under
``-megafuse`` are held against roc_tpu: ``jax.vjp`` of
``region_linear_binned`` in interpret mode on plans built with the flat
geometry of tests/test_mega_xlayer.py (a spy on ``_xlayer_run`` and
``_xlayer_bwd_run`` proves the JAX region kernels ran), its planner and its
trainer.  On the CPU the port's wrappers run the plain versions; the CUDA
kernels are held against them on the card by chip_smoke.py and the
``cuda``-marked test below.

Tolerances:
  integer data (tests/test_mega_xlayer.py's     bitwise: every sum is exact,
  bounded chain, in-degrees 1 or 4, so the      and both round each gathered
  scales are 1 or 1/2)                          element once in fast
  Gaussian data, exact                          1e-5 of each row's max-abs:
                                                fp32 sums and GEMMs in
                                                another order
  3-epoch trainer vs roc_tpu's                  1e-5 relative final loss,
                                                1e-5 of each logits row's
                                                max-abs
  served logits vs roc_tpu's frozen forward     1e-5 exact, 5e-3 fast (the
                                                serving slice's bounds)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roc_tpu import ops as jops
from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild_model
from roc_tpu.models.model import mega_regions as jmega_regions
from roc_tpu.ops.pallas import binned as B
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.config import parse_args as jparse_args
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu.train.frozen import load_frozen as jload_frozen
from roc_tpu_torch import ops
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_model, mega_regions
from roc_tpu_torch.ops import aggregate as agg_mod
from roc_tpu_torch.ops.kernels import xlayer as KX
from roc_tpu_torch.ops.linear import linear
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config, parse_args
from roc_tpu_torch.train.driver import Trainer
from roc_tpu_torch.train.frozen import load_frozen

GF = B.Geometry(sb=256, ch=512, slot=128, rb=256, ch2=512, grt=1 << 14,
                flat=1)


@pytest.fixture(autouse=True)
def _binned_runs_under_jax_0_9(monkeypatch):
    """run_binned's one-shot eager warning calls jax.core.trace_state_clean,
    which jax 0.9.0 no longer exports; marking the warning as given skips
    the call (ROADMAP queue C)."""
    monkeypatch.setattr(B, "_EAGER_WARNED", [True])
    for var in ("ROC_XLAYER", "ROC_MEGA_BWD", "ROC_BINNED_NO_FUSE"):
        monkeypatch.delenv(var, raising=False)


def _spy(monkeypatch, mod, name, calls, key):
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: (
        calls.__setitem__(key, calls[key] + 1), orig(*a, **k))[1])


def _jax_spies(monkeypatch) -> dict:
    calls = {"fwd": 0, "bwd": 0}
    _spy(monkeypatch, B, "_xlayer_run", calls, "fwd")
    _spy(monkeypatch, B, "_xlayer_bwd_run", calls, "bwd")
    return calls


def _row_rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).max(axis=1)
    s = np.abs(want).max(axis=1)
    return float(np.where(d == 0, 0.0, d / np.where(s == 0, 1.0, s)).max())


def _device_csr(src, dst, n) -> ops.DeviceCsr:
    """Both directions of a square edge list (dst sorted)."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    rp = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=rp[1:])
    order = np.argsort(src, kind="stable")
    trp = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=trp[1:])
    return ops.DeviceCsr(torch.as_tensor(rp), torch.as_tensor(
        src.astype(np.int32)), torch.as_tensor(trp),
        torch.as_tensor(dst[order].astype(np.int32)))


def _chain_graph(depth, seed, n=256, h=8, lo=-1, hi=1):
    """tests/test_mega_xlayer.py's bounded integer chain: in-degrees 1 or 4
    (so rsqrt(deg) is 1 or 1/2, exact) and magnitudes small enough that
    every partial sum stays an exact fp32 integer at this depth."""
    rng = np.random.default_rng(seed)
    reps = np.ones(n, np.int64)
    reps[rng.permutation(n)[:n // 4]] = 4
    dst = np.repeat(np.arange(n, dtype=np.int64), reps)
    src = rng.integers(0, n, int(dst.shape[0])).astype(np.int64)
    x = rng.integers(0, 2, (n, h)).astype(np.float32)
    ws = tuple(rng.integers(lo, hi + 1, (h, h)).astype(np.float32)
               for _ in range(depth))
    g = rng.integers(lo, hi + 1, (n, h)).astype(np.float32)
    return src, dst, x, ws, g, reps.astype(np.float32)


def _jax_region(src, dst, x, ws, g, deg, precision, acts, fold,
                monkeypatch):
    """(y, dx, dws) through roc_tpu's region custom VJP, interpret mode;
    asserts both region kernels ran."""
    n = x.shape[0]
    plans = jops.build_binned_plans(src, dst, n, n, geom=GF)
    calls = _jax_spies(monkeypatch)
    y, vjp = jax.vjp(
        lambda xx, wws: jops.region_linear_binned(
            xx, wws, jnp.asarray(deg), plans, True, precision, acts, fold),
        jnp.asarray(x), tuple(jnp.asarray(w) for w in ws))
    dx, dws = vjp(jnp.asarray(g))
    assert calls["fwd"] and calls["bwd"], "roc_tpu's region kernels declined"
    return (np.asarray(y), np.asarray(dx), *(np.asarray(d) for d in dws))


def _port_autograd(csr, x, ws, g, deg, precision, acts, fold):
    """(y, dx, dws) through the port's autograd Function."""
    xt = torch.tensor(x, requires_grad=True)
    wts = [torch.tensor(w, requires_grad=True) for w in ws]
    y = ops.region_linear(xt, wts, torch.as_tensor(deg), csr, precision,
                          acts, fold)
    y.backward(torch.as_tensor(g))
    return (y.detach().numpy(), xt.grad.numpy(),
            *(w.grad.numpy() for w in wts))


def _port_plain(csr, x, ws, g, deg, precision, acts, fold):
    """(y, dx, dws) from the two plain versions called directly."""
    x, g = torch.as_tensor(x), torch.as_tensor(g)
    ws = [torch.as_tensor(w) for w in ws]
    scale = torch.rsqrt(torch.as_tensor(deg)) if fold else None
    y = KX.xlayer_fwd_plain(x, ws, scale, csr.row_ptr, csr.col_idx,
                            precision, acts)
    dx, dws = KX.xlayer_bwd_plain(g, y, x, ws, scale, csr.row_ptr,
                                  csr.col_idx, csr.t_row_ptr, csr.t_col_idx,
                                  precision, acts)
    return (y.numpy(), dx.numpy(), *(d.numpy() for d in dws))


def _chains(depth):
    return {"relu": tuple("relu" if d < depth - 1 else "none"
                          for d in range(depth)),
            "none": ("none",) * depth}


# -- the region function: plain versions and autograd vs roc_tpu -----------

@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("depth", [2, 3])
def test_region_bitwise_vs_roc_tpu_on_integers(depth, fold, precision,
                                               monkeypatch):
    """Forward, dx and every dW bitwise on the bounded integer chain, for
    the relu chain and the activation-free chain."""
    src, dst, x, ws, g, deg = _chain_graph(depth, seed=3 + depth)
    csr = _device_csr(src, dst, x.shape[0])
    for acts in _chains(depth).values():
        want = _jax_region(src, dst, x, ws, g, deg, precision, acts, fold,
                           monkeypatch)
        for got in (_port_plain(csr, x, ws, g, deg, precision, acts, fold),
                    _port_autograd(csr, x, ws, g, deg, precision, acts,
                                   fold)):
            assert len(got) == len(want) == depth + 2
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def _gauss_case(seed=11, n=512, e=3000, h=64, depth=2):
    """tests/test_mega_xlayer.py's continuous depth-2 shape (every row has
    a self edge, so every in-degree is >= 1)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int64)
    dst = np.sort(np.concatenate([np.arange(n, dtype=np.int64),
                                  rng.integers(0, n, e - n)]))
    x = rng.standard_normal((n, h)).astype(np.float32)
    ws = tuple(rng.standard_normal((h, h)).astype(np.float32)
               for _ in range(depth))
    g = rng.standard_normal((n, h)).astype(np.float32)
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    return src, dst, x, ws, g, deg


@pytest.mark.parametrize("fold", [False, True])
def test_region_matches_roc_tpu_on_gaussian(fold, monkeypatch):
    src, dst, x, ws, g, deg = _gauss_case()
    acts = ("relu", "none")
    want = _jax_region(src, dst, x, ws, g, deg, "exact", acts, fold,
                       monkeypatch)
    csr = _device_csr(src, dst, x.shape[0])
    for got in (_port_plain(csr, x, ws, g, deg, "exact", acts, fold),
                _port_autograd(csr, x, ws, g, deg, "exact", acts, fold)):
        for a, b in zip(got, want):
            assert _row_rel_err(a, b) <= 1e-5


@pytest.mark.parametrize("data", ["integer", "gaussian"])
@pytest.mark.parametrize("depth", [2, 3])
def test_plain_backward_matches_autograd_of_plain_forward(depth, data):
    """The plain backward, written out step by step, against
    torch.autograd of the plain forward, in exact (autograd's sum of a
    "fast" cotangent rounds once per sum, the kernel's contract once per
    element).  The integer chain has no relu: autograd of clamp_min passes
    the cotangent at a tie, the kernel's mask (> 0, the TPU kernel's rule)
    does not, and bounded integers tie often."""
    if data == "integer":
        src, dst, x, ws, g, deg = _chain_graph(depth, seed=20 + depth)
        acts = _chains(depth)["none"]
    else:
        src, dst, x, ws, g, deg = _gauss_case(seed=30 + depth, n=300,
                                              e=2000, h=16, depth=depth)
        acts = ("relu",) * depth
    csr = _device_csr(src, dst, x.shape[0])
    scale = torch.rsqrt(torch.as_tensor(deg))
    xt = torch.tensor(x, requires_grad=True)
    wts = [torch.tensor(w, requires_grad=True) for w in ws]
    y = KX.xlayer_fwd_plain(xt, wts, scale, csr.row_ptr, csr.col_idx,
                            "exact", acts)
    y.backward(torch.as_tensor(g))
    dx, dws = KX.xlayer_bwd_plain(
        torch.as_tensor(g), y.detach(), torch.as_tensor(x),
        [torch.as_tensor(w) for w in ws], scale, csr.row_ptr, csr.col_idx,
        csr.t_row_ptr, csr.t_col_idx, "exact", acts)
    for got, want in ((dx, xt.grad), *zip(dws, (w.grad for w in wts))):
        if data == "integer":
            assert torch.equal(got, want)
        else:
            assert _row_rel_err(got, want) <= 1e-5


def test_region_equals_the_per_layer_chain_and_skips_dx():
    """The region's plain versions run the per-layer chain's arithmetic:
    forward and gradients bitwise against ``_unfused_region`` (the
    megakernel per member, norm pair between members) on Gaussian data.  A
    region input that takes no gradient gets no dx; the dWs do not
    change."""
    src, dst, x, ws, g, deg = _gauss_case(seed=5, n=300, e=2500, h=24,
                                          depth=3)
    csr = _device_csr(src, dst, x.shape[0])
    acts = ("relu", "relu", "relu")
    outs = {}
    for fn in (ops.region_linear, ops._unfused_region):
        xt = torch.tensor(x, requires_grad=True)
        wts = [torch.tensor(w, requires_grad=True) for w in ws]
        y = fn(xt, wts, torch.as_tensor(deg), csr, "fast", acts, True)
        y.backward(torch.as_tensor(g))
        outs[fn] = (y.detach(), xt.grad, *(w.grad for w in wts))
    for a, b in zip(*outs.values()):
        assert torch.equal(a, b)
    dx, dws = KX.xlayer_bwd_plain(
        torch.as_tensor(g), outs[ops.region_linear][0], torch.as_tensor(x),
        [torch.as_tensor(w) for w in ws], torch.rsqrt(torch.as_tensor(deg)),
        csr.row_ptr, csr.col_idx, csr.t_row_ptr, csr.t_col_idx, "fast",
        acts, need_dx=False)
    assert dx is None
    for a, b in zip(dws, outs[ops.region_linear][2:]):
        assert torch.equal(a, b)


def _staging_case(depth, data, n=240, h=13, seed=50):
    """A random graph whose row 29 has no in-edges and no out-edges (a
    zero-degree row both ways), width 13 everywhere (not a multiple of 8:
    the staged planes carry 3 padding columns), every layer with relu and
    the norm pair."""
    rng = np.random.default_rng(seed + depth)
    src, dst = rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)
    keep = (src != 29) & (dst != 29)
    order = np.argsort(dst[keep], kind="stable")
    src, dst = src[keep][order], dst[keep][order]
    csr = _device_csr(src, dst, n)
    if data == "integer":
        x = rng.integers(0, 2, (n, h)).astype(np.float32)
        ws = [rng.integers(-1, 2, (h, h)).astype(np.float32)
              for _ in range(depth)]
        g = rng.integers(-1, 2, (n, h)).astype(np.float32)
    else:
        x = rng.standard_normal((n, h), dtype=np.float32)
        ws = [rng.standard_normal((h, h), dtype=np.float32) / h ** 0.5
              for _ in range(depth)]
        g = rng.standard_normal((n, h), dtype=np.float32)
    scale = torch.rsqrt(torch.clamp_min(torch.diff(csr.row_ptr).float(),
                                        1.0))
    return (csr, torch.as_tensor(x), [torch.as_tensor(w) for w in ws],
            torch.as_tensor(g), scale)


def _gather_staged(plane, row_ptr, col_idx, h):
    """A staged plane summed in exact over its full padded width: the
    padding columns sum to 0 and are cut off."""
    out = ops.kernels.aggregate_sum.aggregate_sum_plain(
        plane.float(), row_ptr, col_idx, "exact")
    assert plane.shape[1] > h and torch.equal(
        out[:, h:], torch.zeros_like(out[:, h:]))
    return out[:, :h]


@pytest.mark.parametrize("data", ["integer", "gaussian"])
@pytest.mark.parametrize("depth", [2, 3])
def test_staged_planes_give_the_fast_sums_bitwise(depth, data):
    """The card's region kernels round once per source row, where each
    gathered element is formed: x staged to a padded bf16 plane, the
    forward's planes stored as bf16, the last cotangent staged, and each
    interior one written by the hand-off epilogue.  The staging twins
    (``stage_plain``, ``handoff_plain``) gathered in exact give, bitwise,
    the sums of ``aggregate_sum_plain(..., "fast")`` over the unstaged
    values, and so the plain versions' forward, dx and every dW."""
    csr, x, ws, g, scale = _staging_case(depth, data)
    acts, h = ("relu",) * depth, x.shape[1]
    rp, ci, trp, tci = csr.row_ptr, csr.col_idx, csr.t_row_ptr, csr.t_col_idx
    xs = KX.stage_plain(x, None, "fast")
    assert xs.dtype == torch.bfloat16 and xs.shape == (x.shape[0], 16)
    assert torch.equal(_gather_staged(xs, rp, ci, h),
                       ops.kernels.aggregate_sum.aggregate_sum_plain(
                           x, rp, ci, "fast"))
    # forward, the kernel's way: bf16 planes between the layers
    src, planes = xs, []
    for l in range(depth):
        t = linear(_gather_staged(src, rp, ci, h), ws[l], acts[l])
        if l + 1 < depth:
            t = KX._scaled(t, scale)
            planes.append(t)
            src = KX.stage_plain(t, None, "fast")
    y = KX.xlayer_fwd_plain(x, ws, scale, rp, ci, "fast", acts)
    assert torch.equal(t, y) and bool((y[29] == 0).all())
    # backward: the staged cotangent, then each hand-off's
    dws = [None] * depth
    s = KX.stage_plain(g, y, "fast")
    for l in reversed(range(depth)):
        u = _gather_staged(s, trp, tci, h)
        dws[l] = linear((x if l == 0 else planes[l - 1]).t(), u)
        v = linear(u, ws[l].t())
        if l > 0:
            s = KX.handoff_plain(v, scale, planes[l - 1], "fast")
    dx, want = KX.xlayer_bwd_plain(g, y, x, ws, scale, rp, ci, trp, tci,
                                   "fast", acts)
    assert torch.equal(v, dx)
    for a, b in zip(dws, want):
        assert torch.equal(a, b)


def test_staged_padding_never_reaches_a_real_column():
    """The padding columns of a staged plane are written as 0, and a
    column's sum reads only that column: NaN in every padding column
    leaves the real columns' sums bitwise as they were."""
    csr, x, ws, g, scale = _staging_case(3, "gaussian")
    h = x.shape[1]
    for plane, rp, ci in ((KX.stage_plain(x, None, "fast"), csr.row_ptr,
                           csr.col_idx),
                          (KX.handoff_plain(g, scale, x, "exact"),
                           csr.t_row_ptr, csr.t_col_idx)):
        assert torch.equal(plane[:, h:], torch.zeros_like(plane[:, h:]))
        clean = _gather_staged(plane, rp, ci, h)
        poisoned = plane.clone()
        poisoned[:, h:] = float("nan")
        got = ops.kernels.aggregate_sum.aggregate_sum_plain(
            poisoned.float(), rp, ci, "exact")
        assert torch.equal(got[:, :h], clean)
        assert bool(torch.isnan(got[:, h:]).any())


def test_region_inputs_are_validated():
    src, dst, x, ws, g, deg = _chain_graph(2, seed=1)
    csr = _device_csr(src, dst, x.shape[0])
    x, ws = torch.as_tensor(x), [torch.as_tensor(w) for w in ws]
    args = (csr.row_ptr, csr.col_idx)
    with pytest.raises(ValueError, match="2 to 8"):
        KX.xlayer_fwd(x, ws[:1], None, *args, "exact", ("relu",))
    with pytest.raises(ValueError, match="activations"):
        KX.xlayer_fwd(x, ws, None, *args, "exact", ("relu", "elu"))
    with pytest.raises(ValueError, match="square"):
        KX.xlayer_fwd(x[:-1], ws, None, *args, "exact", ("none", "none"))
    with pytest.raises(ValueError, match="weight chain"):
        KX.xlayer_fwd(x, [ws[0], ws[1][:5]], None, *args, "exact",
                      ("none", "none"))
    with pytest.raises(ValueError, match="precision"):
        KX.xlayer_fwd(x, ws, None, *args, "bf16", ("none", "none"))
    with pytest.raises(ValueError, match="float32"):
        KX.xlayer_fwd(x.double(), ws, None, *args, "exact",
                      ("none", "none"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        KX.xlayer_fwd(x.to("meta"), [w.to("meta") for w in ws], None,
                      *(a.to("meta") for a in args), "exact",
                      ("none", "none"))
    assert KX.xlayer_fwd.launches == 0 and KX.xlayer_bwd.launches == 0


# -- the planner -------------------------------------------------------------

def _records(found):
    def member(m):
        return (m["aggregate"].out, m["linear"].attrs["param"],
                m["activation"], m["final"].out, m["skip"], m["fold"],
                m["gone"])
    return {i: (tuple(member(m) for m in r["members"]), r["final"].out,
                r["fold"], r["skip"], r["gone"]) for i, r in found.items()}


# (model, layers, dropout, max_depth, train, expected region depths)
PLANS = [("gcn-chain", [64, 16, 16, 16, 8], 0.0, 0, False, [3]),
         ("gcn-chain", [64, 16, 16, 16, 8], 0.0, 1, False, []),
         ("gcn-chain", [64, 16, 16, 16, 8], 0.0, 2, False, [2]),
         ("gcn-chain", [64, 16, 16, 16, 16, 8], 0.0, 3, False, [3]),
         ("gcn-chain", [64, 16, 16, 16, 16, 16, 8], 0.0, 2, False, [2, 2]),
         ("gcn", [64, 16, 16, 16, 8], 0.0, 0, False, []),
         ("sage", [64, 16, 16, 8], 0.0, 0, False, []),
         ("gin", [64, 16, 16, 8], 0.0, 0, False, []),
         ("gcn-chain", [64, 16, 16, 16, 8], 0.5, 0, True, []),
         ("gcn-chain", [64, 16, 16, 16, 8], 0.0, 0, True, [3]),
         ("gcn-chain", [64, 16, 16, 16, 8], 0.5, 0, False, [3])]


@pytest.mark.parametrize("case", PLANS, ids=lambda c: "-".join(
    map(str, (c[0], len(c[1]), c[2], c[3], "train" if c[4] else "eval"))))
def test_mega_regions_equal_roc_tpu(case):
    name, layers, rate, max_depth, train, depths = case
    got = _records(mega_regions(build_model(name, layers, rate), max_depth,
                                train))
    want = _records(jmega_regions(jbuild_model(name, layers, rate),
                                  max_depth, train))
    assert got == want
    assert [len(r[0]) for _, r in sorted(got.items())] == depths


# -- the flag ----------------------------------------------------------------

def test_fusion_depth_flag_matches_roc_tpu():
    for argv in ([], ["-megafuse", "-fusion-depth", "0"],
                 ["-fusion-depth", "3"]):
        assert parse_args(argv).fusion_depth == \
            jparse_args(argv).fusion_depth
    with pytest.raises(SystemExit, match="bad fusion_depth -1"):
        parse_args(["-fusion-depth", "-1"])
    with pytest.raises(SystemExit, match="bad fusion_depth -2"):
        Config(fusion_depth=-2)


# -- the slice as a whole: the trainer ---------------------------------------

BASE = dict(num_epochs=3, learning_rate=0.01, weight_decay=5e-4,
            dropout_rate=0.0, eval_every=1000, aggregate_backend="binned",
            aggregate_precision="exact", megafuse=True)
CHAIN = [64, 16, 16, 8]


def _quiet(*a, **k):
    pass


def _jax_trainer(fusion_depth, **kw):
    cfg = JConfig(dataset="mega-shard", layers=CHAIN,
                  fusion_depth=fusion_depth, **{"seed": 1, **BASE, **kw})
    return JTrainer(cfg, jdatasets.get("mega-shard", seed=1),
                    jbuild_model("gcn-chain", CHAIN, cfg.dropout_rate))


def _port_trainer(fusion_depth, **kw):
    cfg = Config(dataset="mega-shard", layers=CHAIN, device="cpu",
                 fusion_depth=fusion_depth, **{"seed": 1, **BASE, **kw})
    return Trainer(cfg, datasets.get("mega-shard", seed=1),
                   build_model("gcn-chain", CHAIN, cfg.dropout_rate))


def _carry(jtr, tr):
    tr.params = checkpoint.params_from_jax(
        {k: np.asarray(v) for k, v in jtr.params.items()}, "cpu")
    tr.opt_state = checkpoint.opt_state_from_jax(
        jax.device_get(jtr.opt_state), "cpu")


def _port_spies(monkeypatch) -> dict:
    calls = {"fwd": 0, "bwd": 0, "mega": 0}
    _spy(monkeypatch, KX, "xlayer_fwd_plain", calls, "fwd")
    _spy(monkeypatch, KX, "xlayer_bwd_plain", calls, "bwd")
    _spy(monkeypatch, agg_mod, "aggregate_linear", calls, "mega")
    return calls


def test_trainer_on_the_region_path_tracks_roc_tpu(monkeypatch):
    """3 epochs of gcn-chain 64-16-16-8 with -megafuse -fusion-depth 0 from
    the same initial params: the two hidden layers run as one region (1
    region forward and 1 backward a step), the logits layer per layer."""
    monkeypatch.setenv("ROC_BINNED_GEOM", "flat")
    jtr, tr = _jax_trainer(0), _port_trainer(0)
    _carry(jtr, tr)
    jcalls = _jax_spies(monkeypatch)
    calls = _port_spies(monkeypatch)
    jstats = jtr.train(print_fn=_quiet)
    stats = tr.train(print_fn=_quiet)
    want = np.asarray(jtr.predict_logits())
    got = tr.predict_logits().numpy()
    assert jcalls["fwd"] and jcalls["bwd"]
    # per step 1 region forward + 1 backward + 1 megakernel; the eval at
    # epoch 0 and predict_logits add a forward each
    assert calls == {"fwd": 3 + 2, "bwd": 3, "mega": 3 + 2}
    loss_gap = abs(stats.final_loss - jstats.final_loss) \
        / abs(jstats.final_loss)
    print(f"port vs roc_tpu on the region path after 3 epochs: final loss "
          f"{loss_gap:.2e} relative, logits {_row_rel_err(got, want):.2e} "
          f"of the row max-abs")
    assert np.isfinite(got).all() and loss_gap <= 1e-5
    assert _row_rel_err(got, want) <= 1e-5


def test_region_path_equals_the_per_layer_path(monkeypatch):
    """The port at -fusion-depth 0 against -fusion-depth 1 on the same data:
    the region's plain versions run the per-layer chain's arithmetic, so
    the losses and logits are the same bits."""
    out = {}
    for depth in (0, 1):
        calls = _port_spies(monkeypatch)
        tr = _port_trainer(depth)
        stats = tr.train(print_fn=_quiet)
        out[depth] = (stats.final_loss, tr.predict_logits())
        assert (calls["fwd"] > 0) == (depth == 0)
        monkeypatch.undo()
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("direction", ["roc_tpu_to_port", "port_to_roc_tpu"])
def test_region_checkpoint_across_packages(tmp_path, direction,
                                           monkeypatch):
    """Regions reuse the ``linear_{i}`` parameters: a gcn-chain checkpoint
    written by one package loads into the other and gives the same
    region-path logits (eval: the dropout between members is the
    identity)."""
    monkeypatch.setenv("ROC_BINNED_GEOM", "flat")
    path = str(tmp_path / "chain.npz")
    jtr = _jax_trainer(0, dropout_rate=0.5)
    tr = _port_trainer(0, dropout_rate=0.5, seed=2)
    if direction == "roc_tpu_to_port":
        jtr.save_checkpoint(path)
        tr.restore(path)
    else:
        tr.save_checkpoint(path)
        jtr.restore(path)
    jcalls = _jax_spies(monkeypatch)
    calls = _port_spies(monkeypatch)
    want = np.asarray(jtr.predict_logits())
    got = tr.predict_logits().numpy()
    assert jcalls["fwd"] == 1 and calls["fwd"] == 1
    assert _row_rel_err(got, want) <= 1e-5


# -- the frozen forward under -megafuse --------------------------------------

@pytest.mark.parametrize("precision,tol", [("exact", 1e-5), ("fast", 5e-3)])
def test_frozen_forward_runs_the_megakernel(precision, tol, monkeypatch):
    """``load_frozen`` under ``megafuse`` serves through the megakernel (a
    spy counts one launch per GCN layer) and equals roc_tpu's frozen
    forward under ``megafuse``, whose megakernel ran too."""
    monkeypatch.setenv("ROC_BINNED_GEOM", "flat")
    layers = [8, 16, 4]
    kw = dict(dataset="roc-audit", layers=layers, dropout_rate=0.0,
              aggregate_backend="binned", aggregate_precision=precision,
              megafuse=True)
    jcfg = JConfig(**kw)
    jb = jload_frozen(jcfg, jdatasets.get("roc-audit"),
                      jbuild_model("gcn", layers, 0.0))
    jcalls = {"mega": 0}
    _spy(monkeypatch, B, "_mega_run", jcalls, "mega")
    want = np.asarray(jb.predict_logits())
    bundle = load_frozen(Config(**kw), datasets.get("roc-audit"),
                         build_model("gcn", layers, 0.0), device="cpu",
                         params=checkpoint.params_from_jax(
                             {k: np.asarray(v) for k, v in jb.params.items()},
                             "cpu"))
    calls = _port_spies(monkeypatch)
    got = bundle.predict_logits().numpy()
    assert bundle.megafuse and jcalls["mega"] == 2
    assert calls == {"fwd": 0, "bwd": 0, "mega": 2}
    assert _row_rel_err(got, want) <= tol


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_kernels_match_plain_on_card(precision):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    for depth, fold in ((2, False), (3, True)):
        src, dst, x, ws, g, deg = _chain_graph(depth, seed=40 + depth,
                                               n=3000)
        csr = ops.DeviceCsr(*(a.cuda() for a in _device_csr(src, dst,
                                                             x.shape[0])))
        x, g = torch.as_tensor(x).cuda(), torch.as_tensor(g).cuda()
        ws = [torch.as_tensor(w).cuda() for w in ws]
        scale = torch.rsqrt(torch.as_tensor(deg).cuda()) if fold else None
        acts = _chains(depth)["relu"]
        args = (csr.row_ptr, csr.col_idx)
        y = KX.xlayer_fwd(x, ws, scale, *args, precision, acts)
        y0 = KX.xlayer_fwd_plain(x, ws, scale, *args, precision, acts)
        targs = (g, y0, x, ws, scale, *args, csr.t_row_ptr, csr.t_col_idx,
                 precision, acts)
        dx, dws = KX.xlayer_bwd(*targs)
        dx0, dws0 = KX.xlayer_bwd_plain(*targs)
        dx1, dws1 = KX.xlayer_bwd(*targs)
        for a, b in ((y, y0), (dx, dx0), *zip(dws, dws0)):
            assert torch.equal(a, b)
        for a, b in ((dx, dx1), *zip(dws, dws1)):
            assert torch.equal(a, b)
