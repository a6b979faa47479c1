"""-bf16 and -bf16-storage in the port against roc_tpu.

Same seeded numpy inputs (or the same dataset and seed) through roc_tpu and
through the port on the CPU; roc_tpu's binned backend runs its Pallas
kernels in interpret mode.

Tolerances:
  dropout on bf16, forward and VJP          bitwise (rates 0.1, 0.3, 0.5)
  bf16 linear, forward                      bitwise
  bf16 linear, VJP                          one bf16 ulp of each element
                                            (the backward GEMMs' sums in
                                            another order)
  op output dtypes, five models             equal
  3-epoch -bf16 Trainer, final loss         max(the spread between
                                            roc_tpu's own xla and matmul
                                            -bf16 runs, 2e-3) relative;
                                            measured on this CPU: 0 (xla)
                                            and 7.6e-8 (binned), with a
                                            spread of 0
  -bf16-storage on one device, fast         bitwise, as in roc_tpu
  served rows vs eval under -bf16           32 ULPs (serve/parity.py)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roc_tpu import ops as jops
from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild_model
from roc_tpu.ops.dropout import dropout as jdropout
from roc_tpu.ops.linear import linear as jlinear
from roc_tpu.train import driver as jdriver
from roc_tpu.train.config import Config as JConfig
from roc_tpu_torch import ops
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_model
from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.kernels.dropout import divisor, dropout_plain
from roc_tpu_torch.ops.linear import linear
from roc_tpu_torch.serve import ServeEngine, max_ulp_diff
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer
from roc_tpu_torch.train.frozen import load_frozen
from roc_tpu_torch.train.graph_data import make_gctx


@pytest.fixture(autouse=True)
def _binned_runs_under_jax_0_9(monkeypatch):
    """run_binned's one-shot eager warning calls jax.core.trace_state_clean,
    which jax 0.9.0 no longer exports; marking the warning as given skips
    the call (ROADMAP queue C)."""
    from roc_tpu.ops.pallas import binned
    monkeypatch.setattr(binned, "_EAGER_WARNED", [True])


def _bits(a) -> np.ndarray:
    """The raw bits of a bf16 or fp32 array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _quiet(*a, **k):
    pass


# -- dropout and linear -------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_bf16_dropout_matches_roc_tpu(rate):
    """Rate 0.1 is the case that catches a fp32 divisor: roc_tpu divides a
    bf16 x by bf16(1 - rate)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((333, 257)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(1), 4),
                              0)
    key = prng.fold_in(prng.fold_in(prng.prng_key(1), 4), 0)
    out, vjp = jax.vjp(lambda t: jdropout(jkey, t, rate, True),
                       jnp.asarray(x, jnp.bfloat16))
    (gx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    ours = dropout_plain(xt, rate, key)
    ours.backward(torch.tensor(g).to(torch.bfloat16))
    assert ours.dtype == xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(ours), _bits(out))
    np.testing.assert_array_equal(_bits(xt.grad), _bits(gx))
    # a fp32 divisor would differ here (the point of the dtype rule)
    naive = torch.where(ours != 0, xt.detach() / (1.0 - rate), 0.0)
    assert rate == 0.5 or not np.array_equal(_bits(naive), _bits(out))


def test_bf16_divisor_is_jax_bf16_of_one_minus_rate():
    """The kernel's divisor, rounded on the host from the float's bits, is
    the bf16 value jax makes of the weak-typed ``1.0 - rate``."""
    rates = [*np.linspace(0.0, 0.999, 2001).tolist(), 0.1, 0.3, 0.7]
    want = np.asarray(jnp.asarray([1.0 - r for r in rates], jnp.bfloat16),
                      np.float32)
    got = np.asarray([divisor(r, torch.bfloat16) for r in rates],
                     np.float32)
    np.testing.assert_array_equal(got, want)
    assert divisor(0.1, torch.float32) == 1.0 - 0.1


def test_bf16_linear_matches_roc_tpu():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 602)).astype(np.float32)
    w = (rng.standard_normal((602, 256)) * 0.05).astype(np.float32)
    g = rng.standard_normal((64, 256)).astype(np.float32)
    out, vjp = jax.vjp(jlinear, jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.tensor(w, requires_grad=True)
    ours = linear(xt, wt)
    ours.backward(torch.tensor(g).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    np.testing.assert_array_equal(_bits(ours), _bits(out))
    for got, want in ((xt.grad.float(), dx), (wt.grad, dw)):
        want = np.asarray(want, np.float32)
        ulp = np.abs(want) * 2.0 ** -7
        assert (np.abs(got.numpy() - want) <= ulp).all()


# -- dtype flow: every op's output dtype, the port against roc_tpu ----------

_OPS = ("dropout", "linear", "indegree_norm", "apply_activation", "add")


def _recorder(rec, depth, kind, fn):
    """``fn`` recording its output dtype when called outside another
    recorded call (a fused hook's inner norm is part of the hook)."""
    def call(*a, **k):
        depth[0] += 1
        try:
            out = fn(*a, **k)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            rec.append((kind, str(out.dtype).split(".")[-1]))
        return out
    return call


def _wrap_gctx(g, rec, depth):
    hooks = {name: _recorder(rec, depth, name, getattr(g, name))
             for name in ("aggregate", "attend", "fuse_linear",
                          "fuse_region") if getattr(g, name) is not None}
    return g._replace(**hooks)


DTYPE_MODELS = {"gcn": [8, 16, 4], "gcn-chain": [8, 16, 16, 4],
                "sage": [8, 16, 4], "gin": [8, 16, 4], "gat": [8, 4, 4]}
# roc_tpu backend, megafuse, fusion depth
DTYPE_VARIANTS = {"xla": ("xla", False, 1), "binned": ("binned", False, 1),
                  "megafuse": ("binned", True, 1),
                  "megafuse-depth0": ("binned", True, 0)}


def _jax_dtypes(monkeypatch, name, backend, mega, depth, dropout):
    rec, lvl = [], [0]
    for op in _OPS:
        monkeypatch.setattr(jops, op,
                            _recorder(rec, lvl, op, getattr(jops, op)))
    layers = DTYPE_MODELS[name]
    cfg = JConfig(dataset="roc-audit", layers=layers, model=name, heads=2,
                  aggregate_backend=backend, megafuse=mega,
                  fusion_depth=depth, use_bf16=True, dropout_rate=dropout)
    model = jbuild_model(name, layers, dropout, heads=2)
    tr = jdriver.Trainer(cfg, jdatasets.get("roc-audit"), model)
    g = _wrap_gctx(jdriver.make_gctx(tr.gdata, tr.num_nodes, mega, depth),
                   rec, lvl)
    out = model.apply(tr.params, tr.x, g, key=jax.random.PRNGKey(0),
                      train=True)
    return rec + [("logits", str(out.dtype))]


def _port_dtypes(monkeypatch, name, backend, mega, depth, dropout):
    rec, lvl = [], [0]
    for op in _OPS:
        monkeypatch.setattr(ops, op,
                            _recorder(rec, lvl, op, getattr(ops, op)))
    layers = DTYPE_MODELS[name]
    cfg = Config(dataset="roc-audit", layers=layers, model=name, heads=2,
                 aggregate_backend=backend, megafuse=mega,
                 fusion_depth=depth, use_bf16=True, dropout_rate=dropout,
                 device="cpu")
    model = build_model(name, layers, dropout, heads=2)
    tr = Trainer(cfg, datasets.get("roc-audit"), model)
    g = _wrap_gctx(make_gctx(tr.gdata, mega, depth), rec, lvl)
    out = model.apply(tr.params, tr.x, g, key=prng.prng_key(0), train=True)
    return rec + [("logits", str(out.dtype).split(".")[-1])]


@pytest.mark.parametrize("variant", list(DTYPE_VARIANTS))
@pytest.mark.parametrize("name", list(DTYPE_MODELS))
def test_op_dtypes_under_bf16_match_roc_tpu(name, variant, monkeypatch):
    """Walk both models' op lists in a training forward under -bf16: the
    same ops run (fused hooks included) with the same output dtypes.
    roc_tpu's megakernel hook needs the flat geometry on this small graph;
    gcn-chain's depth-0 case trains at dropout 0, where its two hidden
    layers chain into one region."""
    backend, mega, depth = DTYPE_VARIANTS[variant]
    dropout = 0.0 if (name == "gcn-chain" and depth == 0) else 0.5
    if mega:
        monkeypatch.setenv("ROC_BINNED_GEOM", "flat")
    want = _jax_dtypes(monkeypatch, name, backend, mega, depth, dropout)
    got = _port_dtypes(monkeypatch, name, backend, mega, depth, dropout)
    print(name, variant, got)
    assert got == want
    assert got[0] == ("dropout", "bfloat16")
    kinds = {k for k, _ in got}
    assert bool(kinds & {"fuse_linear", "fuse_region"}) == \
        (mega and name != "gat")
    assert ("fuse_region" in kinds) == (name == "gcn-chain"
                                        and variant == "megafuse-depth0")


# -- the trainer --------------------------------------------------------------

_BF16_BASE = dict(dataset="roc-audit", layers=[8, 16, 4], num_epochs=3,
                  learning_rate=0.01, weight_decay=5e-4, dropout_rate=0.1,
                  eval_every=1000, seed=1, use_bf16=True)


def _jax_bf16_loss(backend, **kw):
    cfg = JConfig(aggregate_backend=backend, **{**_BF16_BASE, **kw})
    tr = jdriver.Trainer(cfg, jdatasets.get("roc-audit"),
                         jbuild_model("gcn", cfg.layers, cfg.dropout_rate))
    return tr.train(print_fn=_quiet).final_loss


def _port_bf16_trainer(backend, **kw):
    cfg = Config(aggregate_backend=backend, device="cpu",
                 **{**_BF16_BASE, **kw})
    return Trainer(cfg, datasets.get("roc-audit"),
                   build_model("gcn", cfg.layers, cfg.dropout_rate))


@pytest.mark.parametrize("backend", ["xla", "binned"])
def test_bf16_trainer_tracks_roc_tpu(backend):
    """3 epochs at dropout 0.1 from each package's own seeded init (the
    same bits): the final loss within the spread between roc_tpu's own xla
    and matmul -bf16 runs, or 2e-3 relative, whichever is larger."""
    spread = abs(_jax_bf16_loss("xla") - _jax_bf16_loss("matmul")) \
        / abs(_jax_bf16_loss("xla"))
    want = _jax_bf16_loss(backend)
    tr = _port_bf16_trainer(backend)
    assert tr.x.dtype == torch.bfloat16
    got = tr.train(print_fn=_quiet).final_loss
    gap = abs(got - want) / abs(want)
    print(f"-bf16 {backend}: port vs roc_tpu {gap:.2e} relative; roc_tpu "
          f"xla vs matmul {spread:.2e}")
    assert np.isfinite(got) and gap <= max(spread, 2e-3)


def test_bf16_storage_changes_no_bit_on_one_device():
    """roc_tpu shows -bf16-storage changing nothing on one device in fast
    (its sums already stage bf16 once), on xla and on interpreted binned;
    the port follows."""
    base = dict(_BF16_BASE, use_bf16=False, dropout_rate=0.5)
    for backend in ("xla", "binned"):
        jl = [_jax_bf16_loss(backend, bf16_storage=s, use_bf16=False,
                             dropout_rate=0.5) for s in (False, True)]
        assert jl[0] == jl[1]
        runs = []
        for s in (False, True):
            tr = Trainer(Config(aggregate_backend=backend, device="cpu",
                                bf16_storage=s, **base),
                         datasets.get("roc-audit"), build_model(
                             "gcn", base["layers"], 0.5))
            runs.append((tr.train(print_fn=_quiet).final_loss,
                         tr.predict_logits()))
        assert runs[0][0] == runs[1][0]
        assert torch.equal(runs[0][1], runs[1][1])


def test_bf16_storage_refused_under_exact():
    for make in (Config, JConfig):
        with pytest.raises(SystemExit, match="bf16-storage"):
            make(bf16_storage=True, aggregate_precision="exact")


# -- forward-only: load_frozen and the serve engine ---------------------------

def test_frozen_and_served_bf16_match_eval():
    cfg = Config(dataset="roc-audit", layers=[8, 16, 4], use_bf16=True,
                 aggregate_backend="binned", serve_batch=8,
                 serve_wait_ms=1.0)
    ds = datasets.get("roc-audit")
    model = build_model("gcn", cfg.layers)
    bundle = load_frozen(cfg, ds, model, device="cpu")
    assert bundle.x.dtype == torch.bfloat16
    assert torch.equal(bundle.x, torch.tensor(ds.features).to(torch.bfloat16))
    jcfg = JConfig(dataset="roc-audit", layers=[8, 16, 4], use_bf16=True,
                   aggregate_backend="binned")
    from roc_tpu.train.frozen import load_frozen as jload_frozen
    jb = jload_frozen(jcfg, jdatasets.get("roc-audit"),
                      jbuild_model("gcn", jcfg.layers))
    want = np.asarray(jb.predict_logits())
    got = bundle.predict_logits()
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    with ServeEngine(cfg, ds, model, device="cpu") as eng:
        ids = np.arange(ds.graph.num_nodes, dtype=np.int32)
        served = eng.query(ids, timeout=120.0)
        oracle = eng.bundle.predict_logits().numpy()
        assert max_ulp_diff(served, oracle[ids]) <= 32


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_bf16_dropout_kernel_matches_plain_on_card(rate):
    """The kernel's bf16 variant, forward and backward, bitwise equal to
    the plain version's, at a width whose flat index crosses many
    blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from roc_tpu_torch.ops.kernels import dropout as KD
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.standard_normal((4099, 257)).astype(np.float32))
    g = torch.tensor(rng.standard_normal((4099, 257)).astype(np.float32))
    x, g = x.to(torch.bfloat16), g.to(torch.bfloat16)
    key = prng.fold_in(prng.prng_key(1), 3)
    xc = x.cuda().requires_grad_(True)
    launches = KD.dropout.launches
    out = KD.dropout(xc, rate, key)
    out.backward(g.cuda())
    assert KD.dropout.launches == launches + 2
    xp = x.clone().requires_grad_(True)
    ref = KD.dropout_plain(xp, rate, key)
    ref.backward(g)
    np.testing.assert_array_equal(_bits(out.cpu()), _bits(ref))
    np.testing.assert_array_equal(_bits(xc.grad.cpu()), _bits(xp.grad))
