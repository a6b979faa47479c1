"""The port's graph attention (roc_tpu_torch) against roc_tpu.

Same numpy-seeded inputs through the JAX functions and the port on the
CPU.  roc_tpu's references are ``gat_attend_plan`` (the plan composition;
"highest" is fp32) and ``gat_attend_binned`` with its Pallas grids in
interpret mode, on test_gat_fused.py's fixture (flat geometry, n = 150,
K = 2, F = 4), with a spy asserting that the Pallas path really ran.  The
port runs ``gat_attend_kernel``, whose kernels take their plain versions on
CPU tensors.

Tolerances (``norm_ulps``: max |a - b| in ULPs of the array's max-abs, the
metric of test_gat_fused.py):
  forward, integer data (a_src = 0, so e = 1)   bitwise, both precisions,
                                                vs plan and vs binned
  forward, Gaussian data                        <= 32 norm-ULPs; exact vs
                                                plan and binned, fast vs
                                                binned (the port rounds e*x
                                                to bf16 where the binned
                                                kernel does; CPU XLA's plan
                                                takes no bf16 pass)
  gradients dh, dtable, da_src, da_dst          <= 32 norm-ULPs (dh is
                                                a_dst times the score
                                                gradient, which cancels to
                                                ~0 in rows whose edges'
                                                scores share a sign: a
                                                row-relative bound would
                                                compare noise with noise)
  frozen GAT logits (a roc_tpu checkpoint)      exact: <= 32 norm-ULPs;
                                                fast: 5e-3 of each row's
                                                max-abs (one designed bf16
                                                rounding per layer)
  trainer, 3 epochs                             final loss 1e-3 relative
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roc_tpu import ops as jops
from roc_tpu.graph import datasets as jdatasets
from roc_tpu.graph.csr import from_edges as jfrom_edges
from roc_tpu.models import build_gat as jbuild_gat
from roc_tpu.ops.pallas import gat as pgat
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu.train import checkpoint as jcheckpoint
from roc_tpu.train.frozen import load_frozen as jload_frozen
from roc_tpu_torch import ops
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.graph.csr import from_edges
from roc_tpu_torch.models import build_gat, build_model, mega_matches
from roc_tpu_torch.ops import edge as edge_mod
from roc_tpu_torch.ops.kernels import gat as G
from roc_tpu_torch.serve.__main__ import selftest
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train import graph_data
from roc_tpu_torch.train.config import BACKENDS, Config
from roc_tpu_torch.train.driver import Trainer
from roc_tpu_torch.train.frozen import load_frozen

EPS32 = float(np.finfo(np.float32).eps)
SLOPE = 0.2


@pytest.fixture(autouse=True)
def _binned_runs_under_jax_0_9(monkeypatch):
    """run_binned's one-shot eager warning calls jax.core.trace_state_clean,
    which jax 0.9.0 no longer exports (ROADMAP queue C)."""
    from roc_tpu.ops.pallas import binned
    monkeypatch.setattr(binned, "_EAGER_WARNED", [True])


def norm_ulps(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(a).max()), 1e-30)
    return float(np.abs(a - b).max()) / (scale * EPS32)


def _row_rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).max(axis=1)
    s = np.abs(want).max(axis=1)
    return float(np.where(d == 0, 0.0, d / np.where(s == 0, 1.0, s)).max())


def _setup(monkeypatch, n=150, seed=3):
    """test_gat_fused.py's graph and plans, and the port's CSR of the same
    (byte-equal) graph."""
    monkeypatch.setenv("ROC_BINNED_GEOM", "flat")
    kw = dict(n_train=30, n_val=30, n_test=30, seed=seed)
    g = jdatasets.synthetic("t", n, 4.0, 8, 4, **kw).graph
    pg = datasets.synthetic("t", n, 4.0, 8, 4, **kw).graph
    np.testing.assert_array_equal(pg.row_ptr, g.row_ptr)
    np.testing.assert_array_equal(pg.col_idx, g.col_idx)
    gplans = jops.build_gat_plans(g.col_idx, g.dst_idx, g.num_nodes,
                                  g.num_nodes)
    bplans = jops.build_binned_plans(g.col_idx, g.dst_idx, g.num_nodes,
                                     g.num_nodes, geom="auto",
                                     fuse_linear=True)
    eidx = (jnp.asarray(g.col_idx), jnp.asarray(g.dst_idx))
    return g, gplans, bplans, eidx, ops.DeviceCsr.from_csr(pg, "cpu",
                                                           edge_map=True)


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(pgat, name)

    def wrapper(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(pgat, name, wrapper)
    return calls


def _gaussian(n, k=2, f=4, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((n, k, f), (k, f), (k, f)))


JPREC = {"exact": "highest", "fast": "default"}


def _jax_fns(gplans, bplans, eidx, precision):
    """The two roc_tpu paths as functions of (h, table, a_src, a_dst)."""
    jp = JPREC[precision]

    def plan(h, t, a, d):
        return jops.gat_attend_plan(h, t, a, d, gplans, eidx, SLOPE, jp)

    def binned(h, t, a, d):
        return jops.gat_attend_binned(h, t, a, d, gplans, bplans, eidx,
                                      SLOPE, jp, True)
    return {"plan": plan, "binned": binned}


def _port(h, a_src, a_dst, csr, precision):
    return ops.gat_attend_kernel(*(torch.as_tensor(v) for v in
                                   (h, h, a_src, a_dst)), csr, SLOPE,
                                 precision).numpy()


# -- forward ----------------------------------------------------------------

@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_forward_bitwise_on_integer_data(monkeypatch, precision):
    g, gplans, bplans, eidx, csr = _setup(monkeypatch)
    k, f = 2, 4
    rng = np.random.default_rng(7)
    h = rng.integers(0, 8, size=(g.num_nodes, k, f)).astype(np.float32)
    a_dst = rng.integers(0, 3, size=(k, f)).astype(np.float32)
    a_src = np.zeros((k, f), np.float32)
    got = _port(h, a_src, a_dst, csr, precision)
    calls = _spy(monkeypatch, "run_binned_gat")
    for name, fn in _jax_fns(gplans, bplans, eidx, precision).items():
        want = np.asarray(fn(*(jnp.asarray(v) for v in (h, h, a_src,
                                                        a_dst))))
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert calls, "the binned Pallas forward did not run"


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_forward_continuous_within_32_norm_ulps(monkeypatch, precision):
    g, gplans, bplans, eidx, csr = _setup(monkeypatch)
    h, a_src, a_dst = _gaussian(g.num_nodes)
    got = _port(h, a_src, a_dst, csr, precision)
    calls = _spy(monkeypatch, "run_binned_gat")
    fns = _jax_fns(gplans, bplans, eidx, precision)
    refs = ("plan", "binned") if precision == "exact" else ("binned",)
    for name in refs:
        want = fns[name](*(jnp.asarray(v) for v in (h, h, a_src, a_dst)))
        print(f"{precision} vs {name}: {norm_ulps(want, got):.2f} norm-ULPs")
        assert norm_ulps(want, got) <= 32, name
    assert calls
    if precision == "fast":
        # the product e * x really takes its bf16 rounding
        assert norm_ulps(_port(h, a_src, a_dst, csr, "exact"), got) > 1e3


@pytest.mark.parametrize("k,f", [(3, 5), (1, 41), (8, 2)])
def test_forward_ragged_heads_match_the_plan(monkeypatch, k, f):
    """K * F not a multiple of 4 or 32: the plain versions' head layout
    against the plan composition (fp32)."""
    g, gplans, _, eidx, csr = _setup(monkeypatch)
    h, a_src, a_dst = _gaussian(g.num_nodes, k, f, seed=11)
    want = jops.gat_attend_plan(*(jnp.asarray(v) for v in
                                  (h, h, a_src, a_dst)), gplans, eidx,
                                SLOPE, "highest")
    assert norm_ulps(want, _port(h, a_src, a_dst, csr, "exact")) <= 32


@pytest.mark.parametrize("k,f", [(1, 41), (4, 64), (3, 5), (40, 2)])
def test_serial_score_reference_matches_plain_and_roc_tpu(k, f):
    """``gat_score_serial`` (the kernel's order and rounding: products
    rounded, added in f order from 0) against ``gat_score_plain`` and
    roc_tpu's ``einsum("tkf,kf->tk")`` at "highest": each element within
    1e-6 of the sum of the absolute values of its terms (the three differ
    only in the order of the fp32 adds)."""
    x, a_src, _ = _gaussian(300, k, f, seed=23)
    x = x.reshape(300, k * f)
    x[0, :] = 0.0
    x[1, 0] = -0.0
    got = G.gat_score_serial(torch.as_tensor(x), torch.as_tensor(a_src))
    assert got.shape == (300, k) and got.dtype == torch.float32
    terms = (np.abs(x).reshape(300, k, f) * np.abs(a_src)).sum(-1)
    plain = G.gat_score_plain(torch.as_tensor(x), torch.as_tensor(a_src))
    jax_score = jnp.einsum("tkf,kf->tk", jnp.asarray(x.reshape(300, k, f)),
                           jnp.asarray(a_src), precision="highest")
    for want in (plain.numpy(), np.asarray(jax_score)):
        err = np.abs(got.numpy() - want)
        assert (err <= 1e-6 * terms).all(), float(err.max())
    # the serial order from 0, as the kernel adds
    want = np.zeros((300, k), np.float32)
    xv = x.reshape(300, k, f)
    for i in range(f):
        want = want + xv[:, :, i] * a_src[:, i]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert (got[0] == 0).all()


# -- backward ---------------------------------------------------------------

def _port_grads(h, a_src, a_dst, csr, precision):
    ts = [torch.tensor(v, requires_grad=True) for v in (h, h, a_src, a_dst)]
    out = ops.gat_attend_kernel(*ts, csr, SLOPE, precision)
    torch.sin(out).sum().backward()
    return [t.grad.numpy() for t in ts]


def _jax_grads(fn, h, a_src, a_dst):
    def loss(*args):
        return jnp.sum(jnp.sin(fn(*args)))
    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (h, h, a_src, a_dst)))


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_gradients_match_roc_tpu(monkeypatch, precision):
    g, gplans, bplans, eidx, csr = _setup(monkeypatch)
    h, a_src, a_dst = _gaussian(g.num_nodes)
    got = _port_grads(h, a_src, a_dst, csr, precision)
    calls = _spy(monkeypatch, "run_binned_gat_bwd")
    fns = _jax_fns(gplans, bplans, eidx, precision)
    refs = ("plan", "binned") if precision == "exact" else ("binned",)
    for ref in refs:
        want = _jax_grads(fns[ref], h, a_src, a_dst)
        for name, a, b in zip(("dh", "dtable", "da_src", "da_dst"), want,
                              got):
            print(f"{precision} {name} vs {ref}: {norm_ulps(a, b):.2f}")
            assert norm_ulps(a, b) <= 32, (ref, name)
    assert calls, "the binned Pallas backward did not run"


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_plain_backward_kernels_match_the_pallas_grids(monkeypatch,
                                                       precision):
    """gat_bwd_dst_plain and gat_bwd_src_plain against run_binned_gat_bwd's
    (dtable_agg, dast, dadl), from the same forward residuals."""
    g, _, bplans, _, csr = _setup(monkeypatch)
    n, k, f = g.num_nodes, 2, 4
    h, a_src, a_dst = _gaussian(n)
    gout = np.random.default_rng(5).normal(size=(n, k, f)).astype(np.float32)
    bprec = precision
    jh, ja, jd, jg = (jnp.asarray(v) for v in (h, a_src, a_dst, gout))
    ad_l = jnp.einsum("nkf,kf->nk", jh, jd)
    jout, jm, jz = pgat.run_binned_gat(jh, ja, ad_l, bplans.fwd, SLOPE,
                                       interpret=True, precision=bprec)
    want = pgat.run_binned_gat_bwd(jg, jout, jh, ja, ad_l, jm, jz,
                                   bplans.fwd, bplans.bwd, SLOPE,
                                   interpret=True, precision=bprec)

    x = torch.as_tensor(h).view(n, k * f)
    as_t = G.gat_score_plain(x, torch.as_tensor(a_src))
    ad = torch.as_tensor(np.array(ad_l))
    out, m, z = G.gat_forward_plain(x, as_t, ad, csr.row_ptr, csr.col_idx,
                                    SLOPE, precision)
    assert norm_ulps(np.asarray(jm)[:n, :k], m.numpy()) <= 32
    assert norm_ulps(np.asarray(jz)[:n, :k], z.numpy()) <= 32
    assert norm_ulps(jout, out.view(n, k, f).numpy()) <= 32
    zc = torch.clamp_min(z, 1e-15)
    gt = torch.as_tensor(gout)
    du = (gt / zc[:, :, None]).reshape(n, k * f)
    dz = -(gt * out.view(n, k, f)).sum(-1) / zc
    dadl = G.gat_bwd_dst_plain(x, as_t, ad, m, du, dz, csr.row_ptr,
                               csr.col_idx, SLOPE)
    dtable, dast = G.gat_bwd_src_plain(x, as_t, ad, m, du, dz,
                                       csr.t_row_ptr, csr.t_col_idx, SLOPE,
                                       precision)
    # the composed plain backward, the kernels' order: the src twin (dtable,
    # dast, dq in transposed order), then dq's sum per destination
    ctable, cast, dq = G.gat_bwd_src_dq_plain(
        x, as_t, ad, m, du, dz, csr.t_row_ptr, csr.t_col_idx, SLOPE,
        precision)
    cadl = G.gat_dadl_plain(dq, csr.t_pos, csr.row_ptr, csr.col_idx)
    for name, a, b in (("dtable", want[0], dtable.view(n, k, f)),
                       ("dast", want[1], dast), ("dadl", want[2], dadl),
                       ("composed dtable", want[0], ctable.view(n, k, f)),
                       ("composed dast", want[1], cast),
                       ("composed dadl", want[2], cadl)):
        print(f"{precision} {name}: {norm_ulps(a, b.numpy()):.2f} norm-ULPs")
        assert norm_ulps(a, b.numpy()) <= 32, name


def test_score_gradient_at_q_zero_takes_the_unit_branch(monkeypatch):
    """lrelu'(0) = 1 (edge.py:479): integer data puts q = 0 on many edges;
    the kernel path's gradients agree with roc_tpu's and with autograd of
    the port's plain composition, and differ from the slope branch."""
    g, gplans, _, eidx, csr = _setup(monkeypatch)
    n, k, f = g.num_nodes, 2, 4
    rng = np.random.default_rng(13)
    h = rng.integers(-1, 2, size=(n, k, f)).astype(np.float32)
    a_src, a_dst = (rng.integers(-1, 2, size=(k, f)).astype(np.float32)
                    for _ in range(2))
    q = (np.einsum("nkf,kf->nk", h, a_dst)[g.dst_idx]
         + np.einsum("nkf,kf->nk", h, a_src)[g.col_idx])
    assert (q == 0).mean() > 0.1 and (q > 0).any() and (q < 0).any()
    got = _port_grads(h, a_src, a_dst, csr, "exact")
    want = _jax_grads(_jax_fns(gplans, None, eidx, "exact")["plan"], h,
                      a_src, a_dst)
    ts = [torch.tensor(v, requires_grad=True) for v in (h, h, a_src, a_dst)]
    dst = torch.as_tensor(g.dst_idx.astype(np.int64))
    plain = ops.gat_attend(ts[0], ts[1], csr.col_idx, dst, n, ts[2], ts[3],
                           SLOPE)
    torch.sin(plain).sum().backward()
    for i, name in enumerate(("dh", "dtable", "da_src", "da_dst")):
        assert norm_ulps(want[i], got[i]) <= 32, name
        assert norm_ulps(ts[i].grad.numpy(), got[i]) <= 32, name
    # the slope branch at q = 0 would move the score gradient
    x = torch.as_tensor(h).view(n, k * f)
    as_t = G.gat_score_plain(x, torch.as_tensor(a_src))
    ad = G.gat_score_plain(x, torch.as_tensor(a_dst))
    out, m, z = G.gat_forward_plain(x, as_t, ad, csr.row_ptr, csr.col_idx,
                                    SLOPE)
    du = torch.ones((n, k * f))
    dz = torch.zeros((n, k))
    at_zero = G.gat_bwd_dst_plain(x, as_t, ad, m, du, dz, csr.row_ptr,
                                  csr.col_idx, SLOPE)
    shifted = G.gat_bwd_dst_plain(x, as_t - 1e-30, ad, m, du, dz,
                                  csr.row_ptr, csr.col_idx, SLOPE)
    assert not torch.equal(at_zero, shifted)


def test_isolated_node_gives_zero_output_and_finite_residuals():
    """A row with no in-edges: out = 0, z = 0, a finite m (0), finite
    gradients, as in roc_tpu's composition."""
    rng = np.random.default_rng(3)
    n, k, f = 40, 2, 3
    src, dst = rng.integers(0, n, 200), rng.integers(0, n, 200)
    keep = dst != 5
    src, dst = src[keep], dst[keep]
    g, jg = from_edges(n, src, dst), jfrom_edges(n, src, dst)
    assert g.row_ptr[6] == g.row_ptr[5]
    csr = ops.DeviceCsr.from_csr(g, "cpu", edge_map=True)
    h, a_src, a_dst = _gaussian(n, k, f, seed=4)
    x = torch.as_tensor(h).view(n, k * f)
    as_t = G.gat_score_plain(x, torch.as_tensor(a_src))
    ad = G.gat_score_plain(x, torch.as_tensor(a_dst))
    out, m, z = G.gat_forward_plain(x, as_t, ad, csr.row_ptr, csr.col_idx,
                                    SLOPE)
    assert torch.equal(out[5], torch.zeros(k * f))
    assert torch.equal(z[5], torch.zeros(k)) and torch.equal(m[5],
                                                             torch.zeros(k))
    want = jops.gat_attend(*(jnp.asarray(v) for v in (h, h)),
                           jnp.asarray(jg.col_idx), jnp.asarray(jg.dst_idx),
                           n, jnp.asarray(a_src), jnp.asarray(a_dst), SLOPE)
    got = _port_grads(h, a_src, a_dst, csr, "exact")
    assert norm_ulps(want, _port(h, a_src, a_dst, csr, "exact")) <= 32
    assert all(np.isfinite(v).all() for v in got)


# -- the trainer ------------------------------------------------------------

_TRAIN = dict(num_epochs=3, dropout_rate=0.0, learning_rate=0.01,
              weight_decay=5e-4, eval_every=1000, aggregate_precision="exact",
              model="gat", heads=2, seed=1)
_LAYERS = [64, 8, 8]


def _quiet(*a, **k):
    pass


def _jax_trainer(backend, megafuse, **kw):
    cfg = JConfig(dataset="mega-shard", layers=_LAYERS, megafuse=megafuse,
                  aggregate_backend=backend, **{**_TRAIN, **kw})
    return JTrainer(cfg, jdatasets.get("mega-shard", seed=1),
                    jbuild_gat(_LAYERS, 0.0, heads=2))


def _port_trainer(backend, megafuse=False, **kw):
    cfg = Config(dataset="mega-shard", layers=_LAYERS, megafuse=megafuse,
                 aggregate_backend=backend, device="cpu",
                 **{**_TRAIN, **kw})
    return Trainer(cfg, datasets.get("mega-shard", seed=1),
                   build_model("gat", _LAYERS, 0.0, heads=2))


def _carry(jtr, tr):
    tr.params = checkpoint.params_from_jax(
        {k: np.asarray(v) for k, v in jtr.params.items()}, "cpu")
    tr.opt_state = checkpoint.opt_state_from_jax(
        jax.device_get(jtr.opt_state), "cpu")


# (roc_tpu backend, roc_tpu -megafuse, port backend)
TRAIN_CASES = [("xla", False, "xla"), ("xla", False, "binned"),
               ("matmul", True, "binned")]


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=lambda c: f"{c[0]}{'-megafuse' if c[1] else ''}"
                                       f"-vs-{c[2]}")
def test_gat_trainer_tracks_roc_tpu(monkeypatch, case):
    """3 epochs of GAT 64-8-8 (2 heads, exact, dropout 0) from the same
    params: final loss within 1e-3 relative; roc_tpu's matmul + -megafuse
    run really takes its fused Pallas attention, and the port's kernel
    backend really takes the GAT kernels (their plain versions here)."""
    jb, mf, pb = case
    monkeypatch.setenv("ROC_BINNED_GEOM", "flat")
    jtr = _jax_trainer(jb, mf)
    assert bool(jtr.gdata.gat_fused) == mf
    tr = _port_trainer(pb)
    _carry(jtr, tr)
    calls = {name: 0 for name in ("gat_score", "gat_forward", "gat_bwd_dst",
                                  "gat_bwd_src")}
    for name in calls:
        orig = getattr(edge_mod, name)
        monkeypatch.setattr(edge_mod, name, lambda *a, _o=orig, _n=name, **k:
                            (calls.__setitem__(_n, calls[_n] + 1),
                             _o(*a, **k))[1])
    want = jtr.train(print_fn=_quiet).final_loss
    got = tr.train(print_fn=_quiet).final_loss
    gap = abs(got - want) / abs(want)
    print(f"GAT port ({pb}) vs roc_tpu ({jb}{', megafuse' if mf else ''}) "
          f"after 3 epochs: final loss {gap:.2e} relative")
    assert np.isfinite(got) and gap <= 1e-3
    # 2 layers: per step one score and one forward each, and one of each
    # backward kernel; the eval at epoch 0 adds a forward
    steps = 3 if pb == "binned" else 0
    fwd = 2 * (steps + 1) if steps else 0
    assert calls == {"gat_score": fwd, "gat_forward": fwd,
                     "gat_bwd_dst": 2 * steps, "gat_bwd_src": 2 * steps}


def test_megafuse_changes_nothing_for_gat():
    """No gat op is a megakernel chain: -megafuse trains the same bits."""
    assert mega_matches(build_gat(_LAYERS, 0.0, heads=2)) == {}
    runs = []
    for mf in (False, True):
        tr = _port_trainer("binned", megafuse=mf)
        assert tr.gctx.attend is not None
        runs.append((tr.train(print_fn=_quiet).final_loss,
                     tr.predict_logits()))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("direction", ["roc_tpu_to_port", "port_to_roc_tpu"])
def test_gat_checkpoint_resumes_across_packages(tmp_path, monkeypatch,
                                                direction):
    """Two GAT epochs in one package, a checkpoint (gat_*_adst, _asrc, _w
    leaves in jax's sorted order), one epoch in the other: the loss of
    continuing in the first within 1e-3."""
    path = str(tmp_path / "gat.npz")
    decay = dict(decay_rate=0.5, decay_steps=2)
    jtr = _jax_trainer("xla", False, num_epochs=2, checkpoint_path=path,
                       **decay)
    tr = _port_trainer("xla", num_epochs=2, checkpoint_path=path, **decay)
    _carry(jtr, tr)
    assert sorted(tr.params) == sorted(jtr.params)
    first = jtr if direction == "roc_tpu_to_port" else tr
    first.train(print_fn=_quiet)
    second = (_port_trainer("xla", num_epochs=1, **decay)
              if direction == "roc_tpu_to_port"
              else _jax_trainer("xla", False, num_epochs=1, **decay))
    second.restore(path)
    assert second.epoch == 2
    first.config.num_epochs, first.config.checkpoint_path = 1, None
    a = first.train(print_fn=_quiet).final_loss
    b = second.train(print_fn=_quiet).final_loss
    assert np.isfinite(a) and abs(a - b) <= 1e-3 * abs(a)


# -- serving ----------------------------------------------------------------

@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_gat_checkpoint_serves_like_roc_tpu(tmp_path, monkeypatch,
                                            precision):
    """A roc_tpu GAT checkpoint, loaded forward-only (the CSR without its
    transpose) by the port: the same logits as roc_tpu's frozen bundle,
    within 32 norm-ULPs in exact; in fast (against the interpreted fused
    kernels) within 5e-3 of each row's max-abs, the bound of
    test_torch_slice.py: a layer-1 output that differs in its last fp32
    bit can round to the neighbouring bf16 value in layer 2."""
    monkeypatch.setenv("ROC_BINNED_GEOM", "flat")
    layers = [64, 8, 8]
    kw = dict(dataset="mega-shard", layers=layers, model="gat", heads=2,
              dropout_rate=0.0, aggregate_precision=precision,
              megafuse=precision == "fast")
    jcfg = JConfig(aggregate_backend="matmul" if precision == "fast"
                   else "xla", **kw)
    jb = jload_frozen(jcfg, jdatasets.get("mega-shard"),
                      jbuild_gat(layers, 0.0, heads=2))
    assert bool(jb.gdata.gat_fused) == (precision == "fast")
    path = str(tmp_path / "gat.ckpt.npz")
    jcheckpoint.save(path, jb.params, None, 0, 0.0)
    cfg = Config(aggregate_backend="binned", **kw)
    bundle = load_frozen(cfg, datasets.get("mega-shard"),
                         build_model("gat", layers, 0.0, heads=2),
                         checkpoint_path=path, device="cpu")
    assert bundle.gdata.backend == "kernel"
    assert bundle.gdata.csr.t_row_ptr is None
    got = bundle.predict_logits().numpy()
    want = np.asarray(jb.predict_logits())
    if precision == "exact":
        assert norm_ulps(want, got) <= 32
    else:
        assert _row_rel_err(got, want) <= 5e-3


def test_serve_selftest_serves_gat_on_cpu(capsys):
    assert selftest("cpu", "gat") == 0
    out = capsys.readouterr().out
    assert "parity vs eval forward = 0 ULPs" in out
    assert "# serve selftest: OK" in out


# -- backend choice ---------------------------------------------------------

def test_attention_takes_the_kernel_path_on_cuda(monkeypatch):
    """On a CUDA device every backend but xla resolves to the kernels for a
    GAT model, and make_gctx sends attention to gat_attend_kernel with or
    without -megafuse (checked by the choice, without a card)."""
    model = build_gat([8, 4, 4], 0.0, heads=2)
    cuda = torch.device("cuda")
    for b in BACKENDS:
        want = "xla" if b == "xla" else "kernel"
        assert graph_data.effective_backend(
            Config(aggregate_backend=b), model, cuda) == want, b
    assert graph_data.effective_backend(Config(), model,
                                        torch.device("cpu")) == "xla"
    calls = []
    monkeypatch.setattr(ops, "gat_attend_kernel",
                        lambda *a, **k: calls.append(("kernel", a[-1])))
    monkeypatch.setattr(ops, "gat_attend",
                        lambda *a, **k: calls.append(("plain", None)))
    g = graph_data.dense_graph_data(datasets.get("roc-audit").graph,
                                    "kernel", "fast", torch.device("cpu"))
    h, a = torch.zeros((96, 2, 2)), torch.zeros((2, 2))
    for mf in (False, True):
        graph_data.make_gctx(g, megafuse=mf).attend(h, a, a, SLOPE)
    g.backend = "xla"
    graph_data.make_gctx(g).attend(h, a, a, SLOPE)
    assert calls == [("kernel", "fast"), ("kernel", "fast"), ("plain", None)]
    assert graph_data.model_gat_dims(model) == (2, 4)
    assert graph_data.forward_launches(model) == {
        "aggregate_sum": 0, "gat_score": 2, "gat_stage": 0, "gat_forward": 2,
        "stage_plane": 0}
    # a single head of 41 columns (4-byte rows) is staged first
    assert graph_data.forward_launches(build_gat([602, 64, 41], 0.0,
                                                 heads=4))["gat_stage"] == 1


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_backward_wrappers_reject_mis_shaped_node_tensors(device):
    """du must be [N, H] and m, dz [N, K]: the src kernel reads N * H
    floats of du, so a [N, K] du must be refused before any launch (on
    "meta" the wrappers take their kernel branch, which checks shapes
    first); the plain dadl takes the same checks."""
    n, k, f = 4, 2, 3
    x = torch.zeros((n, k * f), device=device)
    s = torch.zeros((n, k), device=device)
    rp = torch.zeros(n + 1, dtype=torch.int64, device=device)
    ci = torch.zeros(0, dtype=torch.int32, device=device)
    for du, m in ((s, s), (x, x)):
        bad = "du" if du is s else "m"
        with pytest.raises(ValueError, match=f"{bad} must be"):
            G.gat_bwd_dst_plain(x, s, s, m, du, s, rp, ci)
        with pytest.raises(ValueError, match=f"{bad} must be"):
            G.gat_bwd_src(x, s, s, m, du, s, rp, ci)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dst_wrapper_rejects_a_mis_shaped_dq(device):
    """dq must be [E, K] float32 over the CSR's E edges, and t_pos the
    CSR's [E] int32 edge map: the dst kernel reads a K-float row of dq
    for each of the E entries of t_pos."""
    e, k = 6, 2
    rp = torch.tensor([0, 2, 2, 5, 6], dtype=torch.int64, device=device)
    ci = torch.zeros(e, dtype=torch.int32, device=device)
    t_pos = torch.arange(e, dtype=torch.int32, device=device)
    for bad in (torch.zeros((e + 1, k)), torch.zeros((e - 1, k)),
                torch.zeros((e * k,)), torch.zeros((e, 0)),
                torch.zeros((e, k), dtype=torch.float64)):
        with pytest.raises(ValueError, match="dq must be|float32"):
            G.gat_bwd_dst(bad.to(device), t_pos, rp, ci)
    for bad in (torch.zeros(e - 1, dtype=torch.int32),
                torch.zeros(e, dtype=torch.int64)):
        with pytest.raises(ValueError, match="t_pos must be"):
            G.gat_bwd_dst(torch.zeros((e, k), device=device),
                          bad.to(device), rp, ci)


def test_only_cpu_tensors_take_the_plain_versions():
    """A tensor on neither the CPU nor CUDA raises in every wrapper."""
    t = torch.zeros((4, 4), device="meta")
    s = torch.zeros((4, 2), device="meta")
    rp = torch.zeros(5, dtype=torch.int64, device="meta")
    ci = torch.zeros(0, dtype=torch.int32, device="meta")
    dq = torch.zeros((0, 2), device="meta")
    for call in (lambda: G.gat_score(t, torch.zeros((2, 2), device="meta")),
                 lambda: G.gat_forward(t, s, s, rp, ci),
                 lambda: G.gat_bwd_dst(dq, ci, rp, ci),
                 lambda: G.gat_bwd_src(t, s, s, s, t, s, rp, ci)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()


# -- the edge map and the new backward's steps -------------------------------

def _map_graphs():
    """A graph with parallel edges (1 -> 2 three times), self edges, an
    isolated row (4: no in-edges), a row with no out-edges (3), and an
    empty graph."""
    src = np.array([1, 1, 1, 0, 2, 2, 3, 0, 5, 5, 0], np.int32)
    dst = np.array([2, 2, 2, 0, 2, 0, 1, 5, 5, 1, 3], np.int32)
    src[6] = 2          # row 3 sends nothing
    return [from_edges(6, src, dst), from_edges(6, src[:0], dst[:0]),
            from_edges(0, src[:0], dst[:0])]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["mixed", "edgeless",
                                                  "empty"])
def test_edge_map_is_the_transposes_permutation(which):
    """t_pos[e] is forward edge e's position in the transpose: a
    permutation, the inverse of the transpose's stable order (which gives
    the same map on the card as torch.argsort(col_idx, stable=True))."""
    g = _map_graphs()[which]
    csr = ops.DeviceCsr.from_csr(g, "cpu", edge_map=True)
    t_pos = csr.edge_map()
    e = g.num_edges
    assert t_pos.dtype == torch.int32 and t_pos.shape == (e,)
    # a permutation of the edges
    assert torch.equal(torch.sort(t_pos.long()).values, torch.arange(e))
    order = torch.argsort(csr.col_idx.long(), stable=True)
    assert torch.equal(order[t_pos.long()], torch.arange(e))
    # forward edge e (u -> v) sits in the transpose's row u ...
    t_rows = torch.repeat_interleave(torch.arange(g.num_nodes),
                                     torch.diff(csr.t_row_ptr))
    assert torch.equal(t_rows[t_pos.long()], csr.col_idx.long())
    # ... as the transposed edge to v
    dst = torch.as_tensor(g.dst_idx.astype(np.int64))
    assert torch.equal(csr.t_col_idx[t_pos.long()].long(), dst)
    if which == 0:
        assert g.row_ptr[5] == g.row_ptr[4]                      # isolated
        assert csr.t_row_ptr[4] == csr.t_row_ptr[3]              # no out
        assert (g.col_idx == g.dst_idx).any()                    # self edge
        assert (np.unique(np.stack([g.col_idx, g.dst_idx]), axis=1).shape[1]
                < e)                                             # parallel


def test_edge_map_is_placed_only_where_attention_trains():
    """The forward-only CSR and the default CSR carry no map, and the GAT
    backward refuses a CSR without it; the trainer places it for a GAT
    model on the kernel backend only."""
    g = _map_graphs()[0]
    assert ops.DeviceCsr.from_csr(g, "cpu").t_pos is None
    with pytest.raises(ValueError, match="edge_map"):
        ops.DeviceCsr.from_csr(g, "cpu", transpose=False, edge_map=True)
    with pytest.raises(RuntimeError, match="edge map"):
        ops.DeviceCsr.from_csr(g, "cpu").edge_map()
    ts = [torch.randn((6, 2, 3), requires_grad=True) for _ in range(2)] + \
        [torch.randn((2, 3), requires_grad=True) for _ in range(2)]
    out = ops.gat_attend_kernel(*ts, ops.DeviceCsr.from_csr(g, "cpu"), SLOPE)
    with pytest.raises(RuntimeError, match="edge map"):
        out.sum().backward()
    for model, backend, want in (("gat", "binned", True),
                                 ("gat", "xla", False),
                                 ("gcn", "binned", False)):
        cfg = Config(dataset="mega-shard", layers=_LAYERS, device="cpu",
                     aggregate_backend=backend,
                     **{**_TRAIN, "model": model})
        tr = Trainer(cfg, datasets.get("mega-shard", seed=1),
                     build_model(model, _LAYERS, 0.0, heads=2))
        assert (tr.gdata.csr.t_pos is not None) == want, (model, backend)


def _bwd_inputs(n, k, f, csr, integer, seed):
    """Seeded residuals of the backward: x, as, ad, m, du, dz."""
    rng = np.random.default_rng(seed)
    if integer:
        h = rng.integers(0, 8, size=(n, k * f))
        a_src = np.zeros((k, f))
        a_dst = rng.integers(0, 3, size=(k, f))
        du = rng.integers(-4, 5, size=(n, k * f))
        dz = rng.integers(-4, 5, size=(n, k))
    else:
        h, a_src, a_dst, du, dz = (rng.normal(size=s) for s in (
            (n, k * f), (k, f), (k, f), (n, k * f), (n, k)))
    x, a_src, a_dst, du, dz = (torch.as_tensor(np.asarray(v, np.float32))
                               for v in (h, a_src, a_dst, du, dz))
    as_t, ad = G.gat_score_plain(x, a_src), G.gat_score_plain(x, a_dst)
    m = G.gat_forward_plain(x, as_t, ad, csr.row_ptr, csr.col_idx, SLOPE)[1]
    return x, as_t, ad, m, du, dz


@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
@pytest.mark.parametrize("k,f", [(2, 4), (3, 5), (1, 41)])
def test_dq_twins_and_their_segmented_sum(monkeypatch, k, f, integer):
    """The per-edge score gradient: ``gat_dq_plain`` is roc_tpu's ``_dq``
    formula on the forward edge order (edge.py:478-479, in jax at
    "highest"), the src twin gives the same bits in transposed order (row
    t_pos[e] of its dq is forward edge e's), and ``gat_dadl_plain``'s sum
    of it over each destination's in-edges gives
    ``gat_bwd_dst_plain``'s dadl (within 1e-6 of each row's max-abs;
    bitwise on integer data, where e = 1 and lrelu' = 1)."""
    g, _, _, _, csr = _setup(monkeypatch)
    n = g.num_nodes
    x, as_t, ad, m, du, dz = _bwd_inputs(n, k, f, csr, integer, 17)
    dq = G.gat_dq_plain(x, as_t, ad, m, du, dz, csr.row_ptr, csr.col_idx,
                        SLOPE)
    assert dq.shape == (g.num_edges, k) and dq.dtype == torch.float32
    # roc_tpu's per-edge form on the same residuals
    src, dst = g.col_idx, g.dst_idx
    jq = jnp.asarray(ad.numpy())[dst] + jnp.asarray(as_t.numpy())[src]
    je = jnp.exp(jnp.where(jq >= 0, jq, SLOPE * jq)
                 - jnp.asarray(m.numpy())[dst])
    jde = jnp.einsum("ekf,ekf->ek",
                     jnp.asarray(du.numpy()).reshape(n, k, f)[dst],
                     jnp.asarray(x.numpy()).reshape(n, k, f)[src],
                     precision="highest") + jnp.asarray(dz.numpy())[dst]
    want = np.asarray(je * jde * jnp.where(jq >= 0, 1.0, SLOPE))
    if integer:
        np.testing.assert_array_equal(dq.numpy(), want)
    else:
        assert norm_ulps(want, dq.numpy()) <= 32
    _, _, tq = G.gat_bwd_src_dq_plain(x, as_t, ad, m, du, dz, csr.t_row_ptr,
                                      csr.t_col_idx, SLOPE)
    np.testing.assert_array_equal(tq[csr.t_pos.long()].numpy().view(np.int32),
                                  dq.numpy().view(np.int32))
    dadl = G.gat_dadl_plain(tq, csr.t_pos, csr.row_ptr, csr.col_idx)
    ref = G.gat_bwd_dst_plain(x, as_t, ad, m, du, dz, csr.row_ptr,
                              csr.col_idx, SLOPE)
    if integer:
        assert torch.equal(dadl, ref)
    else:
        assert _row_rel_err(dadl.numpy(), ref.numpy()) <= 1e-6


def test_backward_twins_on_an_isolated_row_and_a_silent_source():
    """A destination with no in-edges gets dadl = 0; a source with no
    out-edges gets dtable = 0 and dast = 0; every dq slot is written."""
    g = _map_graphs()[0]
    csr = ops.DeviceCsr.from_csr(g, "cpu", edge_map=True)
    x, as_t, ad, m, du, dz = _bwd_inputs(6, 2, 3, csr, False, 2)
    dtable, dast, dq = G.gat_bwd_src(x, as_t, ad, m, du, dz, csr.t_row_ptr,
                                     csr.t_col_idx, SLOPE)
    dadl = G.gat_bwd_dst(dq, csr.t_pos, csr.row_ptr, csr.col_idx)
    assert torch.equal(dadl[4], torch.zeros(2))
    assert torch.equal(dtable[3], torch.zeros(6))
    assert torch.equal(dast[3], torch.zeros(2))
    assert bool(torch.isfinite(dq).all()) and bool((dq != 0).all())
    assert torch.equal(dq[csr.t_pos.long()], G.gat_dq_plain(
        x, as_t, ad, m, du, dz, csr.row_ptr, csr.col_idx, SLOPE))


# -- the forward kernel's geometry -------------------------------------------

FWD_SHAPES = [(3, 5), (8, 8), (40, 2), (2, 200), (4, 6), (2, 2), (1, 41),
              (4, 64), (1, 1), (1, 256)]


@pytest.mark.parametrize("layout", ["contiguous", "slice", "pair_slice"])
@pytest.mark.parametrize("k,f", FWD_SHAPES)
def test_forward_geometry_covers_each_row_in_whole_head_packs(k, f, layout):
    """``forward_geometry`` (what gat_fwd_rows is launched with): every pack
    of ``vec`` floats lies in one head (vec divides F, or K = 1) and ends
    within the row's ``ld`` floats; the (lanes, packs) pair is one the
    kernel instantiates, and its passes cover the H columns; the source's
    rows are aligned to the pack.  A staged plane (exactly the K = 1 rows
    that are not 16-byte aligned) has 16-byte rows of ld >= H."""
    h = k * f
    ld, ptr = {"contiguous": (h, 1 << 20), "slice": (h + 3, 4 + 8),
               "pair_slice": (h + 2, 8 + 16)}[layout]
    geo = G.forward_geometry(k, f, ld, ptr)
    assert (geo.lanes, geo.packs) in G.FWD_GROUPS
    assert geo.vec in (4, 2, 1)
    aligned16 = ld % 4 == 0 and ptr % 16 == 0
    assert geo.staged == (k == 1 and not aligned16)
    if geo.staged:
        assert geo.vec == 4 and geo.ld % 4 == 0 and h <= geo.ld < h + 4
    else:
        assert geo.ld == ld and ptr % (4 * geo.vec) == 0
    assert geo.ld % geo.vec == 0
    packs = -(-h // geo.vec)
    assert packs * geo.vec <= geo.ld
    per_pass = geo.lanes * geo.packs
    passes = -(-packs // per_pass)
    assert passes * per_pass * geo.vec >= h
    if passes > 1:
        assert (geo.lanes, geo.packs) == G.FWD_GROUPS[-1]
    for c in range(0, h, geo.vec):
        last = min(c + geo.vec, h) - 1
        assert k == 1 or c // f == last // f, (c, geo)
    # the narrowest group that covers the row in one pass
    fits = [g for g in G.FWD_GROUPS if packs <= g[0] * g[1]]
    assert (geo.lanes, geo.packs) == (fits[0] if fits else G.FWD_GROUPS[-1])


def test_forward_geometry_of_the_main_path():
    """The full-width GAT's two layers: 256 columns as 32 lanes x 2 packs
    of 4 (the parent's pass), 41 columns (4-byte rows) staged as a plane of
    44 columns in 16 lanes x 1 pack of 4 (the in-place gather that
    chip_variants.py times against it, 16 lanes x 3 packs of 1, is a group
    the kernel instantiates)."""
    assert G.forward_geometry(4, 64, 256, 0) == (4, 32, 2, False, 256)
    assert G.forward_geometry(1, 41, 41, 0) == (4, 16, 1, True, 44)
    assert (16, 3) in G.FWD_GROUPS
    # a 4-float pack would straddle heads at F = 6 and 2: 2-float packs
    assert G.forward_geometry(4, 6, 24, 0).vec == 2
    assert G.forward_geometry(2, 2, 4, 0).vec == 2


@pytest.mark.parametrize("h,ld", [(41, 44), (1, 4), (256, 256), (7, 8)])
def test_staged_plane_pads_with_zeros(h, ld):
    """``gat_stage`` on the CPU (aggregate_sum's exact ``stage_plain``, the
    staging kernel's plain version): x's columns in fp32, then zeros to
    ld = ld4(H) (the columns a surplus pack reads), on a column slice
    too."""
    rng = np.random.default_rng(h)
    wide = torch.as_tensor(rng.normal(size=(9, h + 2)).astype(np.float32))
    x = wide[:, 1:1 + h]
    plane = G.gat_stage(x)
    assert plane.dtype == torch.float32
    assert plane.shape == (9, ld) and plane.is_contiguous()
    assert torch.equal(plane[:, :h], x)
    assert torch.equal(plane[:, h:], torch.zeros((9, ld - h)))


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_forward_takes_a_column_slice(monkeypatch, precision):
    """gat_forward of a column slice of a wider tensor (rows not 16-byte
    aligned, as the kernel takes them) equals the forward of its
    contiguous copy bit for bit; in exact it matches roc_tpu's plan within
    32 norm-ULPs."""
    g, gplans, _, eidx, csr = _setup(monkeypatch)
    k, f = 1, 41
    h, a_src, a_dst = _gaussian(g.num_nodes, k, f, seed=13)
    wide = torch.zeros((g.num_nodes, k * f + 3))
    wide[:, 1:1 + k * f] = torch.as_tensor(h.reshape(g.num_nodes, -1))
    xs = wide[:, 1:1 + k * f]
    x = xs.contiguous()
    as_t = G.gat_score_plain(x, torch.as_tensor(a_src))
    ad = G.gat_score_plain(x, torch.as_tensor(a_dst))
    got = G.gat_forward(xs, as_t, ad, csr.row_ptr, csr.col_idx, SLOPE,
                        precision)
    want = G.gat_forward(x, as_t, ad, csr.row_ptr, csr.col_idx, SLOPE,
                         precision)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if precision == "exact":
        ref = jops.gat_attend_plan(*(jnp.asarray(v) for v in
                                     (h, h, a_src, a_dst)), gplans, eidx,
                                   SLOPE, "highest")
        assert norm_ulps(np.asarray(ref).reshape(g.num_nodes, -1),
                         got[0].numpy()) <= 32
