"""The port's training slice (roc_tpu_torch) against roc_tpu.

Same numpy-seeded inputs (or the same dataset, byte-equal) and the same
parameters, carried by ``params_from_jax`` / ``opt_state_from_jax`` or by
a checkpoint, through roc_tpu and through the port on the CPU.  roc_tpu's
binned backend runs its Pallas kernels in interpret mode.

Tolerances:
  aggregation backward, integer data        bitwise
  aggregation backward, Gaussian data       1e-5 of each row's max-abs
                                            (fp32 sums in another order)
  loss, its gradient, the metrics           see each test
  Adam, 1 and 3 steps                       bitwise (params, m, v, t)
  trainer, 3 epochs (final loss, logits)    1e-3 relative (the ROADMAP
                                            bound)
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roc_tpu import ops as jops
from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_gcn as jbuild_gcn
from roc_tpu.ops import softmax as jsoftmax
from roc_tpu.optim.adam import Adam as JAdam
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.config import parse_args as jparse_args
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu_torch import ops
from roc_tpu_torch.fault.guard import guarded_update
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.graph.csr import from_edges
from roc_tpu_torch.models import build_gcn
from roc_tpu_torch.ops import aggregate as agg_mod
from roc_tpu_torch.ops import softmax
from roc_tpu_torch.ops.kernels import aggregate_linear as KL
from roc_tpu_torch.ops.kernels import aggregate_sum as K
from roc_tpu_torch.optim.adam import Adam
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config, parse_args
from roc_tpu_torch.train.driver import Trainer

ROOT = Path(__file__).resolve().parents[1]


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


def _random_graph(n=300, e=2000, seed=5):
    """Random multigraph with a hub destination, a hub source and some
    empty rows."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 20, e)
    dst[: e // 5] = 7
    src[e // 5: e // 3] = 11
    return from_edges(n, src, dst)


# -- the aggregation's backward ---------------------------------------------

def _jax_vjp(g, x, cot, backend, precision):
    if backend == "xla":
        def f(xx):
            return jops.scatter_gather(xx, jnp.asarray(g.col_idx),
                                       jnp.asarray(g.dst_idx), g.num_nodes,
                                       "sum")
    else:
        plans = jops.build_binned_plans(g.col_idx, g.dst_idx, g.num_nodes,
                                        g.num_nodes)

        def f(xx):
            return jops.scatter_gather_binned(xx, plans, True, precision)
    _, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(cot))[0])


def _port_grad(g, x, cot, backend, precision):
    csr = ops.DeviceCsr.from_csr(g, "cpu")
    xt = torch.tensor(x, requires_grad=True)
    if backend == "xla":
        out = ops.scatter_gather_plain(xt, csr, "sum", "exact")
    else:
        out = ops.scatter_gather(xt, csr, "sum", precision)
    out.backward(torch.as_tensor(cot))
    return xt.grad.numpy()


@pytest.mark.parametrize("data", ["integer", "gaussian"])
@pytest.mark.parametrize("backend,precision", [("xla", "exact"),
                                               ("binned", "exact"),
                                               ("binned", "fast")])
def test_aggregation_backward_matches_roc_tpu(backend, precision, data):
    g = _random_graph()
    rng = np.random.default_rng(7)
    h = 41
    if data == "integer":
        x = rng.integers(0, 2, (g.num_nodes, h)).astype(np.float32)
        cot = rng.integers(-3, 4, (g.num_nodes, h)).astype(np.float32)
    else:
        x = rng.standard_normal((g.num_nodes, h), dtype=np.float32)
        cot = rng.standard_normal((g.num_nodes, h), dtype=np.float32)
    got = _port_grad(g, x, cot, backend, precision)
    want = _jax_vjp(g, x, cot, backend, precision)
    if data == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        assert _row_rel_err(got, want) <= 1e-5
    if precision == "fast" and data == "gaussian":
        # the cotangent really takes its one bf16 rounding
        exact = _port_grad(g, x, cot, backend, "exact")
        assert _row_rel_err(got, exact) > 1e-4


def _kernel_like(x, row_ptr, col_idx, precision, launch=None):
    """What the CUDA wrapper hands back: a new tensor filled outside
    autograd, with no grad_fn of its own (``launch``, the CSR's launch
    configuration, is the kernel's)."""
    with torch.no_grad():
        out = K.aggregate_sum_plain(x, row_ptr, col_idx, precision)
    return torch.empty_like(out).copy_(out)


def test_aggregation_differentiates_through_a_kernel_output(monkeypatch):
    """A kernel fills its output outside autograd: the sum must still
    carry a grad_fn and the right gradient, as it does on the CPU."""
    g = _random_graph()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((g.num_nodes, 16), dtype=np.float32)
    cot = rng.standard_normal((g.num_nodes, 16), dtype=np.float32)
    want = _port_grad(g, x, cot, "binned", "fast")
    monkeypatch.setattr(agg_mod, "aggregate_sum", _kernel_like)
    xt = torch.tensor(x, requires_grad=True)
    out = ops.scatter_gather(xt, ops.DeviceCsr.from_csr(g, "cpu"), "sum",
                             "fast")
    assert out.grad_fn is not None
    out.backward(torch.as_tensor(cot))
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_aggregation_backward_is_the_sum_over_the_transpose(monkeypatch):
    """On the CPU the gradient comes from the Function's backward (one more
    plain sum, over the transposed CSR), not from index_add_'s autograd."""
    g = _random_graph()
    csr = ops.DeviceCsr.from_csr(g, "cpu")
    calls = []
    orig = K.aggregate_sum_plain

    def spy(x, row_ptr, col_idx, precision="fast"):
        calls.append(row_ptr)
        return orig(x, row_ptr, col_idx, precision)

    monkeypatch.setattr(agg_mod, "aggregate_sum_plain", spy)
    monkeypatch.setattr(K, "aggregate_sum_plain", spy)
    xt = torch.ones((g.num_nodes, 3), requires_grad=True)
    out = ops.scatter_gather(xt, csr, "avg", "exact")
    assert len(calls) == 1 and calls[0] is csr.row_ptr
    out.sum().backward()
    assert len(calls) == 2 and calls[1] is csr.t_row_ptr
    # d/dx_u sum_v mean_v = sum over u's out-edges v of 1/deg(v)
    deg = np.maximum(np.diff(g.row_ptr), 1).astype(np.float64)
    want = np.zeros(g.num_nodes)
    np.add.at(want, g.col_idx, 1.0 / deg[g.dst_idx])
    np.testing.assert_allclose(xt.grad[:, 0].numpy(), want, rtol=1e-6)


@pytest.mark.cuda
def test_kernel_outputs_differentiate_on_card():
    """On the card the sum and the megakernel layer carry a grad_fn, and
    their gradients equal the CPU's within fp32 reassociation (exact
    precision: in fast, a last-bit difference upstream can move a
    cotangent to the neighbouring bf16 value)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    g = _random_graph()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((g.num_nodes, 24), dtype=np.float32)
    w = rng.standard_normal((24, 8), dtype=np.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        csr = ops.DeviceCsr.from_csr(g, dev)
        xt = torch.tensor(x, device=dev, requires_grad=True)
        wt = torch.tensor(w, device=dev, requires_grad=True)
        h = ops.scatter_gather(xt, csr, "sum", "exact")
        y = ops.scatter_gather_linear(h, wt, csr, "exact", "relu")
        assert h.grad_fn is not None and y.grad_fn is not None
        y.square().sum().backward()
        grads[dev] = (xt.grad.cpu().numpy(), wt.grad.cpu().numpy())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _row_rel_err(a, b) <= 1e-5


def test_forward_only_csr_refuses_a_backward():
    """Serving places the CSR without its transpose; a backward through it
    raises instead of aggregating over the wrong edges."""
    g = _random_graph()
    csr = ops.DeviceCsr.from_csr(g, "cpu", transpose=False)
    assert csr.t_row_ptr is None and csr.t_col_idx is None
    xt = torch.ones((g.num_nodes, 3), requires_grad=True)
    out = ops.scatter_gather(xt, csr, "sum", "exact")
    np.testing.assert_array_equal(out.detach()[:, 0].numpy(),
                                  np.diff(g.row_ptr).astype(np.float32))
    with pytest.raises(RuntimeError, match="transpose"):
        out.sum().backward()


# -- softmax, metrics, Adam, the guard ---------------------------------------

def _logits_case(seed=0, n=300, c=7):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((n, c))).astype(np.float32)
    ids = rng.integers(0, c, n)
    labels = np.eye(c, dtype=np.float32)[ids]
    mask = rng.integers(0, 4, n).astype(np.int32)
    return logits, labels, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_gradient_and_metrics_match_roc_tpu(seed):
    logits, labels, mask = _logits_case(seed)
    jl, jg = jax.value_and_grad(jsoftmax.masked_softmax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    lt = torch.tensor(logits, requires_grad=True)
    loss = softmax.masked_softmax_cross_entropy(
        lt, torch.as_tensor(labels), torch.as_tensor(mask))
    loss.backward()
    # log-softmax and the sum run in another order: a few fp32 ULPs
    print(f"loss gap {abs(float(loss.detach()) - float(jl)):.2e}, gradient "
          f"gap {np.abs(lt.grad.numpy() - np.asarray(jg)).max():.2e}")
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    assert np.all((lt.grad.numpy() == 0) == (np.asarray(jg) == 0))
    ours = softmax.perf_metrics(lt.detach(), torch.as_tensor(labels),
                                torch.as_tensor(mask))
    ref = jsoftmax.perf_metrics(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(mask))
    for a, b in zip(ours[1:], ref[1:]):
        assert int(a) == int(b)
    np.testing.assert_allclose(float(ours.train_loss), float(ref.train_loss),
                               rtol=1e-6)
    for epoch in (0, 5, 120):
        assert softmax.format_metrics(epoch, ours) == \
            jsoftmax.format_metrics(epoch, ref)


def _adam_case(seed):
    rng = np.random.default_rng(seed)
    shapes = {"linear_0": (8, 16), "linear_1": (16, 4), "linear_10": (3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_matches_roc_tpu(steps):
    """Bitwise: the same fp32 operations in the same order, the per-step
    alpha_t's pow and sqrt included (1 ULP would be the fallback bound if a
    library's pow changed; it is not needed on these inputs)."""
    params, grads = _adam_case(steps)
    jopt = JAdam(alpha=0.01, weight_decay=5e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    opt = Adam(alpha=0.01, weight_decay=5e-4)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    ts = opt.init(tp)
    for i in range(steps):
        jp, js = jopt.update(jp, {k: jnp.asarray(v)
                                  for k, v in grads[i].items()}, js,
                             jnp.float32(0.01))
        tp, ts = opt.update(tp, {k: torch.as_tensor(v)
                                 for k, v in grads[i].items()}, ts, 0.01)
    for k in params:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(ts.m[k].numpy(), np.asarray(js.m[k]))
        np.testing.assert_array_equal(ts.v[k].numpy(), np.asarray(js.v[k]))
    assert int(ts.t) == int(js.t) == steps and ts.t.dtype == torch.int32


@pytest.mark.parametrize("bad", ["nan_grad", "inf_loss"])
def test_guard_skips_a_nonfinite_step_bit_for_bit(bad):
    params, grads = _adam_case(4)
    opt = Adam(alpha=0.01, weight_decay=5e-4)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    ts = opt.init(tp)
    g0 = {k: torch.as_tensor(v) for k, v in grads[0].items()}
    tp, ts, skipped, _ = guarded_update(opt, tp, g0, ts, 0.01,
                                        loss=torch.tensor(1.0))
    assert not bool(skipped)
    g1 = {k: torch.as_tensor(v) for k, v in grads[1].items()}
    loss = torch.tensor(2.0)
    if bad == "nan_grad":
        g1["linear_1"][2, 3] = float("nan")
    else:
        loss = torch.tensor(float("inf"))
    np2, ns2, skipped, gnorm = guarded_update(opt, tp, g1, ts, 0.01,
                                              loss=loss)
    assert bool(skipped)
    assert bool(torch.isfinite(gnorm)) == (bad == "inf_loss")
    for k in tp:
        assert torch.equal(np2[k], tp[k])
        assert torch.equal(ns2.m[k], ts.m[k])
        assert torch.equal(ns2.v[k], ts.v[k])
    assert int(ns2.t) == int(ts.t) == 1


# -- the slice as a whole: the trainer ---------------------------------------

BASE = dict(num_epochs=3, learning_rate=0.01, weight_decay=5e-4,
            dropout_rate=0.0, eval_every=1000)
# (dataset, seed, layers, roc_tpu backend, precision, megafuse)
TRAIN_CASES = [("roc-audit", 1, [8, 16, 4], "xla", "exact", False),
               ("roc-audit", 1, [8, 16, 4], "binned", "fast", False),
               ("mega-shard", 1, [64, 16, 8], "binned", "exact", True)]


def _quiet(*a, **k):
    pass


def _jax_trainer(name, seed, layers, backend, precision, megafuse, **kw):
    cfg = JConfig(dataset=name, layers=layers, seed=seed,
                  aggregate_backend=backend, aggregate_precision=precision,
                  megafuse=megafuse, **{**BASE, **kw})
    return JTrainer(cfg, jdatasets.get(name, seed=seed),
                    jbuild_gcn(layers, 0.0))


def _port_trainer(name, seed, layers, backend, precision, megafuse, **kw):
    cfg = Config(dataset=name, layers=layers, seed=seed,
                 aggregate_backend=backend, aggregate_precision=precision,
                 megafuse=megafuse, device="cpu", **{**BASE, **kw})
    return Trainer(cfg, datasets.get(name, seed=seed), build_gcn(layers, 0.0))


def _carry(jtr, tr):
    tr.params = checkpoint.params_from_jax(
        {k: np.asarray(v) for k, v in jtr.params.items()}, "cpu")
    tr.opt_state = checkpoint.opt_state_from_jax(
        jax.device_get(jtr.opt_state), "cpu")


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=lambda c: f"{c[0]}-{c[3]}-{c[4]}"
                                       f"{'-megafuse' if c[5] else ''}")
def test_trainer_tracks_roc_tpu(case, monkeypatch):
    """3 epochs from the same initial params: final loss and logits within
    1e-3; the port's steps went through the path the case names."""
    if case[5]:
        monkeypatch.setenv("ROC_BINNED_GEOM", "flat")
    jtr = _jax_trainer(*case)
    tr = _port_trainer(*case)
    _carry(jtr, tr)
    calls = {"sum": 0, "fwd": 0, "bwd": 0}
    for mod, name, key in ((agg_mod, "aggregate_sum", "sum"),
                           (agg_mod, "aggregate_sum_plain", "sum"),
                           (agg_mod, "aggregate_linear", "fwd"),
                           (agg_mod, "aggregate_linear_bwd", "bwd")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _k=key, **k: (
            calls.__setitem__(_k, calls[_k] + 1), _o(*a, **k))[1])
    jstats = jtr.train(print_fn=_quiet)
    stats = tr.train(print_fn=_quiet)
    want = np.asarray(jtr.predict_logits())
    got = tr.predict_logits().numpy()
    assert np.isfinite(stats.final_loss) and np.isfinite(got).all()
    loss_gap = abs(stats.final_loss - jstats.final_loss) \
        / abs(jstats.final_loss)
    print(f"port vs roc_tpu after 3 epochs: final loss {loss_gap:.2e} "
          f"relative, logits {_row_rel_err(got, want):.2e} of the row "
          f"max-abs")
    assert loss_gap <= 1e-3
    assert _row_rel_err(got, want) <= 1e-3
    # per step: 2 aggregations forward + 2 backward, or 2 fused layers
    # forward + 2 backward; each eval forward adds 2 (epoch 0 evaluates)
    evals = 1 + 1      # the eval at epoch 0 and predict_logits above
    if case[5]:
        assert calls == {"sum": 0, "fwd": 2 * (3 + evals), "bwd": 2 * 3}
    else:
        assert calls == {"sum": 4 * 3 + 2 * evals, "fwd": 0, "bwd": 0}


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default legitimately runs there")
    ds = datasets.get("roc-audit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(dataset="roc-audit", layers=[8, 16, 4]), ds,
                build_gcn([8, 16, 4]))


def _ckpt_case():
    return ("roc-audit", 1, [8, 16, 4], "xla", "exact", False)


@pytest.mark.parametrize("direction", ["roc_tpu_to_port", "port_to_roc_tpu"])
def test_checkpoint_resumes_across_packages(tmp_path, direction):
    """Train 2 epochs in one package, checkpoint, continue 1 epoch in the
    other: the same loss within 1e-3 as continuing in the first.  The LR
    decays at epoch 2, so the restored alpha and epoch both matter."""
    path = str(tmp_path / "ckpt.npz")
    decay = dict(decay_rate=0.5, decay_steps=2)
    jtr = _jax_trainer(*_ckpt_case(), num_epochs=2, checkpoint_path=path,
                       **decay)
    tr = _port_trainer(*_ckpt_case(), num_epochs=2, checkpoint_path=path,
                       **decay)
    _carry(jtr, tr)
    first = jtr if direction == "roc_tpu_to_port" else tr
    first.train(print_fn=_quiet)
    assert os.path.exists(path)
    # the other package resumes; the first one goes on by itself
    if direction == "roc_tpu_to_port":
        second = _port_trainer(*_ckpt_case(), num_epochs=1, **decay)
    else:
        second = _jax_trainer(*_ckpt_case(), num_epochs=1, **decay)
    second.restore(path)
    assert second.epoch == 2 and second.optimizer.alpha == 0.01
    first.config.num_epochs, first.config.checkpoint_path = 1, None
    a = first.train(print_fn=_quiet).final_loss
    b = second.train(print_fn=_quiet).final_loss
    assert first.optimizer.alpha == second.optimizer.alpha == 0.005
    assert np.isfinite(a) and abs(a - b) <= 1e-3 * abs(a)


def test_parse_args_matches_roc_tpu():
    argv = ["-dataset", "reddit", "-layers", "602-256-41", "-e", "10",
            "-lr", "0.02", "-decay", "0.0001", "-dropout", "0.3",
            "-decay-rate", "0.9", "-ds", "7", "-seed", "3",
            "-aggr-backend", "binned", "-aggr-precision", "exact",
            "-eval-every", "2", "-ckpt", "c.npz", "-ckpt-every", "4",
            "-resume", "-megafuse", "-v"]
    ours, ref = parse_args(argv + ["-device", "cpu"]), jparse_args(argv)
    for f in ("dataset", "layers", "num_epochs", "learning_rate",
              "weight_decay", "dropout_rate", "decay_rate", "decay_steps",
              "seed", "aggregate_backend", "aggregate_precision",
              "eval_every", "checkpoint_path", "checkpoint_every", "resume",
              "megafuse", "verbose"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.device == "cpu" and parse_args([]).device == "cuda"
    defaults, jdefaults = parse_args([]), jparse_args([])
    for f in ("num_epochs", "learning_rate", "weight_decay", "dropout_rate",
              "decay_rate", "decay_steps", "seed", "eval_every"):
        assert getattr(defaults, f) == getattr(jdefaults, f), f


_LINE = re.compile(r"^\t\[INFER\]\[(\d+)\] train_loss: \d+\.\d{4}  "
                   r"train_accuracy: \d+\.\d{2}%\(\d+/48\)  "
                   r"val_accuracy: \d+\.\d{2}%\(\d+/24\)  "
                   r"test_accuracy: \d+\.\d{2}%\(\d+/24\)$")


@pytest.mark.parametrize("device", ["cpu", None])
def test_cli_trains_on_cpu_only_when_asked(device):
    argv = [sys.executable, "-m", "roc_tpu_torch", "-dataset", "roc-audit",
            "-layers", "8-16-4", "-e", "10"]
    if device:
        argv += ["-device", device]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    if device is None:
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default legitimately runs")
        assert proc.returncode != 0 and "INFER" not in proc.stdout
        assert "-device cpu" in proc.stderr
        return
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [int(_LINE.match(ln).group(1)) for ln in lines] == [0, 5]
    assert "Layers: 8 16 4" in proc.stderr
