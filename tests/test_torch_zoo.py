"""The port's model zoo (roc_tpu_torch.models) against roc_tpu's: the
registry, the op IR, the CLI, and SAGE, GIN and gcn-chain trained 3 epochs
from the same parameters on the CPU.

Tolerances: the final loss and the logits within 1e-3 (relative, and of
each row's max-abs), the trainer bound of tests/test_torch_train.py; roc_tpu's
binned backend runs its Pallas kernels in interpret mode.
"""

import jax
import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild_model
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.config import parse_args as jparse_args
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu_torch import __main__ as cli
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_model
from roc_tpu_torch.ops import prng
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config, parse_args
from roc_tpu_torch.train.driver import Trainer

MODELS = ["gcn", "gcn-chain", "sage", "gin", "gat"]


@pytest.fixture(autouse=True)
def _binned_runs_under_jax_0_9(monkeypatch):
    """run_binned's one-shot eager warning calls jax.core.trace_state_clean,
    which jax 0.9.0 no longer exports (ROADMAP queue C)."""
    from roc_tpu.ops.pallas import binned
    monkeypatch.setattr(binned, "_EAGER_WARNED", [True])


def _row_rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).max(axis=1)
    s = np.abs(want).max(axis=1)
    return float(np.where(d == 0, 0.0, d / np.where(s == 0, 1.0, s)).max())


def _ir(model):
    keys = ("rate", "slot", "in_dim", "out_dim", "activation", "param",
            "aggr", "mode", "head_dim", "heads", "slope", "layer")
    return [(op.kind, op.inputs, op.out,
             {k: op.attrs[k] for k in keys if k in op.attrs})
            for op in model.ops]


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("aggr", ["", "sum", "avg"])
def test_build_model_matches_roc_tpu(name, aggr):
    """The same op IR and parameter shapes, or the same refusal."""
    layers = [8, 16, 16, 4]
    try:
        want = jbuild_model(name, layers, 0.3, aggr, heads=3)
    except ValueError:
        with pytest.raises(ValueError):
            build_model(name, layers, 0.3, aggr, heads=3)
        return
    got = build_model(name, layers, 0.3, aggr, heads=3)
    assert _ir(got) == _ir(want)
    assert got.logits.id == want.logits.id
    ours = got.init_params(prng.prng_key(0))
    ref = want.init_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for k, v in ref.items():      # roc_tpu's parameters, bit for bit
        assert np.array_equal(ours[k].numpy().view(np.uint32),
                              np.asarray(v).view(np.uint32)), k


def test_unknown_model_is_refused():
    with pytest.raises(ValueError, match="unknown model"):
        build_model("gcnn", [8, 4])


def test_parse_args_model_flags_match_roc_tpu():
    argv = ["-model", "gat", "-heads", "4", "-aggr", "avg"]
    ours, ref = parse_args(argv), jparse_args(argv)
    for f in ("model", "heads", "aggr"):
        assert getattr(ours, f) == getattr(ref, f), f
    d, jd = parse_args([]), jparse_args([])
    assert (d.model, d.heads, d.aggr) == (jd.model, jd.heads, jd.aggr)


@pytest.mark.parametrize("name", MODELS)
def test_cli_builds_the_model(monkeypatch, capsys, name):
    """``python -m roc_tpu_torch -model NAME`` builds and trains that model
    (the entry point's main, on the CPU)."""
    built = []
    real = cli.make_trainer

    def spy(cfg, ds, model):
        built.append(model)
        return real(cfg, ds, model)

    monkeypatch.setattr(cli, "make_trainer", spy)
    assert cli.main(["-dataset", "roc-audit", "-layers", "8-4-4", "-e", "1",
                     "-model", name, "-heads", "2", "-device", "cpu"]) == 0
    assert "[INFER][0] train_loss" in capsys.readouterr().out
    assert _ir(built[0]) == _ir(jbuild_model(name, [8, 4, 4], 0.5, "",
                                             heads=2))


BASE = dict(num_epochs=3, learning_rate=0.01, weight_decay=5e-4,
            dropout_rate=0.0, eval_every=1000)
# (model, layers, roc_tpu backend, precision)
ZOO_CASES = [("sage", [8, 16, 4], "xla", "exact"),
             ("sage", [8, 16, 4], "binned", "fast"),
             ("gin", [8, 16, 4], "xla", "exact"),
             ("gin", [8, 16, 4], "binned", "exact"),
             ("gcn-chain", [8, 16, 16, 4], "xla", "exact")]


@pytest.mark.parametrize("case", ZOO_CASES,
                         ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}")
def test_zoo_trains_like_roc_tpu(case):
    """Logits before training and the 3-epoch final loss and logits, from
    params carried from roc_tpu."""
    name, layers, backend, precision = case
    kw = dict(dataset="roc-audit", layers=layers, model=name,
              aggregate_backend=backend, aggregate_precision=precision,
              **BASE)
    jtr = JTrainer(JConfig(**kw), jdatasets.get("roc-audit"),
                   jbuild_model(name, layers, 0.0))
    tr = Trainer(Config(device="cpu", **kw), datasets.get("roc-audit"),
                 build_model(name, layers, 0.0))
    assert tr.gdata.backend == ("xla" if backend == "xla" else "kernel")
    tr.params = checkpoint.params_from_jax(
        {k: np.asarray(v) for k, v in jtr.params.items()}, "cpu")
    tr.opt_state = checkpoint.opt_state_from_jax(
        jax.device_get(jtr.opt_state), "cpu")
    logits0 = _row_rel_err(tr.predict_logits().numpy(),
                           np.asarray(jtr.predict_logits()))
    want = jtr.train(print_fn=lambda *a: None).final_loss
    got = tr.train(print_fn=lambda *a: None).final_loss
    logits = _row_rel_err(tr.predict_logits().numpy(),
                          np.asarray(jtr.predict_logits()))
    gap = abs(got - want) / abs(want)
    print(f"{name} ({backend}, {precision}): logits before {logits0:.2e}, "
          f"after {logits:.2e} of the row max-abs; final loss {gap:.2e} "
          f"relative")
    assert np.isfinite(got)
    assert logits0 <= 1e-3 and logits <= 1e-3 and gap <= 1e-3


@pytest.mark.parametrize("aggr", ["max", "min"])
def test_sage_extreme_gradients_match_roc_tpu(aggr):
    """SAGE 8-16-4 with ``-aggr max|min``, exact, on integer data: {0, 1}
    features and {-1, 0, 1} weights, so many rows' extreme is exactly 0
    (after the first layer's relu too).  Every parameter's gradient of the
    loss within 1e-6 of its max-abs of roc_tpu's (the max/min gradient is
    shared among the tied sources only, in both packages)."""
    from roc_tpu.train.driver import make_gctx as jmake_gctx
    layers = [8, 16, 4]
    kw = dict(dataset="roc-audit", layers=layers, model="sage", aggr=aggr,
              aggregate_backend="xla", aggregate_precision="exact", **BASE)
    jtr = JTrainer(JConfig(**kw), jdatasets.get("roc-audit"),
                   jbuild_model("sage", layers, 0.0, aggr))
    tr = Trainer(Config(device="cpu", **kw), datasets.get("roc-audit"),
                 build_model("sage", layers, 0.0, aggr))
    rng = np.random.default_rng(21)
    params = {k: rng.integers(-1, 2, np.shape(v)).astype(np.float32)
              for k, v in jtr.params.items()}
    x = rng.integers(0, 2, tuple(tr.x.shape)).astype(np.float32)
    want = jax.grad(lambda p: jtr.model.loss(
        p, jax.numpy.asarray(x), jtr.labels, jtr.mask,
        jmake_gctx(jtr.gdata, jtr.num_nodes), train=False))(
        {k: jax.numpy.asarray(v) for k, v in params.items()})
    ours = {k: v.detach().clone().requires_grad_(True)
            for k, v in checkpoint.params_from_jax(params, "cpu").items()}
    loss = tr.model.loss(ours, torch.as_tensor(x), tr.labels, tr.mask,
                         tr.gctx, train=False)
    keys = sorted(ours)
    got = dict(zip(keys, torch.autograd.grad(loss, [ours[k]
                                                    for k in keys])))
    for k in keys:
        w = np.asarray(want[k])
        gap = np.abs(got[k].numpy() - w).max() / np.abs(w).max()
        print(f"sage -aggr {aggr}: {k} gradient {gap:.2e} of its max-abs")
        assert np.abs(w).max() > 0 and gap <= 1e-6, k
