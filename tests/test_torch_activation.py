"""The port's relu against roc_tpu's ``jnp.maximum(x, 0.0)``, down to the
gradient at an exact zero.

``jax.lax.max`` differentiates with a balanced rule: the cotangent times
0.5 where the two operands tie.  So roc_tpu's relu passes 0.5 g at x == 0
(either sign of zero), g above and 0 below (NaN included).  The port's
relu must give the same bits; an unfused GCN step on integer data, where
pre-activations hit exact zeros, must then give roc_tpu's gradients.

Tolerances:
  relu's VJP on a fixed vector              bitwise (the int32 patterns)
  GCN 8-16-4 step gradients, integer data   1e-6 of each parameter's
                                            max-abs (fp32 sums in another
                                            order after the degree norm)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_gcn as jbuild_gcn
from roc_tpu.ops.activation import relu as jrelu
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu.train.driver import make_gctx as jmake_gctx
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_gcn
from roc_tpu_torch.ops import activation
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer, dropout_key

X = np.array([-2.0, -0.0, 0.0, 1.5, np.nan], np.float32)
G = np.array([3.0, -1.5, 2.0, 0.25, -7.0], np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_relu_vjp_equals_roc_tpu_bitwise():
    y, vjp = jax.vjp(jrelu, jnp.asarray(X))
    want = np.asarray(vjp(jnp.asarray(G))[0])
    xt = torch.tensor(X, requires_grad=True)
    out = activation.relu(xt)
    out.backward(torch.as_tensor(G))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(_bits(xt.grad), _bits(want))
    # the tie passes half the cotangent, in both packages
    assert xt.grad[1] == -0.75 and xt.grad[2] == 1.0


def test_apply_activation_relu_takes_the_same_vjp():
    xt = torch.tensor(X, requires_grad=True)
    activation.apply_activation(xt, "relu").backward(torch.as_tensor(G))
    np.testing.assert_array_equal(_bits(xt.grad), _bits([0, -0.75, 1.0,
                                                          0.25, -0.0]))


LAYERS = [8, 16, 4]


def _integer_fixture(name="roc-audit", seed=1):
    """The audit graph in both packages with the same integer features in
    {0, 1, 2} (a fifth of the rows zero)."""
    jds = jdatasets.get(name, seed=seed)
    ds = datasets.get(name, seed=seed)
    rng = np.random.default_rng(11)
    feats = rng.integers(0, 3, ds.features.shape).astype(np.float32)
    feats[rng.random(feats.shape[0]) < 0.2] = 0.0
    return (dataclasses.replace(jds, features=feats),
            dataclasses.replace(ds, features=feats.copy()))


def _integer_params(tr, rng):
    """Every weight in {-1, 0, 1}; the first hidden column all zero, so
    its pre-activation is exactly 0 on every row."""
    out = {}
    for k, p in tr.params.items():
        w = rng.integers(-1, 2, tuple(p.shape)).astype(np.float32)
        if k == "linear_0":
            w[:, 0] = 0.0
        out[k] = torch.as_tensor(w)
    return out


def test_unfused_gcn_step_gradients_match_roc_tpu_at_exact_zeros(tmp_path):
    jds, ds = _integer_fixture()
    kw = dict(dataset="roc-audit", layers=LAYERS, seed=1, num_epochs=1,
              dropout_rate=0.0, aggregate_backend="xla",
              aggregate_precision="exact", eval_every=1000)
    tr = Trainer(Config(**kw, device="cpu"), ds, build_gcn(LAYERS, 0.0))
    jtr = JTrainer(JConfig(**kw), jds, jbuild_gcn(LAYERS, 0.0))
    assert "linear_0" in tr.params, sorted(tr.params)
    # both packages load the same integer weights from one npz checkpoint
    path = str(tmp_path / "int.npz")
    checkpoint.save(path, _integer_params(tr, np.random.default_rng(2)),
                    tr.opt_state, 0, 0.01)
    tr.restore(path)
    jtr.restore(path)

    seen = []
    orig = activation.relu

    def spy(x):
        seen.append(int((x == 0).sum()))
        return orig(x)

    params = {k: p.detach().requires_grad_(True)
              for k, p in tr.params.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(activation, "relu", spy)
        loss = tr.model.loss(params, tr.x, tr.labels, tr.mask, tr.gctx,
                             key=dropout_key(1, 0),
                             train=True)
    keys = sorted(params)
    got = dict(zip(keys, torch.autograd.grad(loss,
                                             [params[k] for k in keys])))
    assert seen and seen[0] > 0, "the fixture hit no exact zero"

    gctx = jmake_gctx(jtr.gdata, jtr.num_nodes, False, 1)
    jloss, jgrads = jax.value_and_grad(jtr._loss_fn())(
        jtr.params, jtr.x, jtr.labels, jtr.mask, gctx, key=jtr.key,
        train=True)
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert sorted(jgrads) == keys
    for k in keys:
        want = np.asarray(jgrads[k])
        scale = float(np.abs(want).max())
        assert scale > 0
        assert float(np.abs(got[k].numpy() - want).max()) <= 1e-6 * scale, k
