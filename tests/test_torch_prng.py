"""The port's random streams (roc_tpu_torch/ops/prng.py) against
jax.random as roc_tpu draws from it: keys, fold_in, bits, uniform floats
(the Glorot init) and Bernoulli masks bitwise; the dropout op and its
gradient bitwise against roc_tpu's ``ops.dropout``; and the trainer with
dropout, from its own init, tracking roc_tpu's trainer (no parameters
carried): final loss and logits within 1e-5 of the row max-abs after 3
epochs (fp32 sums and GEMMs in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild_model
from roc_tpu.ops.dropout import dropout as jdropout
from roc_tpu.ops.init import glorot_uniform as jglorot
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_model
from roc_tpu_torch.ops import dropout, glorot_uniform, prng
from roc_tpu_torch.ops.kernels import dropout as KD
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer, dropout_key


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _jkey(seed, *folds):
    k = jax.random.PRNGKey(seed)
    for d in folds:
        k = jax.random.fold_in(k, d)
    return k


def _key(seed, *folds):
    k = prng.prng_key(seed)
    for d in folds:
        k = prng.fold_in(k, d)
    return k


@pytest.mark.parametrize("seed,folds", [(0, ()), (1, (0,)), (1, (37, 1)),
                                        (-3, (5, 2)), (2**33 + 7, (9,)),
                                        (123456, (2**31 + 5, 0))])
def test_keys_match_jax(seed, folds):
    want = tuple(int(v) for v in np.asarray(
        jax.random.key_data(_jkey(seed, *folds))))
    assert _key(seed, *folds) == want


@pytest.mark.parametrize("shape", [(1,), (7, 5), (301, 17), (2, 3, 4)])
def test_bits_and_uniform_match_jax(shape):
    jk, k = _jkey(4, 2), _key(4, 2)
    n = int(np.prod(shape))
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).reshape(-1)
    np.testing.assert_array_equal(prng.random_bits(k, n).numpy(),
                                  want.astype(np.int64))
    np.testing.assert_array_equal(
        _bits(prng.uniform(k, shape).numpy()),
        _bits(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        _bits(prng.uniform(k, shape, -0.37, 1.9).numpy()),
        _bits(jax.random.uniform(jk, shape, minval=-0.37, maxval=1.9)))


@pytest.mark.parametrize("in_dim,out_dim", [(8, 16), (602, 256), (64, 1),
                                            (1433, 7)])
def test_glorot_matches_roc_tpu(in_dim, out_dim):
    """XLA fuses the scale into a multiply-add; the port's float64 sum
    rounds once the same way."""
    got = glorot_uniform(_key(1, 3), in_dim, out_dim).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jglorot(_jkey(1, 3), in_dim,
                                                out_dim)))


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5, 0.75])
def test_dropout_and_its_gradient_match_roc_tpu(rate):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((203, 37)).astype(np.float32)
    x[3, 4], x[7, 1] = 0.0, -0.0
    g = rng.standard_normal(x.shape).astype(np.float32)
    jk, k = _jkey(1, 6, 1), _key(1, 6, 1)
    want, vjp = jax.vjp(lambda t: jdropout(jk, t, rate, True), x)
    xt = torch.tensor(x, requires_grad=True)
    got = dropout(xt, rate, True, k)
    np.testing.assert_array_equal(_bits(got.detach().numpy()), _bits(want))
    got.backward(torch.tensor(g))
    np.testing.assert_array_equal(_bits(xt.grad.numpy()),
                                  _bits(vjp(g)[0]))
    assert dropout(xt, rate, False, k) is xt
    assert dropout(xt, 0.0, True, None) is xt
    with pytest.raises(ValueError, match="PRNG key"):
        dropout(xt, rate, True, None)


def test_dropout_key_is_roc_tpus_step_key():
    assert dropout_key(1, 12) == _key(1, 12)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_trainer_with_dropout_tracks_roc_tpu(model):
    """Both packages from their own seeded init, with dropout 0.5: the
    same parameters and masks, so the same curve."""
    layers = [8, 16, 4] if model == "gcn" else [8, 4, 4]
    base = dict(dataset="roc-audit", layers=layers, num_epochs=3,
                learning_rate=0.01, weight_decay=5e-4, dropout_rate=0.5,
                eval_every=1000, seed=1, model=model, heads=2,
                aggregate_backend="xla", aggregate_precision="exact")
    jtr = JTrainer(JConfig(**base), jdatasets.get("roc-audit"),
                   jbuild_model(model, layers, 0.5, heads=2))
    tr = Trainer(Config(device="cpu", **base), datasets.get("roc-audit"),
                 build_model(model, layers, 0.5, heads=2))
    for k, v in jtr.params.items():
        np.testing.assert_array_equal(_bits(tr.params[k].numpy()), _bits(v))
    jloss = jtr.train(print_fn=lambda *a: None).final_loss
    loss = tr.train(print_fn=lambda *a: None).final_loss
    want = np.asarray(jtr.predict_logits(), np.float64)
    got = tr.predict_logits().numpy().astype(np.float64)
    row = float((np.abs(got - want).max(1) / np.abs(want).max(1)).max())
    print(f"{model}, dropout 0.5, 3 epochs: loss "
          f"{abs(loss - jloss) / abs(jloss):.2e} relative, logits "
          f"{row:.2e} of the row max-abs")
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert row <= 1e-5


@pytest.mark.cuda
def test_dropout_kernel_matches_plain_on_card():
    """The kernel's forward and backward bitwise equal to the plain
    version's, at a width whose flat index crosses several blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4099, 257)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    k = _key(1, 3, 0)
    for rate in (0.5, 0.3):
        xc = torch.tensor(x, device="cuda", requires_grad=True)
        launches = KD.dropout.launches
        out = KD.dropout(xc, rate, k)
        out.backward(torch.tensor(g, device="cuda"))
        assert KD.dropout.launches == launches + 2
        xp = torch.tensor(x, requires_grad=True)
        ref = KD.dropout_plain(xp, rate, k)
        ref.backward(torch.tensor(g))
        np.testing.assert_array_equal(_bits(out.detach().cpu().numpy()),
                                      _bits(ref.detach().numpy()))
        np.testing.assert_array_equal(_bits(xc.grad.cpu().numpy()),
                                      _bits(xp.grad.numpy()))
