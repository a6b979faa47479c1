"""The port's GCN serving slice (roc_tpu_torch) against roc_tpu, end to end.

Same dataset (byte-equal, checked here), same weights (carried by a
roc_tpu checkpoint read by the port's loader, or by ``params_from_jax``),
then ``roc_tpu`` ``load_frozen(...).predict_logits()`` vs the port's on the
CPU.  Run at the ``roc-audit`` shape (GCN 8-16-4) and at a 4-layer
residual GCN (8-16-16-4, which adds the projected skip path).

Tolerances, relative to each row's max-abs:
  exact (JAX xla vs port xla)          1e-5  fp32 sums and GEMMs in
                                             another order
  fast  (JAX binned vs port kernel)    5e-3  one designed bf16 rounding at
                                             each aggregation input; a
                                             GEMM output that differs in
                                             its last fp32 bit can round to
                                             the neighbouring bf16 value
  served rows vs eval forward          32 ULPs (roc_tpu/serve/parity.py)
"""

import jax
import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild_model
from roc_tpu.serve import bucket_sizes as jbucket_sizes
from roc_tpu.serve import max_ulp_diff as jmax_ulp_diff
from roc_tpu.train import checkpoint as jcheckpoint
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.frozen import load_frozen as jload_frozen
from roc_tpu_torch.analysis import witness
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_model
from roc_tpu_torch.ops import prng
from roc_tpu_torch.serve import (ServeEngine, bucket_sizes, max_ulp_diff,
                                 run_load)
from roc_tpu_torch.serve.__main__ import selftest
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.frozen import load_frozen


@pytest.fixture(autouse=True)
def _lock_order_witness():
    # every test here runs under the armed lock-order witness: the locks it
    # creates record their acquisition orders, and an order outside the
    # port's threads.json fails the test at teardown
    with witness.armed_scope():
        yield


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


AUDIT = [8, 16, 4]
RESIDUAL = [8, 16, 16, 4]
# (layers, roc_tpu backend, precision, tolerance)
SLICES = [(AUDIT, "xla", "exact", 1e-5), (AUDIT, "binned", "fast", 5e-3),
          (RESIDUAL, "xla", "exact", 1e-5),
          (RESIDUAL, "binned", "fast", 5e-3)]


def _jax_bundle(layers, backend, precision):
    cfg = JConfig(dataset="roc-audit", layers=layers, dropout_rate=0.0,
                  aggregate_backend=backend, aggregate_precision=precision)
    ds = jdatasets.get(cfg.dataset)
    model = jbuild_model("gcn", layers, 0.0)
    return cfg, jload_frozen(cfg, ds, model)


@pytest.mark.parametrize("carry", ["checkpoint", "params_from_jax"])
@pytest.mark.parametrize("layers,backend,precision,tol", SLICES)
def test_frozen_logits_match_roc_tpu(tmp_path, layers, backend, precision,
                                     tol, carry):
    jcfg, jb = _jax_bundle(layers, backend, precision)
    want = np.asarray(jb.predict_logits())
    cfg = Config(dataset="roc-audit", layers=layers, dropout_rate=0.0,
                 aggregate_backend=backend, aggregate_precision=precision)
    ds = datasets.get(cfg.dataset)
    model = build_model("gcn", layers, 0.0)
    if carry == "checkpoint":
        path = str(tmp_path / "jax.ckpt.npz")
        jcheckpoint.save(path, jb.params, None, 0, 0.0)
        bundle = load_frozen(cfg, ds, model, checkpoint_path=path,
                             device="cpu")
    else:
        bundle = load_frozen(cfg, ds, model, device="cpu",
                             params=checkpoint.params_from_jax(
                                 {k: np.asarray(v)
                                  for k, v in jb.params.items()}, "cpu"))
    assert bundle.gdata.backend == ("xla" if backend == "xla" else "kernel")
    got = bundle.predict_logits().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _row_rel_err(got, want) <= tol


def test_serve_selftest_on_cpu(capsys):
    assert selftest("cpu") == 0
    out = capsys.readouterr().out
    assert "parity vs eval forward = 0 ULPs" in out
    assert "# serve selftest: OK" in out


def test_serve_selftest_takes_a_dataset(capsys):
    """``selftest(dataset=...)`` serves another graph at its own widths
    (GCN 64-16-8 on mega-shard), delta leg included; under this file's
    armed witness its lock orders stay on the port's graph."""
    from roc_tpu_torch.serve.__main__ import selftest
    assert selftest("cpu", dataset="mega-shard") == 0
    out = capsys.readouterr().out
    assert "delta leg" in out and "# serve selftest: OK" in out
    assert witness.observed_pairs(), "the witness saw no lock order"


def test_served_rows_match_eval_forward_and_ladder():
    cfg = Config(dataset="roc-audit", layers=RESIDUAL, serve_batch=8,
                 serve_wait_ms=1.0, aggregate_backend="binned")
    ds = datasets.get(cfg.dataset)
    with ServeEngine(cfg, ds, build_model("gcn", cfg.layers),
                     device="cpu") as eng:
        assert eng.buckets == [1, 2, 4, 8]
        assert [eng.bucket_for(n) for n in (1, 2, 3, 5, 8, 100)] == \
            [1, 2, 4, 8, 8, 8]
        eng.warmup()
        oracle = eng.bundle.predict_logits().numpy()
        ids = np.arange(ds.graph.num_nodes)
        assert max_ulp_diff(eng.query(ids), oracle) <= 32
        run_load(eng, n_requests=40, qps=2000.0, sizes=(1, 2, 3, 5, 8, 13))
        st = eng.stats()
        assert set(st["dispatches"]) == set(eng.buckets)
        assert st["forwards"] + st["logit_reuses"] == \
            sum(st["dispatches"].values())
        assert st["requests"] == 41
        with pytest.raises(IndexError):
            eng.query([ds.graph.num_nodes])


@pytest.mark.parametrize("cap", [1, 6, 8, 64])
def test_bucket_ladder_matches_roc_tpu(cap):
    assert bucket_sizes(cap) == jbucket_sizes(cap)


def _twelve_params(rng):
    """linear_0..linear_11, each a distinct shape: a key-order slip shows
    up as a shape mismatch or wrong values."""
    return {f"linear_{i}": rng.standard_normal((i + 1, 2)).astype(np.float32)
            for i in range(12)}


def test_checkpoint_leaf_order_is_jax_sorted_keys():
    params = _twelve_params(np.random.default_rng(0))
    jax_leaves = jax.tree.leaves(params)
    ours = checkpoint._leaves(params)
    assert [a.shape for a in ours] == [a.shape for a in jax_leaves]
    assert sorted(params)[:4] == ["linear_0", "linear_1", "linear_10",
                                  "linear_11"]


def test_checkpoint_roc_tpu_to_port(tmp_path):
    params = _twelve_params(np.random.default_rng(1))
    path = str(tmp_path / "j.npz")
    jcheckpoint.save(path, params, {"m": np.ones(3, np.float32)}, 4, 0.5)
    like = {k: torch.zeros(v.shape) for k, v in params.items()}
    got = checkpoint.load_params(path, like)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_checkpoint_port_to_roc_tpu(tmp_path):
    params = _twelve_params(np.random.default_rng(2))
    path = str(tmp_path / "t.npz")
    checkpoint.save(path, {k: torch.as_tensor(v) for k, v in params.items()})
    like = {k: np.zeros_like(v) for k, v in params.items()}
    got = jcheckpoint.load_params(path, like)
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)


def test_checkpoint_crc_rejects_corruption(tmp_path):
    params = {"linear_0": torch.arange(6.0).reshape(2, 3)}
    path = str(tmp_path / "c.npz")
    checkpoint.save(path, params)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["p_leaf_0"] = arrays["p_leaf_0"] + 1
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(checkpoint.CheckpointError, match="CRC32"):
        checkpoint.load_params(path, params)
    with pytest.raises(jcheckpoint.CheckpointError, match="CRC32"):
        jcheckpoint.load_params(path, {"linear_0": np.zeros((2, 3))})


@pytest.mark.parametrize("name,seed", [("roc-audit", 0), ("cora", 3),
                                       ("pubmed", 1)])
def test_dataset_bytes_match_roc_tpu(name, seed):
    ours, ref = datasets.get(name, seed=seed), jdatasets.get(name, seed=seed)
    for field in ("features", "labels", "label_ids", "mask"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert ours.graph.row_ptr.tobytes() == ref.graph.row_ptr.tobytes()
    assert ours.graph.col_idx.tobytes() == ref.graph.col_idx.tobytes()
    assert (ours.in_dim, ours.num_classes) == (ref.in_dim, ref.num_classes)


def test_ulp_metric_matches_roc_tpu():
    rng = np.random.default_rng(3)
    a = rng.standard_normal(1000).astype(np.float32)
    b = np.nextafter(a, np.float32(np.inf) * np.sign(a))
    b[::7] = -b[::7]
    for x, y in ((a, a), (a, b), (np.float32([0.0]), np.float32([-0.0])),
                 (np.float32([np.nan, 1]), np.float32([1, 1]))):
        assert max_ulp_diff(torch.as_tensor(x), y) == jmax_ulp_diff(x, y)


def test_glorot_init_shapes_and_range():
    model = build_model("gcn", RESIDUAL)
    params = model.init_params(prng.prng_key(0))
    assert sorted(params) == [f"linear_{i}" for i in range(6)]
    for op in model.ops:
        if op.kind == "linear":
            w = params[op.attrs["param"]]
            fan = op.attrs["in_dim"] + op.attrs["out_dim"]
            assert w.shape == (op.attrs["in_dim"], op.attrs["out_dim"])
            assert float(w.abs().max()) <= (6.0 / fan) ** 0.5
    again = model.init_params(prng.prng_key(0))
    assert all(torch.equal(params[k], again[k]) for k in params)
