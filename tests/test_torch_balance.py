"""The port's online balancer (roc_tpu_torch.balance) and the SPMD
trainer's reshard against roc_tpu's, on the CPU.

Fixture: roc_tpu's "drift" graph (test_balance.py): groups of 300
degree-1 vertices, each followed by one degree-1300 hub.  The greedy cut
overshoots at every hub and leaves a 2x edge imbalance between parts, the
skew the online repartitioner exists to fix.

Tolerances:
  halo_counts, part_sizes, part_features, propose_bounds    element-equal
  the telemetry ring and its JSONL records                  equal
  the fit on planted weights (no prior) vs roc_tpu's fit    equal weights
  the prior                                                 its formula
  reshard onto the same cut                                 bitwise
  reshard onto a new cut vs roc_tpu's reshard               1e-5 relative
  the balanced run vs the unbalanced one                    1e-3 (roc_tpu's
                                                            contract)

Nothing here reads a wall clock: the balancer's reshard tests inject their
probe times (``BalanceManager.probe``), proportional to each part's live
edges as a sum's time is.
"""

import json

import numpy as np
import pytest

from roc_tpu.balance import OnlineCostModel as JModel
from roc_tpu.balance import TelemetryBuffer as JTelemetry
from roc_tpu.balance import search as jsearch
from roc_tpu.balance.telemetry import ShardSample as JSample
from roc_tpu.graph import datasets as jdatasets
from roc_tpu.graph.csr import from_edges as jfrom_edges
from roc_tpu.models import build_gcn as jbuild_gcn
from roc_tpu.parallel.spmd import SpmdTrainer as JSpmd
from roc_tpu.train.config import Config as JConfig
from roc_tpu_torch.balance import (OnlineCostModel, ShardSample,
                                   TelemetryBuffer, search)
from roc_tpu_torch.balance.cost_model import prior_times, prior_weights
from roc_tpu_torch.graph import lux
from roc_tpu_torch.graph.csr import from_edges
from roc_tpu_torch.graph.datasets import Dataset
from roc_tpu_torch.graph.partition import partition_graph
from roc_tpu_torch.memory.estimator import AGG_S_PER_EDGE_COLUMN
from roc_tpu_torch.models import build_gcn
from roc_tpu_torch.obs.roofline import PEAK_BW
from roc_tpu_torch.parallel.spmd import SpmdTrainer
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer

PARTS = 4
LAYERS = [12, 16, 4]


def _drift_arrays(groups=6):
    deg = np.concatenate([np.concatenate([np.ones(300, np.int64), [1300]])
                          for _ in range(groups)])
    n = deg.size  # 1806; E = 9600
    dst = np.repeat(np.arange(n), deg)
    src = (dst * 7 + np.arange(dst.size)) % n
    return n, src, dst


def drift_dataset():
    n, src, dst = _drift_arrays()
    g = from_edges(n, src, dst)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(n, 12)).astype(np.float32)
    lab = rng.integers(0, 4, size=n).astype(np.int64)
    mask = np.full(n, lux.MASK_TRAIN, np.int32)
    return Dataset("drift", g, feats, lux.one_hot(lab, 4), lab, mask, 12, 4)


def jdrift_dataset():
    n, src, dst = _drift_arrays()
    g = jfrom_edges(n, src, dst)
    ds = drift_dataset()
    return jdatasets.Dataset("drift", g, ds.features, ds.labels,
                             ds.label_ids, ds.mask, 12, 4)


def drift_cfg(**kw):
    # edge_shard off: the drift skew passes the auto threshold, and an
    # edge-sharded run has no per-part imbalance to fix
    kw.setdefault("num_parts", PARTS)
    return Config(layers=LAYERS, learning_rate=0.01, weight_decay=1e-4,
                  dropout_rate=0.0, eval_every=10**9, halo=True, seed=7,
                  edge_shard="off", device="cpu", **kw)


def _spmd(num_epochs, **kw):
    return SpmdTrainer(drift_cfg(num_epochs=num_epochs, **kw),
                       drift_dataset(), build_gcn(LAYERS, 0.0),
                       devices=["cpu"] * PARTS)


def _edge_probe(part, **_):
    """Probe times proportional to each part's live edges, plus a
    per-part constant: what a sum's time is, without a clock."""
    return [2e-9 * float(e) + 1e-6 for e in part.num_edges_valid]


# -- search and counters -----------------------------------------------------

@pytest.mark.parametrize("parts", [2, 4, 7])
def test_counters_equal_roc_tpu(parts):
    g = drift_dataset().graph
    part = partition_graph(g, parts)
    for fn in ("part_sizes",):
        for a, b in zip(getattr(search, fn)(g.row_ptr, part.bounds),
                        getattr(jsearch, fn)(g.row_ptr, part.bounds)):
            assert np.array_equal(a, b)
    for a, b in zip(search.halo_counts(g.row_ptr, g.col_idx, part.bounds),
                    jsearch.halo_counts(g.row_ptr, g.col_idx, part.bounds)):
        assert np.array_equal(a, b)
    for col in (g.col_idx, None):
        a = search.part_features(g.row_ptr, col, part.bounds)
        b = jsearch.part_features(g.row_ptr, col, part.bounds)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # empty parts in the canonical (n, n - 1) encoding at the end
    n = g.num_nodes
    bounds = np.asarray([[0, 700], [701, n - 1]] + [[n, n - 1]] *
                        (parts - 1), np.int64)[:max(parts, 2)]
    for a, b in zip(search.halo_counts(g.row_ptr, g.col_idx, bounds),
                    jsearch.halo_counts(g.row_ptr, g.col_idx, bounds)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("weights", [
    [2e-7, 5e-8, 1e-7, 8e-8, 1e-4],
    [0.0, 1e-8, 0.0, 0.0, 3e-5],
    [5e-9, 2e-8, 4e-7, 4e-7, 0.0]])
def test_propose_bounds_equal_roc_tpu(weights):
    """The same fitted weights in both packages' models: the same cut and
    the same predicted times, element for element."""
    g = drift_dataset().graph
    part = partition_graph(g, PARTS)
    ours, ref = OnlineCostModel(), JModel()
    ours.w = ref.w = np.asarray(weights, np.float64)
    a = search.propose_bounds(g.row_ptr, g.col_idx, PARTS, ours,
                              part.shard_nodes - 1, part.shard_edges)
    b = jsearch.propose_bounds(g.row_ptr, g.col_idx, PARTS, ref,
                               part.shard_nodes - 1, part.shard_edges)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    _, e_new = search.part_sizes(g.row_ptr, a[0])
    _, e_old = search.part_sizes(g.row_ptr, part.bounds)
    assert e_new.max() < e_old.max()


# -- the cost model -----------------------------------------------------------

W_TRUE = np.array([2e-7, 5e-8, 1e-7, 8e-8, 1e-4])   # roc_tpu's planted


def _planted(w_true):
    rng = np.random.default_rng(3)
    X = np.column_stack([rng.integers(100, 5000, 40),
                         rng.integers(1000, 50000, 40),
                         rng.integers(0, 2000, 40),
                         rng.integers(0, 2000, 40),
                         np.ones(40)]).astype(np.float64)
    t = X @ w_true * (1 + rng.normal(0, 0.01, 40))
    return X, t


def test_cost_model_fit_recovers_planted_weights():
    """The fit alone (no prior) recovers roc_tpu's planted weights, equal
    to roc_tpu's fit.  With the prior, whose rates are the card's, the fit
    on weights at the card's scale (twice the prior's) still explains its
    telemetry; roc_tpu's planted weights are TPU-scale (ms for 25k edges),
    ~1000x the card's prior, where the prior's pseudo-samples pull R^2 to
    0.93."""
    X, t = _planted(W_TRUE)
    a, b = OnlineCostModel(), JModel()
    r2 = a.fit(X, t, prior=False)
    assert r2 == b.fit(X, t, prior=False) and r2 > 0.98
    assert np.array_equal(a.w, b.w)
    np.testing.assert_allclose(a.w[:2], W_TRUE[:2], rtol=0.05)
    m = OnlineCostModel()
    X, t = _planted(2.0 * prior_weights())
    assert m.fit(X, t) > 0.98
    assert np.all(m.predict(X) >= 0)
    assert np.all(m.search_weights()[:4] >= 0)


def test_cost_model_prior_is_its_formula():
    X = np.array([[100, 1000, 0, 0, 1],
                  [100, 4000, 0, 0, 1],
                  [800, 1000, 0, 0, 1],
                  [100, 1000, 500, 500, 1]], dtype=np.float64)
    for width, item in ((32, 4), (602, 2)):
        t = prior_times(X, width, item)
        want = (X[:, 0] * width * 4 / PEAK_BW
                + X[:, 1] * width * AGG_S_PER_EDGE_COLUMN
                + (X[:, 2] + X[:, 3]) * width * item / PEAK_BW)
        np.testing.assert_allclose(t, want, rtol=1e-12)
        assert t[1] > t[0] and t[2] > t[0] and t[3] > t[0]
        m = OnlineCostModel(halo_width=width, halo_itemsize=item)
        assert np.array_equal(m.predict(X), t)       # unfit model = prior
        assert np.array_equal(m.search_weights(),
                              prior_weights(width, item))


# -- telemetry ----------------------------------------------------------------

def test_telemetry_ring_and_trace_equal_roc_tpu(tmp_path):
    paths = [tmp_path / "ours.jsonl", tmp_path / "ref.jsonl"]
    bufs = [TelemetryBuffer(capacity=8, trace_path=str(paths[0])),
            JTelemetry(capacity=8, trace_path=str(paths[1]))]
    g = drift_dataset().graph
    part = partition_graph(g, PARTS)
    hin, hout = search.halo_counts(g.row_ptr, g.col_idx, part.bounds)
    for ep in range(3):
        for buf, cls in zip(bufs, (ShardSample, JSample)):
            for p in range(PARTS):
                buf.record(cls(epoch=ep, part=p, time_s=1e-4 * (p + ep),
                               nodes=int(part.num_valid[p]),
                               edges=int(part.num_edges_valid[p]),
                               halo_in=int(hin[p]), halo_out=int(hout[p])))
    for buf in bufs:
        buf.record_epoch(0, 0.125, loss=3.5, peak_hbm=123,
                         peak_hbm_source="estimated")
        buf.record_event("balance", action="skip", rel_gain=0.01)
    assert len(bufs[0]) == len(bufs[1]) == 8          # ring capacity
    for a, b in zip(bufs[0].design(), bufs[1].design()):
        assert np.array_equal(a, b)
    assert paths[0].read_text() == paths[1].read_text()
    recs = [json.loads(x) for x in paths[0].read_text().splitlines()]
    assert [r["type"] for r in recs] == ["shard"] * 12 + ["epoch",
                                                         "balance"]


# -- config and the trainers --------------------------------------------------

def test_balance_env_overrides(monkeypatch):
    monkeypatch.setenv("ROC_BALANCE_EVERY", "3")
    monkeypatch.setenv("ROC_BALANCE_MIN_GAIN", "0.12")
    monkeypatch.setenv("ROC_BALANCE_TRACE", "/tmp/t.jsonl")
    for cfg in (Config(), JConfig()):
        assert cfg.balance_every == 3
        assert cfg.balance_min_gain == 0.12
        assert cfg.balance_trace == "/tmp/t.jsonl"
    monkeypatch.setenv("ROC_BALANCE_EVERY", "nope")
    for make in (Config, JConfig):
        with pytest.raises(SystemExit):
            make()


def test_trainers_that_cannot_reshard_ignore_the_balancer(capsys):
    ds = drift_dataset()
    tr = Trainer(drift_cfg(num_epochs=1, num_parts=1, balance_every=1,
                           verbose=True), ds, build_gcn(LAYERS, 0.0))
    assert tr.balancer is None
    assert "online balancing needs the SPMD" in capsys.readouterr().out
    # overcommit (k = 4 on one device) keeps the static cut
    over = SpmdTrainer(drift_cfg(num_epochs=1, balance_every=1), ds,
                       build_gcn(LAYERS, 0.0))
    assert over.k == 4 and over.balancer is None
    assert _spmd(1, balance_every=1).balancer is not None


def test_reshard_same_bounds_is_bit_for_bit():
    quiet = lambda *_: None  # noqa: E731
    ref = _spmd(4).train(print_fn=quiet)
    b = _spmd(2)
    b.train(print_fn=quiet)
    assert b._balance_supported()
    csr0 = [t.clone() for t in b.gdata.parts[1].csr if t is not None]
    cost = b.reshard(np.asarray(b.part.bounds, np.int64))
    assert cost > 0.0
    assert all(np.array_equal(x.numpy(), y.numpy()) for x, y in
               zip(csr0, [t for t in b.gdata.parts[1].csr if t is not None]))
    got = b.train(print_fn=quiet)  # epochs 2-3 (self.epoch persists)
    assert got.final_loss == ref.final_loss
    assert got.rebalance_events == [] and ref.rebalance_events == []


def test_reshard_new_cut_matches_roc_tpu_reshard():
    """Both packages reshard onto the same new cut (under the frozen S and
    E) after one epoch; the next two epochs' losses agree."""
    quiet = lambda *_: None  # noqa: E731
    jcfg = JConfig(layers=LAYERS, learning_rate=0.01, weight_decay=1e-4,
                   dropout_rate=0.0, eval_every=10**9, halo=True, seed=7,
                   edge_shard="off", num_parts=PARTS, num_epochs=1)
    j = JSpmd(jcfg, jdrift_dataset(), jbuild_gcn(LAYERS, 0.0))
    t = _spmd(1)
    j.train(print_fn=quiet)
    t.train(print_fn=quiet)
    g = t.dataset.graph
    m = OnlineCostModel()
    m.w = np.array([0.0, 1e-8, 0.0, 0.0, 0.0])
    bounds, _ = search.propose_bounds(g.row_ptr, g.col_idx, PARTS, m,
                                      t.part.shard_nodes - 1,
                                      t.part.shard_edges)
    assert not np.array_equal(bounds, t.part.bounds)
    j.reshard(bounds)
    t.reshard(bounds)
    assert np.array_equal(t.part.bounds, np.asarray(j.part.bounds))
    assert t.halo.K == j.halo.K
    assert np.array_equal(t.halo.send_idx, j.halo.send_idx)
    lj = [float(j.run_epoch()) for _ in range(2)]
    lt = [float(t.run_epoch()) for _ in range(2)]
    np.testing.assert_allclose(lt, lj, rtol=1e-5)


def test_balancer_reshards_and_matches_unbalanced_loss():
    """roc_tpu's acceptance (test_balance.py:294) with the probe times
    injected: a balance_every=2 run reshards the skewed cut once, evens
    out its live edges, and keeps the loss within 1e-3 of the unbalanced
    run."""
    quiet = lambda *_: None  # noqa: E731
    ref = _spmd(4).train(print_fn=quiet)
    b = _spmd(4, balance_every=2)
    b.balancer.probe = _edge_probe
    before = np.asarray(b.part.bounds).copy()
    got = b.train(print_fn=quiet)
    acts = [ev["action"] for ev in got.rebalance_events]
    assert acts == ["reshard"], acts
    ev = got.rebalance_events[0]
    assert ev["rel_gain"] >= b.balancer.min_gain
    assert ev["reshard_cost_s"] > 0
    assert not np.array_equal(np.asarray(b.part.bounds), before)
    g = b.dataset.graph
    _, edges_new = search.part_sizes(g.row_ptr, b.part.bounds)
    _, edges_old = search.part_sizes(g.row_ptr, before)
    assert edges_new.max() < edges_old.max()
    assert abs(got.final_loss - ref.final_loss) < 1e-3
    # the telemetry saw 4 parts a round and every epoch
    assert len(b.balancer.telemetry) == PARTS


def test_probe_measures_each_part_on_the_cpu():
    """The real probe (the port's sum over each part's live edges, plain
    on the CPU): one finite positive time a part; nothing is asserted on
    its value."""
    from roc_tpu_torch.balance.manager import probe_part_times
    part = partition_graph(drift_dataset().graph, PARTS)
    times = probe_part_times(part, "cpu", "exact", width=4)
    assert len(times) == PARTS and all(t > 0 for t in times)


def test_checkpoint_carries_the_cut(tmp_path):
    """A resumed run re-applies the cut its checkpoint trained on."""
    quiet = lambda *_: None  # noqa: E731
    path = str(tmp_path / "c.npz")
    a = _spmd(2, checkpoint_path=path)
    a.train(print_fn=quiet)
    g = a.dataset.graph
    m = OnlineCostModel()
    m.w = np.array([0.0, 1e-8, 0.0, 0.0, 0.0])
    bounds, _ = search.propose_bounds(g.row_ptr, g.col_idx, PARTS, m,
                                      a.part.shard_nodes - 1,
                                      a.part.shard_edges)
    a.reshard(bounds)
    a.save_checkpoint(path)
    b = _spmd(2, checkpoint_path=path, resume=True)
    assert np.array_equal(b.part.bounds, bounds) and b.epoch == 2
