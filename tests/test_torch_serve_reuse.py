"""Logit reuse in the port's serving engine (roc_tpu_torch/serve/engine.py):
the engine keeps the logits of its last full-graph forward and answers
every window from them until a graph install empties the slot.

- with no install, a request stream after warm-up runs no forward, and
  every served row is bitwise ``bundle.predict_logits()``'s row;
- after ``apply_delta`` the next window runs exactly one forward and its
  rows are bitwise a fresh forward of the patched graph; a no-op batch
  keeps the slot, a replan swap empties it, replaced weights refill it;
- a thread applying batches while queries stream: every answer is bitwise
  the oracle of one state its window could have read;
- an install that skips the invalidation serves stale rows, and the
  checks above see it;
- the counters: ``forwards + logit_reuses == sum(dispatches)``, and each
  ``serve_window`` span says whether its window ran the forward;
- a ``-stream`` engine runs one forward for any number of windows.

Everything on the CPU, bitwise: the served rows are an ``index_select`` of
the same tensor a fresh forward returns.
"""

import dataclasses
import threading
import time
import warnings

import numpy as np
import pytest

from roc_tpu_torch import obs
from roc_tpu_torch.analysis import witness
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.graph.csr import from_edges
from roc_tpu_torch.models import build_model
from roc_tpu_torch.serve import ServeEngine
from roc_tpu_torch.serve import delta as delta_mod
from roc_tpu_torch.train.config import Config

SIZES = (1, 2, 3, 5, 8, 13)


@pytest.fixture(autouse=True)
def _lock_order_witness():
    # the engine's worker and the delta threads take the plan lock: an
    # acquisition order outside the port's threads.json fails at teardown
    with witness.armed_scope():
        yield


@pytest.fixture
def tracer():
    was = obs.enabled()
    obs.get_tracer().clear()
    obs.enable(True)
    yield obs.get_tracer()
    obs.enable(was)
    obs.get_tracer().clear()


def _cfg(**kw):
    base = dict(dataset="roc-audit", layers=[8, 16, 4], dropout_rate=0.0,
                model="gcn", aggregate_backend="binned", serve_batch=8,
                serve_wait_ms=1.0, aggregate_precision="exact")
    base.update(kw)
    return Config(**base)


def _engine(ds, cfg=None, delta_journal="", start_queue=True):
    cfg = cfg or _cfg()
    m = build_model(cfg.model, cfg.layers, cfg.dropout_rate, cfg.aggr,
                    heads=cfg.heads)
    return ServeEngine(cfg, ds, m, start_queue=start_queue,
                       delta_journal=delta_journal, device="cpu")


def _oracle(eng) -> np.ndarray:
    """A fresh forward of the state installed now."""
    with eng._plan_lock:
        return eng.bundle.predict_logits().numpy()


def _quiet_apply(eng, add, ret=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return eng.apply_delta(add, ret, **kw)


def _stream(eng, n_requests, rng, nodes=None):
    """``n_requests`` mixed-size queries, all offered, then answered:
    [(ids, rows)]."""
    pick = nodes if nodes is not None else np.arange(eng.bundle.num_nodes)
    futs = []
    for i in range(n_requests):
        ids = rng.choice(pick, SIZES[i % len(SIZES)]).astype(np.int32)
        futs.append((ids, eng.submit(ids)))
    return [(ids, f.result(60.0)) for ids, f in futs]


def _fresh_edge(ds, d, rng):
    """A source that is not yet an in-neighbour of ``d``."""
    g = ds.graph
    have = set(g.col_idx[g.row_ptr[d]:g.row_ptr[d + 1]].tolist())
    return int(rng.choice([s for s in range(g.num_nodes) if s not in have]))


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_no_install_runs_no_forward_and_serves_the_forward(precision):
    ds = datasets.get("roc-audit", seed=1)
    with _engine(ds, _cfg(aggregate_precision=precision)) as eng:
        eng.warmup()
        f0, r0 = eng.forwards, eng.logit_reuses
        d0 = sum(eng.dispatches.values())
        answers = _stream(eng, 40, np.random.default_rng(3))
        oracle = _oracle(eng)
        for ids, rows in answers:
            np.testing.assert_array_equal(rows, oracle[ids])
        assert eng.forwards == f0
        assert eng.logit_reuses - r0 == sum(eng.dispatches.values()) - d0
        assert eng.logit_reuses - r0 >= 1


def test_next_window_after_a_delta_sees_the_patch():
    ds = datasets.get("roc-audit", seed=1)
    rng = np.random.default_rng(5)
    with _engine(ds) as eng:
        eng.warmup()
        d = 17
        before = eng.query([d, 3])
        f0 = eng.forwards
        add = np.asarray([[_fresh_edge(ds, d, rng), d]])
        assert _quiet_apply(eng, add)["mode"] == "applied"
        assert eng._logits is None       # dropped with the swap
        after = eng.query([d, 3])
        assert eng.forwards == f0 + 1
        oracle = _oracle(eng)
        np.testing.assert_array_equal(after, oracle[[d, 3]])
        assert not np.array_equal(after[0], before[0])
        # the patched graph's logits against an engine built on it
        ds2 = dataclasses.replace(
            ds, graph=from_edges(ds.graph.num_nodes,
                                 *eng.deltas._live_edges()))
        with _engine(ds2, delta_journal=None, start_queue=False) as fresh:
            np.testing.assert_array_equal(
                after, fresh._serve_rows(np.asarray([d, 3], np.int32)))
        # and the windows after it reuse the new table
        again = _stream(eng, 12, rng)
        assert eng.forwards == f0 + 1
        for ids, rows in again:
            np.testing.assert_array_equal(rows, oracle[ids])


def test_noop_batch_keeps_the_slot():
    ds = datasets.get("roc-audit", seed=1)
    g = ds.graph
    with _engine(ds) as eng:
        eng.warmup()
        slot = eng._logits
        f0 = eng.forwards
        live = np.stack([g.col_idx[:2], g.dst_idx[:2]], 1)
        assert _quiet_apply(eng, live)["mode"] == "noop"
        assert eng._logits is slot
        eng.query(g.dst_idx[:2])
        assert eng.forwards == f0


def test_replan_swap_empties_the_slot(monkeypatch):
    monkeypatch.setattr(delta_mod, "HEADROOM_EDGES", 64)
    ds = datasets.get("roc-audit", seed=1)
    n = ds.graph.num_nodes
    with _engine(ds) as eng:
        eng.warmup()
        f0 = eng.forwards
        i = np.arange(300)
        big = np.stack([i % n, (7 * i + 1) % n], 1)
        r = _quiet_apply(eng, big, wait_replan=True)
        assert r["mode"] == "replanning"
        assert eng.delta_stats()["swaps"] == 1
        assert eng._logits is None
        ids = np.unique(big[:, 1])[:8]
        rows = eng.query(ids)
        assert eng.forwards == f0 + 1
        np.testing.assert_array_equal(rows, _oracle(eng)[ids])


def test_replaced_weights_refill_the_slot():
    ds = datasets.get("roc-audit", seed=1)
    with _engine(ds, delta_journal=None) as eng:
        eng.warmup()
        old = eng.query(np.arange(8))
        f0 = eng.forwards
        eng.bundle.params = {k: 2.0 * v for k, v in eng.bundle.params.items()}
        new = eng.query(np.arange(8))
        assert eng.forwards == f0 + 1
        np.testing.assert_array_equal(new, _oracle(eng)[:8])
        assert not np.array_equal(new, old)


def _batches(ds, count, rng):
    """``count`` batches of 3 adds and 1 retire onto nodes 0..15, so the
    queries below read rows the batches change."""
    g = ds.graph
    out = []
    for _ in range(count):
        add = np.stack([rng.integers(0, g.num_nodes, 3),
                        rng.integers(0, 16, 3)], 1)
        e = int(rng.integers(0, g.num_edges))
        out.append((add, np.asarray([[g.col_idx[e], g.dst_idx[e]]])))
    return out


def test_racing_delta_thread_serves_a_state_it_could_read():
    ds = datasets.get("roc-audit", seed=1)
    batches = _batches(ds, 24, np.random.default_rng(11))
    # the oracle of each state: b batches applied, in order
    states = []
    with _engine(ds, start_queue=False) as ref:
        states.append(_oracle(ref))
        for add, ret in batches:
            _quiet_apply(ref, add, ret)
            states.append(_oracle(ref))
    calls, rets = [], []

    def churn():
        for add, ret in batches:
            calls.append(time.perf_counter())
            _quiet_apply(eng, add, ret)
            rets.append(time.perf_counter())
            time.sleep(0.005)

    rng = np.random.default_rng(13)
    with _engine(ds) as eng:
        eng.warmup()
        f0, r0 = eng.forwards, eng.logit_reuses
        d0 = sum(eng.dispatches.values())
        th = threading.Thread(target=churn)
        th.start()
        answers = []
        while th.is_alive() or not answers:
            ids = rng.integers(0, 16, SIZES[len(answers) % len(SIZES)])
            t_sub = time.perf_counter()
            rows = eng.query(ids, timeout=60.0)
            answers.append((ids, rows, t_sub, time.perf_counter()))
        th.join()
        forwards = eng.forwards - f0
        reuses = eng.logit_reuses - r0
        dispatches = sum(eng.dispatches.values()) - d0
    assert len(rets) == len(batches)
    for ids, rows, t_sub, t_done in answers:
        lo = sum(1 for t in rets if t < t_sub)
        hi = sum(1 for t in calls if t < t_done)
        assert any(np.array_equal(rows, states[b][ids])
                   for b in range(lo, hi + 1)), (lo, hi)
    assert 1 <= forwards <= len(batches)
    assert reuses >= 1 and forwards + reuses == dispatches


def test_an_install_that_keeps_the_table_is_caught(monkeypatch):
    """The checks above fail when an install leaves the slot alone: the
    stale table answers, and its rows are not the patched graph's."""
    def install_only(self, gdata):
        self.bundle.gdata = gdata
    monkeypatch.setattr(ServeEngine, "_install_gdata", install_only)
    ds = datasets.get("roc-audit", seed=1)
    rng = np.random.default_rng(5)
    with _engine(ds) as eng:
        eng.warmup()
        d = 17
        f0 = eng.forwards
        add = np.asarray([[_fresh_edge(ds, d, rng), d]])
        assert _quiet_apply(eng, add)["mode"] == "applied"
        stale = eng.query([d, 3])
        assert eng.forwards == f0
        assert not np.array_equal(stale, _oracle(eng)[[d, 3]])


def test_counters_and_window_spans(tracer):
    ds = datasets.get("roc-audit", seed=1)
    rng = np.random.default_rng(7)
    with _engine(ds) as eng:
        eng.warmup()
        tracer.clear()
        f0, r0 = eng.forwards, eng.logit_reuses
        d0 = sum(eng.dispatches.values())
        eng.query(np.arange(20))                 # 3 dispatches, reused
        _quiet_apply(eng, np.asarray([[_fresh_edge(ds, 5, rng), 5]]))
        eng.query(np.arange(20))                 # 1 forward, 2 reused
        eng.query([5])                           # reused
        st = eng.stats()
        assert st["forwards"] - f0 == 1
        assert st["logit_reuses"] - r0 == 6
        assert st["forwards"] + st["logit_reuses"] == \
            sum(st["dispatches"].values())
        assert sum(st["dispatches"].values()) - d0 == 7
        wins = [s for s in tracer.spans() if s.name == "serve_window"]
        assert [s.args["forward"] for s in wins] == [0, 1, 0]


def test_streamed_engine_runs_one_forward():
    ds = datasets.get("roc-audit", seed=1)
    cfg = _cfg(stream=True, num_parts=3)
    with _engine(ds, cfg, delta_journal=None) as eng:
        try:
            assert eng.forwards == 1             # at construction
            eng.warmup()
            answers = _stream(eng, 30, np.random.default_rng(2))
            assert eng.forwards == 1
            oracle = _oracle(eng)
            for ids, rows in answers:
                np.testing.assert_array_equal(rows, oracle[ids])
        finally:
            eng.bundle.stream_trainer.close()
