"""The port's observability (roc_tpu_torch/obs, the trainer's -obs and
-profile) against roc_tpu's: the counterparts of tests/test_obs.py:49-140,
:188, :202, :218 and :387.

Tolerances: obs on or off, the losses and params are bitwise equal; the
metrics records carry roc_tpu's keys."""

import json

import jax
import numpy as np
import pytest
import torch

from roc_tpu import obs as jobs
from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_gcn as jbuild_gcn
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu_torch import obs
from roc_tpu_torch.fault import inject
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_gcn
from roc_tpu_torch.obs import (PerfWatchdog, SpanTracer, load_jsonl,
                               validate_chrome_trace)
from roc_tpu_torch.obs.channel import global_norm
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer


@pytest.fixture(autouse=True)
def _tracers_as_found():
    """A -obs trainer enables the process's tracers; put them back."""
    was, jwas = obs.enabled(), jobs.enabled()
    yield
    obs.enable(was)
    jobs.enable(jwas)
    inject.detach()


def _quiet(*a, **k):
    pass


# -- tracer ------------------------------------------------------------------

def test_span_nesting_and_chrome_schema():
    tr = SpanTracer(capacity=16)
    tr.enabled = True
    with tr.span("outer", epoch=1):
        with tr.span("inner"):
            pass
        with tr.span("inner"):
            pass
    spans = tr.spans()
    assert [s.name for s in spans] == ["inner", "inner", "outer"]
    assert [s.depth for s in spans] == [1, 1, 0]
    outer = spans[-1]
    assert outer.args == {"epoch": 1}
    assert outer.dur_ns >= sum(s.dur_ns for s in spans[:2])
    trace = tr.to_chrome_trace()
    assert validate_chrome_trace(trace) == []
    json.dumps(trace)
    ev = trace["traceEvents"][-1]
    assert ev["ph"] == "X" and ev["name"] == "outer"
    assert ev["args"] == {"epoch": 1}
    # roc_tpu's validator accepts the port's trace, and the reverse
    assert jobs.validate_chrome_trace(trace) == []


def test_disabled_span_times_but_records_nothing():
    tr = SpanTracer()
    assert not tr.enabled
    with tr.span("quiet") as sp:
        pass
    assert sp.dur_s > 0
    assert tr.spans() == []


def test_tracer_ring_capacity_bounds_memory():
    tr = SpanTracer(capacity=4)
    tr.enabled = True
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.spans()) == 4
    assert tr.spans()[-1].name == "s9"


def test_validate_chrome_trace_flags_bad_events():
    for bad in ([], {"traceEvents": [{"ph": "X"}]},
                {"traceEvents": [{"ph": "X", "name": "a", "ts": "oops",
                                  "dur": 1, "pid": 1, "tid": 1}]},
                {"traceEvents": [{"ph": "X", "name": "a", "ts": 1,
                                  "pid": 1, "tid": 1}]}):
        assert validate_chrome_trace(bad) != []
        assert validate_chrome_trace(bad) == jobs.validate_chrome_trace(bad)


# -- watchdog -----------------------------------------------------------------

def test_watchdog_fires_on_injected_slow_epoch():
    wd, jwd = PerfWatchdog(), jobs.PerfWatchdog()
    for epoch in range(5):
        assert wd.observe_epoch(epoch, 0.1) is None
        assert jwd.observe_epoch(epoch, 0.1) is None
    alert = wd.observe_epoch(5, 0.3)
    assert alert is not None and alert["kind"] == "slow-epoch"
    assert alert["ratio"] == pytest.approx(3.0, rel=0.05)
    assert alert == jwd.observe_epoch(5, 0.3)
    assert wd.verdict() == "regressed"
    # the anomaly does not poison the EWMA it was measured against
    assert wd.observe_epoch(6, 0.1) is None


def test_watchdog_quiet_on_noise():
    wd = PerfWatchdog()
    noise = [0.1, 0.102, 0.098, 0.101, 0.099, 0.103, 0.097, 0.1]
    assert all(wd.observe_epoch(i, t) is None for i, t in enumerate(noise))
    assert wd.verdict() == "ok" and wd.alerts == []
    # epoch 0 carries the kernel builds and never trips the detector
    assert PerfWatchdog().observe_epoch(0, 99.0) is None


# -- the trainer under -obs ---------------------------------------------------

def _dataset():
    return datasets.synthetic("t", 80, 3.0, 8, 3, n_train=20, n_val=20,
                              n_test=20, seed=13)


def _trainer(obs_on, tmp_path=None, **kw):
    cfg = dict(layers=[8, 4, 3], num_epochs=3, eval_every=10 ** 9,
               dropout_rate=0.5, obs=obs_on, device="cpu")
    if obs_on:
        cfg["obs_dir"] = str(tmp_path / "obs") if tmp_path else ""
    cfg.update(kw)
    cfg = Config(**cfg)
    return Trainer(cfg, _dataset(), build_gcn(cfg.layers, 0.5))


def test_obs_is_a_pure_observer(tmp_path):
    """Losses and params of an -obs run are bitwise those of the run
    without it: the records observe the step, never change it."""
    ta = _trainer(False)
    tb = _trainer(True, tmp_path)
    for _ in range(4):
        la, lb = ta.run_epoch(), tb.run_epoch()
        assert torch.equal(la, lb)
    for k in ta.params:
        assert torch.equal(ta.params[k], tb.params[k])
    ta.config.num_epochs = tb.config.num_epochs = 2
    sa = ta.train(print_fn=_quiet)
    sb = tb.train(print_fn=_quiet)
    assert sa.final_loss == sb.final_loss
    for k in ta.params:
        assert torch.equal(ta.params[k], tb.params[k])


def _jax_obs_records(tmp_path, epochs):
    cfg = JConfig(layers=[8, 4, 3], num_epochs=epochs, eval_every=2,
                  dropout_rate=0.0, obs=True,
                  obs_dir=str(tmp_path / "jobs"), aggregate_backend="xla")
    ds = jdatasets.synthetic("t", 80, 3.0, 8, 3, n_train=20, n_val=20,
                             n_test=20, seed=13)
    JTrainer(cfg, ds, jbuild_gcn(cfg.layers, 0.0)).train(print_fn=_quiet)
    return jobs.load_jsonl(str(tmp_path / "jobs" / "metrics.jsonl"))


def test_obs_train_artifacts_match_roc_tpus(tmp_path):
    """A -obs run writes a trace.json that passes validate_chrome_trace with
    roc_tpu's seven span types and the step's four (a collector's pass
    adds ``gc``), one metrics record an epoch with roc_tpu's keys and
    values of the same kinds, and a closing train record."""
    obs.get_tracer().clear()
    tr = _trainer(True, tmp_path, num_epochs=4, eval_every=2,
                  dropout_rate=0.0, checkpoint_every=2,
                  checkpoint_path=str(tmp_path / "ck.npz"))
    tr.train(print_fn=_quiet)
    types = obs.get_tracer().span_types() - {"gc"}
    assert types == {"train", "epoch", "step_dispatch", "device_sync",
                     "metrics_fetch", "eval", "checkpoint", "train_step",
                     "forward", "backward", "update"}
    trace = json.load(open(tmp_path / "obs" / "trace.json"))
    assert validate_chrome_trace(trace) == []
    assert jobs.validate_chrome_trace(trace) == []
    recs = load_jsonl(str(tmp_path / "obs" / "metrics.jsonl"))
    kinds = [r["type"] for r in recs]
    assert kinds.count("metrics") == 4 and kinds[-1] == "train"
    jrecs = _jax_obs_records(tmp_path, 4)
    jm = [r for r in jrecs if r["type"] == "metrics"]
    ours = [r for r in recs if r["type"] == "metrics"]
    for mine, theirs in zip(ours, jm):
        assert set(mine) == set(theirs)
        for k in mine:
            assert type(mine[k]) is type(theirs[k]), k
        assert mine["wire_bytes"] == theirs["wire_bytes"] == 0
        assert mine["edges_per_shard"] == theirs["edges_per_shard"]
        assert mine["epoch"] == theirs["epoch"]
    assert [r["epoch"] for r in ours] == [0, 1, 2, 3]
    assert set(recs[-1]) == {r for r in jrecs[-1]}
    assert recs[-1]["watchdog_verdict"] in ("ok", "regressed")
    assert (tmp_path / "obs" / "metrics.prom").exists()
    # the record's norms are the step's
    last = ours[-1]
    assert last["param_norm"] == pytest.approx(
        float(global_norm(tr.params)), rel=1e-6)
    assert last["grad_norm"] > 0.0


def test_metrics_record_follows_a_nan_step(tmp_path):
    """A step.nan step is a metrics record with a NaN loss and a watchdog
    nonfinite alert, and the fault event lands in the same stream."""
    tr = _trainer(True, tmp_path, num_epochs=2, fault="seed=1,step.nan=1")
    try:
        tr.train(print_fn=_quiet)
    finally:
        inject.configure("")
    recs = load_jsonl(str(tmp_path / "obs" / "metrics.jsonl"))
    # the calibration ledger's setup predictions open the stream, as in
    # roc_tpu's; the run's own records follow them
    ledger = [r["model"] for r in recs[:2]]
    assert ledger == ["step_time", "peak_memory"]
    recs = [r for r in recs if r["type"] not in ("prediction",
                                                 "measurement")]
    assert recs[0] == {"type": "fault", "site": "step.nan", "call": 0}
    assert np.isnan(recs[1]["loss"]) and recs[1]["type"] == "metrics"
    assert {"type": "watchdog", "kind": "nonfinite", "epoch": 0,
            "consecutive": 1, "total": 1} in recs
    assert recs[-1]["watchdog_verdict"] == "nonfinite"


def test_profile_writes_a_trace_on_cpu(tmp_path):
    """-profile DIR with -profile-epochs 1:2 traces two epochs of the run
    into DIR/trace.json (Chrome trace) and says so."""
    lines = []
    tr = _trainer(False, profile_dir=str(tmp_path / "prof"),
                  profile_epochs="1:2", num_epochs=4)
    tr.train(print_fn=lines.append)
    path = tmp_path / "prof" / "trace.json"
    assert f"# profiler trace written to {path}" in lines
    trace = json.load(open(path))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_profile_window_clamps_into_a_short_run(tmp_path):
    """The default window 3:3 on a 2-epoch run traces its last epoch, as
    roc_tpu clamps it (driver.py:928-931)."""
    lines = []
    tr = _trainer(False, profile_dir=str(tmp_path / "p"), num_epochs=2)
    tr.train(print_fn=lines.append)
    assert (tmp_path / "p" / "trace.json").exists()
    assert sum("profiler trace" in ln for ln in lines) == 1


def test_jax_and_port_norms_agree():
    """The norm the records carry, on the same numbers in both packages."""
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}
    from roc_tpu.obs.channel import global_norm as jglobal_norm
    want = float(jax.jit(jglobal_norm)(tree))
    got = float(global_norm({k: torch.tensor(v) for k, v in tree.items()}))
    assert got == pytest.approx(want, rel=1e-6)
