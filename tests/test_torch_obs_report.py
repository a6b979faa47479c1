"""The calibration ledger, the report CLI and the watchdog's serving and
calibration feeds of the port (roc_tpu_torch/obs/ledger.py, report.py,
__main__.py, watchdog.py) against roc_tpu's (roc_tpu/obs).

- ``join``, ``calibration_report`` and ``validate_records`` equal
  roc_tpu's on one record list;
- the watchdog's serve, delta, fleet and calibration feeds equal roc_tpu's
  alert for alert, with their state round trip across packages;
- ``report`` text equals roc_tpu's on one artifact pair (a port ``-obs``
  run's trace.json and metrics.jsonl);
- the calibration selftest pairs >= 5 cost models on the CPU; a CPU run's
  records carry no ``mfu`` (the peaks are the card's); the engine's
  ``serve-p50`` pair and serve feed.

Every comparison is exact (equal dicts, equal text).
"""

import json

import numpy as np
import pytest

from roc_tpu.obs import ledger as jledger
from roc_tpu.obs import report as jreport
from roc_tpu.obs.watchdog import PerfWatchdog as JPerfWatchdog
from roc_tpu_torch import obs
from roc_tpu_torch.fault import inject
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_gcn
from roc_tpu_torch.obs import __main__ as cli
from roc_tpu_torch.obs import ledger, report
from roc_tpu_torch.obs.metrics import load_jsonl
from roc_tpu_torch.obs.watchdog import PerfWatchdog
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer


@pytest.fixture(autouse=True)
def _obs_as_found():
    was = obs.enabled()
    yield
    obs.enable(was)
    inject.detach()
    ledger.get_ledger().detach()


def _records():
    """One seeded stream through both packages' ledgers: predictions,
    joined and unjoined measurements, a re-prediction, a zero prediction
    and a malformed record."""
    out = {"port": [], "roc_tpu": []}
    for name, mod in (("port", ledger), ("roc_tpu", jledger)):
        led = mod.CalibrationLedger()
        led.attach(lambda kind, out=out[name], **f:
                   out.append({"type": kind, **f}))
        r = np.random.default_rng(3)
        for i in range(40):
            m = ["step_time", "wire_bytes", "delta-apply", "serve-p50"][i % 4]
            key = mod.content_key(rows=int(r.integers(1, 3)), m=m)
            if r.random() < 0.6:
                led.predict(m, key, float(r.uniform(0.5, 2.0)), "s")
            if r.random() < 0.7:
                led.measure(m, key, float(r.uniform(0.1, 3.0)), "s",
                            epoch=i)
        led.predict("zero", "k", 0.0, "s")
        led.measure("zero", "k", 1.0, "s")
        led.measure("orphan", "k", 1.0, "s")
    assert out["port"] == out["roc_tpu"]
    recs = out["port"]
    recs.append({"type": "measurement", "model": "bad", "value": "x"})
    # the same stream with the inline joins stripped, for join()
    stripped = [{k: v for k, v in r.items()
                 if k not in ("predicted", "ratio")} for r in recs]
    return recs, stripped


def test_join_report_and_validate_equal_roc_tpus():
    recs, stripped = _records()
    for rs in (recs, stripped):
        assert ledger.join(rs) == jledger.join(rs)
        assert ledger.calibration_report(rs) == \
            jledger.calibration_report(rs)
        assert ledger.validate_records(rs) == jledger.validate_records(rs)
    assert ledger.validate_records(recs)        # the malformed record
    rep = ledger.calibration_report(stripped)
    assert set(rep["models"]) >= {"step_time", "wire_bytes"}
    assert rep["unpaired_measurements"] >= 2


def test_content_key_and_ledger_api_match():
    kv = dict(b=2, a="x", rows=7)
    assert ledger.content_key(**kv) == jledger.content_key(**kv) == \
        "a=x|b=2|rows=7"
    led, jled = ledger.CalibrationLedger(), jledger.CalibrationLedger()
    for lg in (led, jled):
        lg.predict("m", "k", 2.0, "s")
        assert lg.measure("m", "k", 3.0, "s") == 1.5
        assert lg.measure("m", "nokey", 3.0, "s") is None
    assert list(led.records) == list(jled.records)
    assert led.drain_ratios() == jled.drain_ratios() == [("m", 1.5)]
    assert led.drain_ratios() == []


@pytest.mark.parametrize("feed", ["observe_serve", "observe_delta",
                                  "observe_fleet"])
def test_latency_feeds_match_roc_tpu(feed):
    rng = np.random.default_rng(7)
    wd, jwd = PerfWatchdog(), JPerfWatchdog()
    for i in range(60):
        v = float(rng.choice([0.01, 0.011, 0.009, 0.05, 0.3]))
        assert getattr(wd, feed)(i, v) == getattr(jwd, feed)(i, v)
    assert wd.alerts == jwd.alerts and wd.alerts
    assert wd.verdict() == jwd.verdict()
    state = wd.state_dict()
    assert state == jwd.state_dict()
    wd2 = PerfWatchdog()
    wd2.load_state(json.loads(json.dumps(jwd.state_dict())))
    assert wd2.state_dict() == state


def test_calibration_feed_matches_roc_tpu():
    wd, jwd = PerfWatchdog(), JPerfWatchdog()
    pairs = [("a", 1.0), ("a", 1.1), ("a", 5.0), ("a", 6.0), ("b", 0.1),
             ("b", 0.1), ("b", 0.1), ("a", -1.0), ("b", 0.0), ("c", 1.0)]
    for i, (m, r) in enumerate(pairs):
        assert wd.observe_calibration(m, r, i) == \
            jwd.observe_calibration(m, r, i)
    assert wd.alerts == jwd.alerts and len(wd.alerts) >= 2
    assert wd.verdict() == jwd.verdict() == "calibration-drift"
    assert wd.state_dict() == jwd.state_dict()


def test_verdict_ladder_matches_roc_tpu():
    kinds = ["calibration-drift", "fleet-lag", "delta-apply",
             "serve-latency", "spill-stall", "stream-stall", "slow-epoch",
             "nonfinite"]
    wd, jwd = PerfWatchdog(), JPerfWatchdog()
    for k in kinds:
        for w in (wd, jwd):
            w.alerts.append({"kind": k})
        assert wd.verdict() == jwd.verdict()


def _obs_run(tmp_path, epochs=3):
    ds = datasets.synthetic("t", 80, 3.0, 8, 3, n_train=20, n_val=20,
                            n_test=20, seed=13)
    cfg = Config(layers=[8, 4, 3], num_epochs=epochs, eval_every=10 ** 9,
                 dropout_rate=0.0, obs=True, obs_dir=str(tmp_path / "obs"),
                 device="cpu")
    Trainer(cfg, ds, build_gcn(cfg.layers, 0.0)).train(
        print_fn=lambda *a: None)
    return tmp_path / "obs"


def test_report_text_equals_roc_tpus(tmp_path):
    d = _obs_run(tmp_path)
    trace, metrics = str(d / "trace.json"), str(d / "metrics.jsonl")
    recs = load_jsonl(metrics)
    assert any(r["type"] == "prediction" for r in recs)
    assert all("mfu" not in r and "roofline_frac" not in r
               for r in recs if r["type"] == "metrics")   # CPU: no peaks
    got = report.report(trace_path=trace, metrics_path=metrics)
    assert got == jreport.report(trace_path=trace, metrics_path=metrics)
    assert "# calibration:" in got and "step_time" in got
    out = []
    assert report.calibration(metrics, out=out.append) == 0
    jout = []
    assert jreport.calibration(metrics, out=jout.append) == 0
    assert out == jout


def test_cli_report_calibration_and_missing(tmp_path, capsys):
    d = _obs_run(tmp_path, epochs=2)
    assert cli.main(["report", "-dir", str(d)]) == 0
    assert "# spans" in capsys.readouterr().out
    assert cli.main(["calibration", "-dir", str(d)]) == 0
    assert "# calibration:" in capsys.readouterr().out
    assert cli.main(["report", "-dir", str(tmp_path / "none")]) == 2
    assert cli.main(["calibration", "-dir", str(tmp_path / "none")]) == 2


def test_obs_selftest_passes():
    assert cli.main(["selftest"]) == 0


def test_calibration_selftest_pairs_five_models(capsys):
    assert cli.main(["calibration", "--selftest", "-device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("calibration selftest ok")
    n = int(line.split("(")[1].split()[0])
    assert n >= report.CALIB_MIN_MODELS == jreport.CALIB_MIN_MODELS == 5
    for name in ("step_time", "wire_bytes", "overlap_frac", "stream_xfer_s",
                 "delta-apply", "serve-p50"):
        assert name in line
    for name, band in report.CALIB_BOUNDS.items():
        assert jreport.CALIB_BOUNDS[name] == band


def test_engine_serve_p50_pair_and_watchdog_feed():
    from roc_tpu_torch.serve import ServeEngine
    ds = datasets.get("roc-audit", seed=1)
    cfg = Config(dataset="roc-audit", layers=[8, 16, 4],
                 aggregate_backend="binned", serve_batch=4,
                 serve_wait_ms=0.5)
    recs = []
    led = ledger.get_ledger()
    led.attach(lambda kind, **f: recs.append({"type": kind, **f}))
    wd = PerfWatchdog()
    try:
        with ServeEngine(cfg, ds, build_gcn(cfg.layers, 0.0), watchdog=wd,
                         device="cpu") as eng:
            for i in range(20):
                eng.query([i % ds.graph.num_nodes], timeout=60.0)
    finally:
        led.detach()
    rep = ledger.calibration_report(recs)
    assert rep["models"]["serve-p50"]["pairs"] >= 1
    assert wd.serve_observed >= 1
