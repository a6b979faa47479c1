"""The port's run controls (roc_tpu_torch/train/driver.py, fault/,
obs/watchdog.py) against roc_tpu's: the counterparts of
tests/test_fault.py:186-246 and :352, the -fault arming, SIGTERM through
the CLI, and the resumed run's PRNG key.

Tolerances:
  a step.nan step                     bitwise no-op (params, Adam m and v)
  resumed run under another -seed     final loss within 1e-5 relative of
                                      roc_tpu's resumed run, from either
                                      package's checkpoint
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_gcn as jbuild_gcn
from roc_tpu.obs.watchdog import PerfWatchdog as JPerfWatchdog
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu_torch.fault import inject
from roc_tpu_torch.fault.guard import nan_scale
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_gcn
from roc_tpu_torch.obs import PerfWatchdog
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import NONFINITE_ESCALATE_AFTER, Trainer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with the harness disarmed (a Trainer arms
    its Config's spec for the process)."""
    inject.configure("")
    yield
    inject.configure("")


def _noop(*a, **k):
    pass


def _small_trainer(num_epochs, fault_spec="", dropout=0.0, **cfg_kw):
    """The fixture of tests/test_fault.py:52: GCN 8-4-3 on an 80-node
    synthetic graph."""
    ds = datasets.synthetic("t", 80, 3.0, 8, 3, n_train=20, n_val=20,
                            n_test=20, seed=13)
    cfg_kw.setdefault("eval_every", 10 ** 9)
    cfg = Config(layers=[8, 4, 3], num_epochs=num_epochs,
                 dropout_rate=dropout, fault=fault_spec, device="cpu",
                 **cfg_kw)
    return Trainer(cfg, ds, build_gcn(cfg.layers, dropout)), cfg


# -- step.nan and the guard ---------------------------------------------------

def test_nan_scale_is_one_unless_the_site_fires():
    assert nan_scale() == 1.0 and isinstance(nan_scale(), float)
    inject.configure("step.nan=1")
    assert np.isnan(nan_scale())
    assert nan_scale() == 1.0
    assert inject.counters()["step.nan"] == {"calls": 2, "fired": 1}


def test_nan_step_skip_is_bitwise_noop():
    """dropout 0, no decay: a 4-epoch run whose first step was NaN-skipped
    equals a 3-epoch clean run bitwise, params and Adam moments."""
    tr_a, _ = _small_trainer(4, fault_spec="seed=3,step.nan=1")
    assert inject.spec() == "seed=3,step.nan=1"
    tr_a.train(print_fn=_noop)
    assert tr_a.nonfinite_skips == 1, "injected NaN step was not skipped"
    inject.configure("")
    tr_b, _ = _small_trainer(3)
    tr_b.train(print_fn=_noop)
    for k in tr_b.params:
        assert torch.equal(tr_a.params[k], tr_b.params[k])
        assert torch.equal(tr_a.opt_state.m[k], tr_b.opt_state.m[k])
        assert torch.equal(tr_a.opt_state.v[k], tr_b.opt_state.v[k])
    assert int(tr_a.opt_state.t) == int(tr_b.opt_state.t) == 3


def test_unarmed_scale_keeps_the_bits():
    """The step multiplies its loss by nan_scale(): 1.0 when unarmed, and
    the run is the same as one that skipped the multiply."""
    tr_a, _ = _small_trainer(3, dropout=0.5)
    la = [float(tr_a.run_epoch()) for _ in range(3)]
    tr_b, _ = _small_trainer(3, dropout=0.5)
    step = tr_b._train_step
    tr_b._train_step = lambda key, alpha, scale: step(key, alpha, 1)
    lb = [float(tr_b.run_epoch()) for _ in range(3)]
    assert la == lb
    for k in tr_a.params:
        assert torch.equal(tr_a.params[k], tr_b.params[k])


def test_fault_flag_arms_the_harness():
    _small_trainer(1, fault_spec="seed=7,lux.read=2")
    assert inject.armed() and inject.spec() == "seed=7,lux.read=2"
    # an empty spec leaves the armed one alone, as roc_tpu's trainer does
    _small_trainer(1)
    assert inject.spec() == "seed=7,lux.read=2"


# -- the escalation ladder ----------------------------------------------------

def test_nonfinite_escalation_ladder(tmp_path):
    """3 consecutive skips: rung 1 disables -megafuse and rebuilds the graph
    context with the params kept; 3 more: rung 2 restores the last
    checkpoint."""
    tr, cfg = _small_trainer(4, checkpoint_path=str(tmp_path / "ck.npz"),
                             aggregate_backend="binned")
    tr.save_checkpoint(cfg.checkpoint_path)
    saved_epoch = tr.epoch
    cfg.megafuse = True
    before = {k: v.clone() for k, v in tr.params.items()}
    events = []
    inject.attach(lambda kind, **f: events.append((kind, f["stage"])))
    try:
        tr._last_nonfinite = torch.tensor(True)
        for _ in range(NONFINITE_ESCALATE_AFTER):
            tr._check_nonfinite(1, _noop)
        assert tr._nf_stage == 1 and cfg.megafuse is False
        assert tr.gctx.fuse_linear is None
        for k in before:
            assert torch.equal(before[k], tr.params[k])
        tr.epoch = 99
        tr._last_nonfinite = torch.tensor(True)
        for _ in range(NONFINITE_ESCALATE_AFTER):
            tr._check_nonfinite(2, _noop)
    finally:
        inject.detach()
    assert tr._nf_stage == 2
    assert tr.epoch == saved_epoch, "rung 2 did not restore the checkpoint"
    assert events == [("nonfinite_escalation", "unfuse"),
                      ("nonfinite_escalation", "restore")]


def test_nonfinite_escalation_without_checkpoint():
    tr, _ = _small_trainer(4)
    tr._last_nonfinite = torch.tensor(True)
    for _ in range(6):
        tr._check_nonfinite(0, _noop)
    assert tr._nf_stage == 2 and tr.nonfinite_skips == 6
    tr._last_nonfinite = torch.tensor(False)
    tr._check_nonfinite(1, _noop)
    assert tr._nf_streak == 0


# -- the watchdog's state -----------------------------------------------------

def test_watchdog_nonfinite_and_state_roundtrip():
    wd = PerfWatchdog()
    wd.observe_nonfinite(3, 1)
    alert = wd.observe_nonfinite(4, 2)
    assert wd.nonfinite_steps == 2
    assert alert["total"] == 2 and alert["consecutive"] == 2
    state = wd.state_dict()
    json.dumps(state)  # must fit the checkpoint's JSON extra record
    wd2 = PerfWatchdog()
    wd2.load_state(state)
    assert wd2.nonfinite_steps == 2
    # either package's state loads into the other's watchdog
    jwd = JPerfWatchdog()
    for t in (0.1, 0.1, 0.12):
        jwd.observe_epoch(0, t)
    wd3 = PerfWatchdog()
    wd3.load_state(jwd.state_dict())
    assert (wd3.ewma, wd3.observed) == (jwd.ewma, jwd.observed)
    jwd2 = JPerfWatchdog()
    jwd2.load_state(state)
    assert jwd2.nonfinite_steps == 2


# -- graceful shutdown --------------------------------------------------------

def test_sigterm_finishes_epoch_then_checkpoints(tmp_path):
    """SIGTERM mid-train: the epoch in flight completes, the loop exits
    cleanly, the end-of-train checkpoint lands with the PRNG key, and the
    previous handler is back."""
    ckpt = str(tmp_path / "ck.npz")
    tr, cfg = _small_trainer(8, checkpoint_path=ckpt, eval_every=1)
    lines = []

    def print_hook(msg):
        lines.append(str(msg))
        if len(lines) == 1:           # the first eval line: an operator kill
            signal.raise_signal(signal.SIGTERM)

    orig = signal.getsignal(signal.SIGTERM)
    tr.train(print_fn=print_hook)
    assert signal.getsignal(signal.SIGTERM) is orig
    assert tr.epoch == 1, "SIGTERM did not stop the run after its epoch"
    assert any("SIGTERM" in ln and "exiting cleanly" in ln for ln in lines)
    _, _, epoch, _, extra = checkpoint.load(ckpt, tr.params, tr.opt_state)
    assert epoch == tr.epoch
    assert extra["rng_key"] == [0, 1]


def test_sigterm_to_the_cli_exits_zero(tmp_path):
    """SIGTERM sent to ``python -m roc_tpu_torch`` after its first metric
    line: exit 0 and a checkpoint holding the key."""
    ckpt = tmp_path / "ck.npz"
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "ROC_FAULT", "ROC_OBS")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "roc_tpu_torch", "-dataset", "roc-audit",
         "-layers", "8-16-4", "-e", "100000", "-eval-every", "1", "-ckpt",
         str(ckpt), "-seed", "5", "-device", "cpu"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        assert "[INFER][0]" in first, proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    assert "SIGTERM received" in out
    meta, _ = checkpoint._read_verified(str(ckpt))
    assert meta["extra"]["rng_key"] == [0, 5] and meta["epoch"] >= 1


# -- the resumed run's key (ROADMAP queue C item 1) ---------------------------

_RESUME = dict(dataset="roc-audit", layers=[8, 16, 4], learning_rate=0.01,
               weight_decay=5e-4, dropout_rate=0.5, eval_every=1000,
               aggregate_backend="xla", aggregate_precision="exact")


def _jax(seed, epochs, path=None):
    cfg = JConfig(seed=seed, num_epochs=epochs, checkpoint_path=path,
                  **_RESUME)
    return JTrainer(cfg, jdatasets.get("roc-audit"),
                    jbuild_gcn(cfg.layers, cfg.dropout_rate))


def _port(seed, epochs, path=None):
    cfg = Config(seed=seed, num_epochs=epochs, checkpoint_path=path,
                 device="cpu", **_RESUME)
    return Trainer(cfg, datasets.get("roc-audit"),
                   build_gcn(cfg.layers, cfg.dropout_rate))


@pytest.mark.parametrize("writer", ["roc_tpu", "port"])
def test_resume_under_another_seed_tracks_roc_tpu(tmp_path, writer):
    """Two epochs under -seed 1 and a checkpoint; then a run started with
    -seed 2 resumes it for two more.  The checkpoint's key decides the
    masks, so the port's resumed run tracks roc_tpu's resumed run."""
    path = str(tmp_path / "ck.npz")
    first = (_jax if writer == "roc_tpu" else _port)(1, 2, path)
    first.train(print_fn=_noop)
    ref = _jax(2, 2)
    ref.restore(path)
    want = ref.train(print_fn=_noop).final_loss
    ours = _port(2, 2)
    assert ours.key == (0, 2)
    ours.restore(path)
    assert ours.key == (0, 1) and ours.epoch == 2
    got = ours.train(print_fn=_noop).final_loss
    # a run resumed with its own seed's masks would be far off
    other = _port(2, 2)
    other.restore(path)
    other.key = (0, 2)
    stray = other.train(print_fn=_noop).final_loss
    gap = abs(got - want) / abs(want)
    off = abs(stray - want) / abs(want)
    print(f"resumed from roc_tpu-written={writer == 'roc_tpu'}: {gap:.2e} "
          f"relative; with -seed 2's masks {off:.2e}")
    assert gap <= 1e-5
    assert abs(stray - want) > 1e-3 * abs(want)
