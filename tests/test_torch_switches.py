"""The JAX package's kill switches and the config's env mirrors in the port
(roc_tpu_torch/ops/switches.py, train/config.py) against roc_tpu's: each
helper's return value and its one warning a process; a 3-epoch CPU run
under each switch against roc_tpu's run under the same variable, at the
tolerances of the existing megafuse (1e-3), region (1e-5) and GAT (1e-3)
trainer tests, with spies showing the port took the switched path; and
``-analyze`` refused with its reason."""

import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild_model
from roc_tpu.ops import edge as jedge  # noqa: F401  (binds pallas.gat)
from roc_tpu.ops.pallas import binned as B
from roc_tpu.ops.pallas import gat as PG
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_model
from roc_tpu_torch.ops import aggregate as agg_mod
from roc_tpu_torch.ops import edge as edge_mod
from roc_tpu_torch.ops import switches
from roc_tpu_torch.ops.kernels import xlayer as KX
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer

ROOT = Path(__file__).resolve().parents[1]
VARS = ("ROC_NO_MEGAFUSE", "ROC_MEGA_BWD", "ROC_XLAYER", "ROC_NO_GATFUSE",
        "ROC_GAT_BWD", "ROC_MEGAFUSE", "ROC_FUSION_DEPTH", "ROC_AUTOTUNE")

# variable, value that switches, port helper, roc_tpu module and helper,
# the warned-flag name in both
SWITCHES = [
    ("ROC_NO_MEGAFUSE", "1", "megafuse_killed", B, "_MEGA_KILL_WARNED"),
    ("ROC_MEGA_BWD", "0", "mega_bwd_killed", B, "_MEGA_BWD_KILL_WARNED"),
    ("ROC_XLAYER", "0", "xlayer_killed", B, "_XLAYER_KILL_WARNED"),
    ("ROC_NO_GATFUSE", "1", "gat_fuse_killed", PG, "_GAT_KILL_WARNED"),
    ("ROC_GAT_BWD", "0", "gat_bwd_killed", PG, "_GAT_BWD_KILL_WARNED"),
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in VARS:
        monkeypatch.delenv(var, raising=False)
    # run_binned's eager warning needs jax.core.trace_state_clean, which jax
    # 0.9.0 no longer exports (ROADMAP queue C); mark it given
    monkeypatch.setattr(B, "_EAGER_WARNED", [True])
    for _, _, name, mod, flag in SWITCHES:
        monkeypatch.setattr(mod, flag, [False])
        monkeypatch.setattr(switches, flag, [False])


def _calls(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w if x.category is UserWarning]


@pytest.mark.parametrize("case", SWITCHES, ids=[c[0] for c in SWITCHES])
def test_switch_helper_matches_roc_tpu(monkeypatch, case):
    var, on, name, mod, _ = case
    ours, ref = getattr(switches, name), getattr(mod, name)
    assert _calls(ours) == _calls(ref) == (False, [])
    off = "0" if on == "1" else "1"
    monkeypatch.setenv(var, off if var in ("ROC_MEGA_BWD", "ROC_XLAYER",
                                           "ROC_GAT_BWD") else "")
    assert _calls(ours) == _calls(ref) == (False, [])
    monkeypatch.setenv(var, on)
    first, again = _calls(ours), _calls(ours)
    jfirst, jagain = _calls(ref), _calls(ref)
    assert first == jfirst and first[0] is True and len(first[1]) == 1
    assert again == jagain == (True, [])


# (variable, value, Config field, the value it sets)
MIRRORS = [("ROC_MEGAFUSE", "1", "megafuse", True),
           ("ROC_MEGAFUSE", "0", "megafuse", False),
           ("ROC_FUSION_DEPTH", "0", "fusion_depth", 0),
           ("ROC_FUSION_DEPTH", "2", "fusion_depth", 2),
           ("ROC_AUTOTUNE", "1", "autotune", True),
           ("ROC_AUTOTUNE", "0", "autotune", False)]


@pytest.mark.parametrize("var,value,field,want", MIRRORS,
                         ids=[f"{m[0]}={m[1]}" for m in MIRRORS])
def test_env_mirror_matches_roc_tpu(monkeypatch, var, value, field, want):
    monkeypatch.setenv(var, value)
    kw = {"megafuse": True, "autotune": True} if want is False else {}
    assert getattr(Config(**kw), field) == getattr(JConfig(**kw), field) \
        == want


def test_fusion_depth_env_refused_after_the_mirror(monkeypatch):
    """ROC_FUSION_DEPTH=-1 is mirrored, then refused, in both; a valid
    variable rescues a bad argument in both (the refusal comes after)."""
    monkeypatch.setenv("ROC_FUSION_DEPTH", "-1")
    for make in (Config, JConfig):
        with pytest.raises(SystemExit, match="bad fusion_depth"):
            make()
    monkeypatch.setenv("ROC_FUSION_DEPTH", "2")
    assert Config(fusion_depth=-1).fusion_depth == \
        JConfig(fusion_depth=-1).fusion_depth == 2


def test_analyze_is_refused_with_its_reason():
    proc = subprocess.run(
        [sys.executable, "-m", "roc_tpu_torch", "-dataset", "roc-audit",
         "-layers", "8-16-4", "-device", "cpu", "-analyze"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    assert "-analyze audits the lowered XLA steps" in proc.stderr
    assert "no lowered step" in proc.stderr


# -- a short run under each switch against roc_tpu's under it ---------------

BASE = dict(num_epochs=3, learning_rate=0.01, weight_decay=5e-4,
            dropout_rate=0.0, eval_every=1000, seed=1,
            aggregate_precision="exact")
GCN, CHAIN, GAT = [64, 16, 8], [64, 16, 16, 8], [64, 8, 8]
# switch -> (model, layers, roc_tpu settings, port settings, tolerance,
# the port's spied calls over 3 steps, the eval at epoch 0 and
# predict_logits)
RUNS = {
    "ROC_NO_MEGAFUSE=1": ("gcn", GCN, dict(aggregate_backend="binned",
                                           megafuse=True),
                          dict(aggregate_backend="binned", megafuse=True),
                          1e-3, {"sum": 4 * 3 + 2 * 2, "mega": 0,
                                 "mega_bwd": 0}),
    "ROC_MEGA_BWD=0": ("gcn", GCN, dict(aggregate_backend="binned",
                                        megafuse=True),
                       dict(aggregate_backend="binned", megafuse=True),
                       1e-3, {"sum": 2 * 3, "mega": 2 * (3 + 2),
                              "mega_bwd": 0}),
    "ROC_XLAYER=0": ("gcn-chain", CHAIN, dict(aggregate_backend="binned",
                                              megafuse=True,
                                              fusion_depth=0),
                     dict(aggregate_backend="binned", megafuse=True,
                          fusion_depth=0),
                     1e-5, {"xfwd": 0, "xbwd": 0, "mega": 3 * (3 + 2),
                            "mega_bwd": 3 * 3}),
    "ROC_NO_GATFUSE=1": ("gat", GAT, dict(aggregate_backend="matmul",
                                          megafuse=True),
                         dict(aggregate_backend="binned"), 1e-3,
                         {"gat_forward": 0, "gat_bwd_src": 0, "plain": 2 *
                          (3 + 2)}),
    "ROC_GAT_BWD=0": ("gat", GAT, dict(aggregate_backend="matmul",
                                       megafuse=True),
                      dict(aggregate_backend="binned"), 1e-3,
                      {"gat_forward": 2 * (3 + 2), "gat_bwd_src": 0,
                       "plain": 0}),
}


def _spy(monkeypatch, mod, name, calls, key):
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, _o=orig, **k: (
        calls.__setitem__(key, calls[key] + 1), _o(*a, **k))[1])


def _port_spies(monkeypatch) -> dict:
    calls = {k: 0 for k in ("sum", "mega", "mega_bwd", "xfwd", "xbwd",
                            "gat_forward", "gat_bwd_src", "plain")}
    _spy(monkeypatch, agg_mod, "aggregate_sum", calls, "sum")
    _spy(monkeypatch, agg_mod, "aggregate_linear", calls, "mega")
    _spy(monkeypatch, agg_mod, "aggregate_linear_bwd", calls, "mega_bwd")
    _spy(monkeypatch, KX, "xlayer_fwd_plain", calls, "xfwd")
    _spy(monkeypatch, KX, "xlayer_bwd_plain", calls, "xbwd")
    _spy(monkeypatch, edge_mod, "gat_forward", calls, "gat_forward")
    _spy(monkeypatch, edge_mod, "gat_bwd_src", calls, "gat_bwd_src")
    _spy(monkeypatch, edge_mod, "gat_attend", calls, "plain")
    return calls


def _quiet(*a, **k):
    pass


@pytest.mark.parametrize("switch", list(RUNS))
def test_run_under_switch_tracks_roc_tpu(monkeypatch, switch):
    model, layers, jkw, kw, tol, want = RUNS[switch]
    var, value = switch.split("=")
    monkeypatch.setenv("ROC_BINNED_GEOM", "flat")
    monkeypatch.setenv(var, value)
    ds = "mega-shard"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JConfig(dataset=ds, layers=layers, model=model, heads=2,
                       **BASE, **jkw)
        jtr = JTrainer(jcfg, jdatasets.get(ds, seed=1),
                       jbuild_model(model, layers, 0.0, heads=2))
        cfg = Config(dataset=ds, layers=layers, model=model, heads=2,
                     device="cpu", **BASE, **kw)
        tr = Trainer(cfg, datasets.get(ds, seed=1),
                     build_model(model, layers, 0.0, heads=2))
        tr.params = checkpoint.params_from_jax(
            {k: np.asarray(v) for k, v in jtr.params.items()}, "cpu")
        tr.opt_state = checkpoint.opt_state_from_jax(
            jax.device_get(jtr.opt_state), "cpu")
        calls = _port_spies(monkeypatch)
        jstats = jtr.train(print_fn=_quiet)
        stats = tr.train(print_fn=_quiet)
        wantl = np.asarray(jtr.predict_logits())
        got = tr.predict_logits().numpy()
    gap = abs(stats.final_loss - jstats.final_loss) / abs(jstats.final_loss)
    rows = np.abs(got - wantl).max(axis=1) / np.maximum(
        np.abs(wantl).max(axis=1), 1e-30)
    print(f"{switch}: port vs roc_tpu after 3 epochs: final loss {gap:.2e} "
          f"relative, logits {rows.max():.2e} of the row max-abs")
    assert np.isfinite(got).all() and gap <= tol and rows.max() <= tol
    assert {k: calls[k] for k in want} == want
