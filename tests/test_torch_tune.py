"""The port's launch autotuner (roc_tpu_torch/tune/) against roc_tpu's
(roc_tpu/tune/) on the same inputs, on the CPU.

  noise_eps, surrogate_seconds, synth_shape    bitwise roc_tpu's
  graph_key, content_key, variant_key          string-equal
  tuned_store_path                             roc_tpu's directory under
                                               every ROC_NO_TUNED /
                                               ROC_TUNED_PATH /
                                               ROC_PLAN_CACHE / _DIR
                                               combination
  halve() driven by roc_tpu's lattice and      roc_tpu's sweep winners,
  pricing                                      their confirmed and
                                               modeled seconds
  the port's surrogate sweep                   byte-identical stores
  the stores of the two packages               each refused by the other,
                                               never clobbered
  refit                                        within 5 % of the
                                               generating rates, from
                                               records and ledger dicts
  -autotune, 3 CPU epochs                      losses bitwise the untuned
                                               run's, within 1e-5 of
                                               roc_tpu's

The surrogate sweep runs no kernel.  The card's half (every candidate
bitwise the default launch, the timed sweep) is chip_smoke.py's tune
phase.
"""

import itertools
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild_model
from roc_tpu.obs import ledger as jledger
from roc_tpu.ops.pallas import binned as B
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu.tune import lattice as JL
from roc_tpu.tune import search as JS
from roc_tpu.tune import store as JStore
from roc_tpu.tune import surrogate as JSur
from roc_tpu_torch.balance.cost_model import (MEASURED_PRIOR_WEIGHT,
                                              PRIOR_WEIGHT, OnlineCostModel)
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.memory.estimator import (AGG_S_PER_EDGE_COLUMN,
                                            agg_s_per_edge_column)
from roc_tpu_torch.models import build_model
from roc_tpu_torch.obs import ledger
from roc_tpu_torch.ops import DeviceCsr
from roc_tpu_torch.ops.aggregate import LaunchTable
from roc_tpu_torch.ops.kernels import aggregate_sum as KS
from roc_tpu_torch.ops.kernels import gat as G
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer
from roc_tpu_torch.train.graph_data import dense_graph_data
from roc_tpu_torch.tune import lattice as L
from roc_tpu_torch.tune import refit as R
from roc_tpu_torch.tune import search as S
from roc_tpu_torch.tune import store
from roc_tpu_torch.tune import surrogate as Sur

ROOT = Path(__file__).resolve().parents[1]
STORE_VARS = ("ROC_NO_TUNED", "ROC_TUNED_PATH", "ROC_PLAN_CACHE",
              "ROC_PLAN_CACHE_DIR", "ROC_AUTOTUNE")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in STORE_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(B, "_EAGER_WARNED", [True])
    store.clear_cache()
    JStore.clear_cache()
    R._CACHE.clear()
    yield
    store.clear_cache()
    JStore.clear_cache()
    R._CACHE.clear()


# -- the pieces copied from roc_tpu -------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 123456789])
@pytest.mark.parametrize("salt", ["trial", "confirm0", "probe95", "matmul"])
def test_noise_and_surrogate_bitwise_roc_tpu(seed, salt):
    for label in ("sum/256/fast|l16.e4", "gat/1x41/fast|g8.p2", "",
                  "1024/2048/16/1024/2048/0/0/1|dma16.4.1+arbitrary"):
        assert Sur.noise_eps(seed, salt, label) == \
            JSur.noise_eps(seed, salt, label)
        for modeled in (1e-6, 3.3e-3, 1.0):
            assert Sur.surrogate_seconds(modeled, seed, salt, label) == \
                JSur.surrogate_seconds(modeled, seed, salt, label)
    assert Sur.NOISE == JSur.NOISE


@pytest.mark.parametrize("spec", [("a", 1024, 8192, 2), ("b", 5, 0, 0),
                                  ("c", 300, 4097, 11)])
def test_synth_shape_bitwise_roc_tpu(spec):
    a, b = S.synth_shape(*spec), JS.synth_shape(*spec)
    assert (a.name, a.num_rows, a.table_rows) == \
        (b.name, b.num_rows, b.table_rows)
    for x, y in ((a.edge_src, b.edge_src), (a.edge_dst, b.edge_dst)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_keys_string_equal_roc_tpu():
    shape = S.synth_shape(*S.SHAPES_CI[0])
    for es, ed, n, t in ((shape.edge_src, shape.edge_dst, 1024, 1024),
                         (shape.edge_dst, shape.edge_src, 1024, 1024),
                         (shape.edge_src.astype(np.int32),
                          shape.edge_dst.astype(np.int32), 1024, 2048),
                         (np.zeros(0, np.int64), np.zeros(0, np.int64), 3,
                          3)):
        assert store.graph_key(es, ed, n, t) == JStore.graph_key(es, ed, n, t)
    kv = dict(shape="fwd", rows=5, edges=9, variant="bf16", cand="x|y",
              stage="probe")
    assert ledger.content_key(**kv) == jledger.content_key(**kv)
    for storage, fuse in itertools.product(("fp32", "bf16"), (False, True)):
        assert store.variant_key(storage, fuse) == \
            JStore.variant_key(storage, fuse)
    assert [store.storage_of(p) for p in ("fast", "exact")] == \
        ["bf16", "fp32"]


@pytest.mark.parametrize("combo", list(itertools.product(
    (None, "1"), (None, "shared.json"), (None, "0"), (None, "pc"))),
    ids=lambda c: "-".join(str(v) for v in c))
def test_tuned_store_path_directory_matches_roc_tpu(monkeypatch, tmp_path,
                                                    combo):
    no_tuned, path, cache, cache_dir = combo
    for var, v in (("ROC_NO_TUNED", no_tuned),
                   ("ROC_TUNED_PATH", path and str(tmp_path / path)),
                   ("ROC_PLAN_CACHE", cache),
                   ("ROC_PLAN_CACHE_DIR", cache_dir and str(tmp_path
                                                            / cache_dir))):
        if v is not None:
            monkeypatch.setenv(var, v)
    ours, ref = store.tuned_store_path(), JStore.tuned_store_path()
    assert store.plan_cache_dir() == B._plan_cache_dir()
    if not ref or path:
        assert ours == ref
    else:
        assert os.path.dirname(ours) == os.path.dirname(ref)
        assert (os.path.basename(ours), os.path.basename(ref)) == \
            (store.FILE_NAME, "tuned.json")
    assert (ours == "") == bool(no_tuned or (cache == "0" and not path))


# -- the search ---------------------------------------------------------------

@pytest.mark.parametrize("storage", ["fp32", "bf16"])
def test_halving_on_roc_tpu_lattice_gives_roc_tpu_winners(storage):
    """The port's halve(), driven by roc_tpu's own candidate_lattice and
    modeled_seconds on SHAPES_CI[0] and the port's surrogate draws, picks
    the winner roc_tpu's sweep(seed=0) writes, at the same seconds."""
    entries, _ = JS.sweep(JS.SHAPES_CI, storage_dtype=storage, seed=0)
    jledger.get_ledger().clear()
    shape = JS.synth_shape(*JS.SHAPES_CI[0])
    stats: dict = {}

    def price(cfg):
        key = (cfg.geom.sb, cfg.geom.rb)
        if key not in stats:
            stats[key] = B._cell_stats(shape.edge_src, shape.edge_dst, *key)
        return JSur.modeled_seconds(cfg, stats[key], shape.num_rows,
                                    shape.table_rows,
                                    len(shape.edge_src))[0]

    res = S.halve(JL.candidate_lattice(storage, False), price,
                  S.surrogate_measure(0))
    want = entries[JStore.graph_key(shape.edge_src, shape.edge_dst,
                                    shape.num_rows, shape.table_rows)][
        JStore.variant_key(storage, False)]
    assert [int(v) for v in res.winner.geom] == want["geom"]
    assert res.winner.knobs() == want["knobs"]
    assert res.confirm_s == want["trial_s"]
    assert res.modeled_s == want["modeled_s"]


def _sweep_to(path, **kw):
    entries, trials = S.sweep(S.SHAPES_CI, seed=0, **kw)
    return store.merge_entries(str(path), entries, interpret=True, seed=0), \
        trials


@pytest.mark.parametrize("storage", ["bf16", "fp32"])
def test_surrogate_sweep_byte_identical_and_valid(tmp_path, storage):
    docs = [_sweep_to(tmp_path / f"t{i}.json", storage_dtype=storage)[0]
            for i in range(2)]
    blobs = [(tmp_path / f"t{i}.json").read_bytes() for i in range(2)]
    assert blobs[0] == blobs[1]
    assert not store.validate_store(docs[0])
    (variants,) = docs[0]["entries"].values()
    kernels = variants[storage]
    assert set(kernels) == {"sum/256", "sum/41", "gat/4x64", "gat/1x41"}
    prec = store.precision_of(storage)
    for key, e in kernels.items():
        kind, dims = key.split("/")
        shape = tuple(int(v) for v in dims.split("x"))
        cfg = L.LaunchConfig(kind, shape, prec, tuple(e["launch"]))
        assert cfg in L.candidate_lattice(kind, shape, prec)
        assert e["label"] == cfg.label and e["source"] == "surrogate"
        # a candidate replaces the default rule only by beating it
        base = L.default_config(kind, shape, prec)
        assert e["trial_s"] < e["default_s"] or (
            cfg == base and e["trial_s"] == e["default_s"])


def test_lattice_mirrors_the_built_launches():
    """Sorted by label, the default rule always in, every candidate built
    and within the default's passes; the sums at the main path's widths."""
    assert [c.launch for c in L.candidate_lattice("sum", (256,), "fast")] \
        == [(16, 1), (16, 2), (16, 4), (32, 1), (32, 2), (32, 4)]
    assert [c.launch for c in L.candidate_lattice("sum", (41,), "exact")] \
        == [(32, 2)]
    assert [c.launch for c in L.candidate_lattice("gat", (4, 64), "fast")] \
        == [(16, 4), (32, 2)]
    for kernel, shapes in (("sum", [(h,) for h in (1, 7, 41, 256, 602,
                                                   1000)]),
                           ("gat", [(4, 64), (1, 41), (3, 5), (8, 8),
                                    (2, 200)])):
        for shape in shapes:
            for prec in ("fast", "exact"):
                cands = L.candidate_lattice(kernel, shape, prec)
                base = L.default_config(kernel, shape, prec)
                assert base in cands
                assert [c.label for c in cands] == sorted(c.label
                                                          for c in cands)
                for c in cands:
                    assert c.built() and c.geometry()["passes"] <= \
                        base.geometry()["passes"]
    # the C++ rule: at 2- and 1-float packs only the default edges and one
    # pack a lane below 32 lanes are built
    assert not L.sum_built(2, 4, 16, 2, 2) and L.sum_built(2, 4, 32, 3, 2)
    assert not L.sum_built(1, 4, 32, 1, 4) and L.sum_built(4, 4, 8, 4, 4)
    assert not L.LaunchConfig("sum", (256,), "fast", (0, 0)).built()
    assert not L.LaunchConfig("gat", (4, 6), "fast", (16, 4)).built()


def test_forward_geometry_takes_a_built_group_only():
    assert G.forward_geometry(4, 64, 256, 0, ((16, 4),)) == \
        (4, 16, 4, False, 256)
    assert G.forward_geometry(1, 41, 41, 0, ((8, 2),)) == (4, 8, 2, True, 44)
    assert G.forward_geometry(4, 64, 256, 0, None) == \
        G.forward_geometry(4, 64, 256, 0)
    with pytest.raises(ValueError, match="not built"):
        G.forward_geometry(4, 6, 24, 0, ((16, 4),))


# -- the stores ---------------------------------------------------------------

def _valid_doc():
    return {"version": 1, "package": "roc_tpu_torch", "interpret": True,
            "seed": 0, "entries": {"edges=1|rows=1|sha=0|table_rows=1": {
                "bf16": {"sum/256": {"launch": [16, 4], "label": "x",
                                     "modeled_s": 1.0, "trial_s": 1.0,
                                     "default_s": 1.0,
                                     "source": "surrogate"}}}}}


def _broken(path, value):
    doc = _valid_doc()
    node = doc
    for k in path[:-1]:
        node = node[k] if k != "*" else next(iter(node.values()))
    if value is KeyError:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return doc


MALFORMED = {
    "not_object": ([], "no"),
    "version": (["version"], 2),
    "package": (["package"], "roc_tpu"),
    "interpret": (["interpret"], "yes"),
    "entries": (["entries"], []),
    "variant": (["entries", "*", "int8"], {}),
    "kernel_key": (["entries", "*", "bf16", "mm/256"],
                   {"launch": [16, 4]}),
    "launch_len": (["entries", "*", "bf16", "*", "launch"], [16]),
    "launch_unbuilt": (["entries", "*", "bf16", "*", "launch"], [12, 4]),
    "launch_bool": (["entries", "*", "bf16", "*", "launch"], [True, 4]),
    "modeled": (["entries", "*", "bf16", "*", "modeled_s"], "1"),
    "default": (["entries", "*", "bf16", "*", "default_s"], KeyError),
    "source": (["entries", "*", "bf16", "*", "source"], "tpu"),
    "label": (["entries", "*", "bf16", "*", "label"], KeyError),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_validate_store_flags_malformed(case):
    assert store.validate_store(_valid_doc()) == []
    path, value = MALFORMED[case]
    doc = value if not path else _broken(path, value)
    assert store.validate_store(doc)


def test_the_packages_refuse_each_others_stores(tmp_path, monkeypatch):
    """roc_tpu's tuned.json at the port's path is neither read, merged over
    nor overwritten; the port's is refused by roc_tpu's load_store."""
    shared = tmp_path / "shared.json"
    jentries, _ = JS.sweep(JS.SHAPES_CI, storage_dtype="bf16", seed=0)
    jledger.get_ledger().clear()
    JStore.merge_entries(str(shared), jentries, interpret=True, seed=0)
    before = shared.read_bytes()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert store.load_store(str(shared)) is None
    assert any("roc_tpu" in str(x.message) for x in w)
    entries, _ = S.sweep(S.SHAPES_CI, seed=0)
    for write in (lambda: store.merge_entries(str(shared), entries, True, 0),
                  lambda: store.save_store(str(shared), _valid_doc())):
        with pytest.raises(ValueError, match="roc_tpu's tuned Geometry"):
            write()
    assert shared.read_bytes() == before
    ours = tmp_path / "ours.json"
    store.merge_entries(str(ours), entries, True, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert JStore.load_store(str(ours)) is None
    assert store.load_store(str(ours)) is not None


def test_lookup_takes_the_exact_variant_only(tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    _sweep_to(path, storage_dtype="bf16")
    shape = S.synth_shape(*S.SHAPES_CI[0])
    args = (shape.edge_src, shape.edge_dst, shape.num_rows, shape.table_rows)
    assert store.lookup(*args, "bf16", path=str(path))
    for storage, fuse in (("fp32", False), ("bf16", True), ("fp32", True)):
        assert store.lookup(*args, storage, fuse, path=str(path)) is None
    monkeypatch.setenv("ROC_TUNED_PATH", str(path))
    assert store.launch_table(*args, "bf16") is not None
    monkeypatch.setenv("ROC_NO_TUNED", "1")
    store.clear_cache()
    assert store.tuned_store_path() == ""
    assert store.launch_table(*args, "bf16") is None


def test_device_csr_takes_the_tuned_entry(tmp_path, monkeypatch):
    """autotune_graph over both directions of a real graph, then the
    placement of that graph carries the winners (forward and transpose);
    an off-key graph, an xla placement or ROC_NO_TUNED keep the rule."""
    monkeypatch.setenv("ROC_TUNED_PATH", str(tmp_path / "t.json"))
    g = datasets.get("mega-shard", seed=1).graph
    table = S.autotune_graph(g.col_idx, g.dst_idx, g.num_nodes, g.num_nodes,
                             sum_widths=(16, 8), gat_shapes=((2, 8),))
    assert set(table.fwd) == {"sum/16", "sum/8", "gat/2x8"}
    assert set(table.bwd) == {"sum/16", "sum/8"} and table.precision == "fast"
    gd = dense_graph_data(g, "kernel", "fast", torch.device("cpu"))
    assert gd.csr.launch == table
    assert gd.csr.sum_launch(False, 16, "fast") == table.fwd["sum/16"]
    assert gd.csr.sum_launch(True, 8, "fast") == table.bwd["sum/8"]
    assert gd.csr.gat_groups(2, 8, "fast") == (table.fwd["gat/2x8"],)
    # another width, precision or dtype takes the kernel's rule
    assert gd.csr.sum_launch(False, 32, "fast") == KS.DEFAULT_LAUNCH
    assert gd.csr.sum_launch(False, 16, "exact") == KS.DEFAULT_LAUNCH
    assert gd.csr.sum_launch(False, 16, "fast", torch.bfloat16) == \
        KS.DEFAULT_LAUNCH
    assert gd.csr.gat_groups(2, 8, "exact") is None
    assert dense_graph_data(g, "xla", "fast", "cpu").csr.launch is None
    assert dense_graph_data(g, "kernel", "exact", "cpu").csr.launch is None
    other = datasets.get("roc-audit").graph
    assert dense_graph_data(other, "kernel", "fast", "cpu").csr.launch \
        is None
    monkeypatch.setenv("ROC_NO_TUNED", "1")
    assert dense_graph_data(g, "kernel", "fast", "cpu").csr.launch is None


def test_launch_is_ignored_by_the_plain_versions():
    g = datasets.get("roc-audit").graph
    csr = DeviceCsr.from_csr(g, "cpu", launch=LaunchTable(
        "fast", {"sum/8": (32, 4)}, {"sum/8": (16, 1)}))
    assert csr.tensors() and all(isinstance(t, torch.Tensor)
                                 for t in csr.tensors())
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (g.num_nodes, 8)).astype(np.float32))
    want = KS.aggregate_sum_plain(x, csr.row_ptr, csr.col_idx, "fast")
    for launch in (KS.DEFAULT_LAUNCH, (32, 4), (8, 1)):
        assert torch.equal(KS.aggregate_sum(x, csr.row_ptr, csr.col_idx,
                                            "fast", launch), want)


# -- refit and the measured table ---------------------------------------------

def test_refit_recovers_the_generating_rates_from_records_and_ledger():
    led = ledger.get_ledger()
    led.clear()
    sink = []
    led.attach(lambda kind, **rec: sink.append({"type": kind, **rec}))
    try:
        _, trials = S.sweep(S.SHAPES_CI, seed=0)
    finally:
        led.detach()
        led.clear()
    for source in (trials, [r for r in sink if r["type"] == "measurement"]):
        rates = R.refit_rates(source)
        assert rates["n"] == 5 and set(rates["vs_constants"]) == \
            {"byte_s", "row_s"}
        for name, ratio in rates["vs_constants"].items():
            assert abs(ratio - 1.0) <= 0.05, (name, ratio)
    exact = R.refit_rates(S.sweep(S.SHAPES_CI, "fp32", seed=0)[1])
    assert exact["n"] == 3 and all(abs(r - 1) <= 0.05 for r in
                                   exact["vs_constants"].values())
    ledger.get_ledger().clear()


def test_refit_rates_are_non_negative():
    """Records whose least-squares row rate comes out below 0 (the card's
    Reddit sweep: the model does not see the transpose's L2 locality)
    refit the byte rate alone, the row rate fixed at 0."""
    cols = [(1e9, 1e3), (2e9, 1e3), (3e9, 5e3), (4e9, 2e3)]
    recs = [S.TrialRecord("s", "bf16", f"c{i}", "sum", "probe", bc, rc,
                          True, 0.0, 1e-12 * bc - 2e-8 * rc)
            for i, (bc, rc) in enumerate(cols)]
    free = np.linalg.lstsq(np.asarray(cols) / np.asarray(
        [r.trial_s for r in recs])[:, None], np.ones(len(cols)),
        rcond=None)[0]
    assert free[1] < 0
    rates = R.refit_rates(recs)
    assert rates["row_s"] == 0.0 and rates["byte_s"] > 0
    # the positive column alone: byte_s = the 1/t-weighted fit of t on it
    t = np.asarray([r.trial_s for r in recs])
    bc = np.asarray([c[0] for c in cols])
    assert rates["byte_s"] == pytest.approx(
        float(np.sum(bc / t) / np.sum((bc / t) ** 2)), rel=1e-12)


def test_the_card_paths_refuse_on_the_cpu(tmp_path):
    g = datasets.get("roc-audit").graph
    bench = Sur.DeviceBench(g.col_idx, g.dst_idx, g.num_nodes, g.num_nodes,
                            "cpu")
    cfg = L.default_config("sum", (8,), "fast")
    with pytest.raises(SystemExit, match="refusing"):
        Sur.measure_seconds(cfg, bench)
    with pytest.raises(SystemExit, match="refusing"):
        R.update(R.to_measured_table([], interpret=True),
                 str(tmp_path / "m.json"))
    assert not (tmp_path / "m.json").exists()
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "roc_tpu_torch.tune",
                               "--device"], cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 1 and "refusing" in proc.stderr


def test_the_measured_table_feeds_the_priors(tmp_path, monkeypatch):
    monkeypatch.setenv("ROC_TUNED_PATH", str(tmp_path / "t.json"))
    assert agg_s_per_edge_column() == AGG_S_PER_EDGE_COLUMN
    assert OnlineCostModel().prior_weight() == PRIOR_WEIGHT
    _, trials = S.sweep(S.SHAPES_CI, seed=0)
    table = R.to_measured_table(trials, interpret=False, name="card",
                                power_limit="700.00 W")
    path = R.update(table)
    assert path == str(tmp_path / R.MEASURED_FILE)
    assert json.loads(Path(path).read_text())["device"] == \
        {"name": "card", "power_limit": "700.00 W"}
    assert agg_s_per_edge_column() == 2.0 * table["rates"]["byte_s"]
    assert OnlineCostModel().prior_weight() == MEASURED_PRIOR_WEIGHT
    assert OnlineCostModel(measured=False).prior_weight() == PRIOR_WEIGHT
    table["interpret"] = True
    Path(path).write_text(json.dumps(table))
    R._CACHE.clear()
    assert agg_s_per_edge_column() == AGG_S_PER_EDGE_COLUMN


def test_selftest_cli_passes():
    proc = subprocess.run([sys.executable, "-m", "roc_tpu_torch.tune",
                           "--selftest"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "tune-selftest: PASS" in proc.stdout
    assert proc.stdout.count(": ok") == 8


def test_cli_writes_the_store_and_prints_roc_tpus_lines(tmp_path):
    out = tmp_path / "t.json"
    env = {**os.environ, "ROC_TUNE_OBS_DIR": str(tmp_path / "obs")}
    proc = subprocess.run([sys.executable, "-m", "roc_tpu_torch.tune",
                           "--refit", "--out", str(out)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert f"tune: wrote 1 graph entries -> {out}" in lines
    assert any(ln.startswith("# calibration tune_probe: 5 pairs")
               for ln in lines)
    rates = json.loads(next(ln for ln in lines if ln.startswith(
        "tune: refit rates "))[len("tune: refit rates "):])
    assert set(rates) == {"byte_s", "row_s"}
    assert not store.validate_store(json.loads(out.read_text()))


# -- the trainer --------------------------------------------------------------

BASE = dict(num_epochs=3, learning_rate=0.01, weight_decay=5e-4,
            dropout_rate=0.0, eval_every=1000, seed=1,
            aggregate_backend="binned", aggregate_precision="fast")


def _quiet(*a, **k):
    pass


def test_autotune_run_equals_the_untuned_run_and_roc_tpu(tmp_path,
                                                         monkeypatch):
    """GCN 8-16-4 on roc-audit, fast, 3 epochs: the -autotune run sweeps
    (surrogate), places the winners and trains the untuned run's bits;
    both within 1e-5 of roc_tpu's run (both draw roc_tpu's Glorot init
    from the same seed)."""
    monkeypatch.setenv("ROC_TUNED_PATH", str(tmp_path / "t.json"))
    layers, out = [8, 16, 4], {}
    jtr = JTrainer(JConfig(dataset="roc-audit", layers=layers, **BASE),
                   jdatasets.get("roc-audit", seed=1),
                   jbuild_model("gcn", layers, 0.0))
    want = jtr.train(print_fn=_quiet).final_loss
    for tuned in (False, True):
        store.clear_cache()
        cfg = Config(dataset="roc-audit", layers=layers, device="cpu",
                     autotune=tuned, **BASE)
        tr = Trainer(cfg, datasets.get("roc-audit", seed=1),
                     build_model("gcn", layers, 0.0))
        assert (tr.gdata.csr.launch is not None) == tuned
        stats = tr.train(print_fn=_quiet)
        out[tuned] = (stats.final_loss, tr.predict_logits())
    assert set(tr.gdata.csr.launch.fwd) == {"sum/16", "sum/4"}
    assert out[True][0] == out[False][0]
    assert torch.equal(out[True][1], out[False][1])
    gap = abs(out[True][0] - want) / abs(want)
    print(f"-autotune run vs roc_tpu after 3 epochs: {gap:.2e} relative")
    assert gap <= 1e-5
    assert not store.validate_store(store.load_store())
