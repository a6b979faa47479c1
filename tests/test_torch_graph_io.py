"""The port's ROC-format IO (roc_tpu_torch/graph/lux.py, load_roc_dataset)
and the fault layer it reads through (fault/inject.py, retry.py,
durable.py), held against roc_tpu on the same seeded inputs: files
byte-equal both ways, arrays equal element for element, the same errors,
and a lazy dataset that reaches the device with the eager one's bits."""

import os
import warnings

import numpy as np
import pytest
import torch

from roc_tpu.fault import inject as jinject
from roc_tpu.graph import datasets as jdatasets
from roc_tpu.graph import lux as jlux
from roc_tpu_torch import fault
from roc_tpu_torch.fault import inject, retry
from roc_tpu_torch.graph import datasets, lux
from roc_tpu_torch.models import build_model
from roc_tpu_torch.serve import ServeEngine
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer
from roc_tpu_torch.train.frozen import load_frozen


@pytest.fixture(autouse=True)
def _disarmed():
    """Each test starts and ends with both packages' injection disarmed."""
    inject.configure("")
    retry.reset_retry_counts()
    yield
    inject.configure("")
    jinject.configure("")


def _synthetic(n=60, seed=7):
    return datasets.synthetic("io", n, 3.0, 5, 3, n_train=10, n_val=10,
                              n_test=10, seed=seed)


def _write_port(prefix, ds):
    lux.write_dataset(prefix, ds.graph, ds.features, ds.label_ids, ds.mask)


def _files(d):
    return sorted(os.listdir(d))


def _assert_same_dataset(a, b):
    """Every field equal (features bitwise)."""
    assert (a.graph.num_nodes, a.graph.num_edges) == \
        (b.graph.num_nodes, b.graph.num_edges)
    np.testing.assert_array_equal(a.graph.row_ptr, b.graph.row_ptr)
    np.testing.assert_array_equal(a.graph.col_idx, b.graph.col_idx)
    assert a.graph.row_ptr.dtype == b.graph.row_ptr.dtype
    assert a.graph.col_idx.dtype == b.graph.col_idx.dtype
    np.testing.assert_array_equal(np.asarray(a.features).view(np.uint32),
                                  np.asarray(b.features).view(np.uint32))
    np.testing.assert_array_equal(a.label_ids, b.label_ids)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert (a.labels is None) == (b.labels is None)
    if a.labels is not None:
        np.testing.assert_array_equal(a.labels, b.labels)
    assert (a.in_dim, a.num_classes) == (b.in_dim, b.num_classes)


# -- .lux and the sidecars ----------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "roc_tpu"])
def test_lux_round_trips_both_ways(tmp_path, writer):
    ds = _synthetic()
    path = str(tmp_path / ("g" + lux.LUX_SUFFIX))
    (lux if writer == "port" else jlux).write_lux(path, ds.graph)
    for reader in (lux, jlux):
        g = reader.read_lux(path)
        np.testing.assert_array_equal(g.row_ptr, ds.graph.row_ptr)
        np.testing.assert_array_equal(g.col_idx, ds.graph.col_idx)
    assert lux.read_header(path) == jlux.read_header(path) == \
        (ds.graph.num_nodes, ds.graph.num_edges)


@pytest.mark.parametrize("name,seed", [("io", 7), ("karate", 0)])
def test_write_dataset_is_byte_equal_to_roc_tpu(tmp_path, name, seed):
    ds = _synthetic(seed=seed) if name == "io" else datasets.get(name)
    _write_port(str(tmp_path / "port" / "d"), ds)
    jlux.write_dataset(str(tmp_path / "jax" / "d"), ds.graph, ds.features,
                       ds.label_ids, ds.mask)
    names = _files(tmp_path / "port")
    assert names == _files(tmp_path / "jax") == [
        "d.add_self_edge.lux", "d.feats.bin", "d.feats.csv", "d.label",
        "d.mask"]
    for f in names:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    lux.write_transpose(str(tmp_path / "port" / "d"), ds.graph)
    jlux.write_transpose(str(tmp_path / "jax" / "d"), ds.graph)
    t = "d" + lux.TLUX_SUFFIX
    assert (tmp_path / "port" / t).read_bytes() == \
        (tmp_path / "jax" / t).read_bytes()


# (reader, args, message) — each range is refused before any seek
RANGES = [("rows", (-1, 3), "invalid"), ("rows", (5, 4), "invalid"),
          ("rows", (0, 61), "runs past the end"),
          ("cols", (-2, 4), "invalid"), ("cols", (9, 8), "invalid"),
          ("cols", (0, 10**6), "runs past the end")]


@pytest.mark.parametrize("which,args,match", RANGES)
def test_slice_ranges_are_checked(tmp_path, which, args, match):
    ds = _synthetic()
    path = str(tmp_path / ("g" + lux.LUX_SUFFIX))
    lux.write_lux(path, ds.graph)
    for mod in (lux, jlux):
        inject_mod = inject if mod is lux else jinject
        inject_mod.configure("lux.read=perm")   # no read may be attempted
        with pytest.raises(ValueError, match=match):
            if which == "rows":
                mod.read_rows_slice(path, *args)
            else:
                mod.read_cols_slice(path, ds.graph.num_nodes, *args)
        assert inject_mod.counters() == {}
        inject_mod.configure("")
    np.testing.assert_array_equal(
        lux.read_rows_slice(path, 3, 9), jlux.read_rows_slice(path, 3, 9))
    np.testing.assert_array_equal(
        lux.read_cols_slice(path, 60, 7, 30),
        jlux.read_cols_slice(path, 60, 7, 30))


def test_truncated_lux_is_refused(tmp_path):
    ds = _synthetic()
    path = str(tmp_path / ("g" + lux.LUX_SUFFIX))
    lux.write_lux(path, ds.graph)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    inject.configure("retries=0")
    with pytest.raises(ValueError, match="runs past the end"):
        lux.read_lux(path)


def test_feature_cache_freshness(tmp_path):
    """A CSV newer than its cache is re-parsed (and the cache rewritten);
    a cache without a CSV is a binary-only distribution; ``mmap`` gives a
    read-only memmap.  roc_tpu reads the same values at every step."""
    ds = _synthetic()
    prefix = str(tmp_path / "d")
    _write_port(prefix, ds)
    n, d = ds.features.shape
    got = lux.load_features(prefix, n, d)
    np.testing.assert_array_equal(got, ds.features)
    # a regenerated CSV (newer than the cache) wins
    new = ds.features + 1.0
    np.savetxt(prefix + ".feats.csv", new, delimiter=",", fmt="%.9g")
    later = os.path.getmtime(prefix + ".feats.bin") + 10
    os.utime(prefix + ".feats.csv", (later, later))
    got = lux.load_features(prefix, n, d)
    np.testing.assert_array_equal(got, new)
    np.testing.assert_array_equal(jlux.load_features(prefix, n, d), new)
    assert os.path.getmtime(prefix + ".feats.bin") >= later - 10
    np.testing.assert_array_equal(
        np.fromfile(prefix + ".feats.bin", np.float32).reshape(n, d), new)
    # binary-only
    os.remove(prefix + ".feats.csv")
    np.testing.assert_array_equal(lux.load_features(prefix, n, d), new)
    mm = lux.load_features(prefix, n, d, mmap=True)
    assert isinstance(mm, np.memmap) and not mm.flags.writeable
    np.testing.assert_array_equal(mm, jlux.load_features(prefix, n, d,
                                                         mmap=True))
    with pytest.raises(ValueError):
        mm[0, 0] = 1.0
    # a stale CSV of the wrong shape is refused, not silently cached
    np.savetxt(prefix + ".feats.csv", new[:, :2], delimiter=",")
    os.utime(prefix + ".feats.csv", (later + 10, later + 10))
    with pytest.raises(ValueError, match="shape"):
        lux.load_features(prefix, n, d)


def test_label_cache_and_mask(tmp_path):
    ds = _synthetic()
    prefix = str(tmp_path / "d")
    _write_port(prefix, ds)
    n, c = ds.graph.num_nodes, ds.num_classes
    assert not os.path.exists(prefix + ".label.bin")
    first = lux.load_label_ids(prefix, n, c)
    assert os.path.exists(prefix + ".label.bin")
    np.testing.assert_array_equal(first, ds.label_ids)
    assert first.dtype == np.int64
    os.remove(prefix + ".label")           # the cache alone now
    np.testing.assert_array_equal(lux.load_label_ids(prefix, n, c), first)
    np.testing.assert_array_equal(lux.load_labels(prefix, n, c),
                                  jlux.load_labels(prefix, n, c))
    with pytest.raises(ValueError, match="class ids"):
        lux.load_label_ids(prefix, n, int(first.max()))
    np.testing.assert_array_equal(lux.load_mask(prefix, n),
                                  jlux.load_mask(prefix, n))
    with open(prefix + ".mask", "a") as f:
        f.write("Train\n")                  # longer files are cut to n
    np.testing.assert_array_equal(lux.load_mask(prefix, n), ds.mask)
    with pytest.raises(ValueError, match="too short"):
        lux.load_mask(prefix, n + 5)
    lines = open(prefix + ".mask").read().splitlines()
    lines[3] = "Holdout"
    with open(prefix + ".mask", "w") as f:
        f.write("\n".join(lines) + "\n")
    for mod in (lux, jlux):
        with pytest.raises(ValueError, match="Unrecognized mask: 'Holdout'"):
            mod.load_mask(prefix, n)


@pytest.mark.parametrize("lazy", [False, True])
def test_load_roc_dataset_matches_roc_tpu(tmp_path, lazy):
    ds = _synthetic(n=80, seed=3)
    prefix = str(tmp_path / "d")
    _write_port(prefix, ds)
    got = datasets.load_roc_dataset(prefix, ds.in_dim, ds.num_classes,
                                    lazy=lazy)
    want = jdatasets.load_roc_dataset(prefix, ds.in_dim, ds.num_classes,
                                      lazy=lazy)
    _assert_same_dataset(got, want)
    assert got.name == prefix
    assert isinstance(got.features, np.memmap) == lazy
    np.testing.assert_array_equal(got.onehot_labels(), ds.labels)
    np.testing.assert_array_equal(got.onehot_labels(),
                                  want.onehot_labels())


def test_graph_stub_is_refused(tmp_path):
    """A graph stub holds the header only: every trainer refuses it but
    the -perhost SPMD path (tests/test_torch_shard_load.py trains that)
    and the streaming executor given the stub's -file, which reads the
    .lux byte ranges (tests/test_torch_stream.py trains that)."""
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.driver import make_trainer
    ds = _synthetic(n=96, seed=5)
    prefix = str(tmp_path / "d")
    _write_port(prefix, ds)
    stub = datasets.load_roc_dataset(prefix, ds.in_dim, ds.num_classes,
                                     graph_stub=True)
    assert (stub.graph.num_nodes, stub.graph.num_edges) == \
        (ds.graph.num_nodes, ds.graph.num_edges)
    model = build_model("gcn", [ds.in_dim, 8, ds.num_classes])
    for kw in ({}, {"num_parts": 4}, {"num_parts": 4, "stream": True,
                                      "perhost_load": True}):
        with pytest.raises(SystemExit, match="graph stub"):
            make_trainer(Config(layers=[ds.in_dim, 8, ds.num_classes],
                                device="cpu", **kw), stub, model)
    tr = make_trainer(Config(layers=[ds.in_dim, 8, ds.num_classes],
                             device="cpu", num_parts=4, stream=True,
                             perhost_load=True, filename=prefix), stub, model)
    assert tr._lux_path == prefix + lux.LUX_SUFFIX
    tr.close()


# -- a lazy dataset on the device ----------------------------------------------

def _lazy_and_eager(tmp_path):
    ds = _synthetic(n=96, seed=5)
    prefix = str(tmp_path / "d")
    _write_port(prefix, ds)
    return (datasets.load_roc_dataset(prefix, 5, 3),
            datasets.load_roc_dataset(prefix, 5, 3, lazy=True))


def test_lazy_dataset_trains_bit_for_bit_as_eager(tmp_path):
    """The trainer takes a lazy dataset (labels None, a read-only memmap)
    without a warning; its device tensors and its run equal the eager
    dataset's bit for bit."""
    eager, lazy = _lazy_and_eager(tmp_path)
    assert lazy.labels is None
    cfg = Config(layers=[5, 8, 3], num_epochs=3, dropout_rate=0.5,
                 eval_every=1000, device="cpu")
    out = []
    for ds in (eager, lazy):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tr = Trainer(cfg, ds, build_model("gcn", cfg.layers, 0.5))
        loss = tr.train(print_fn=lambda *a: None).final_loss
        out.append((tr, loss, tr.predict_logits()))
    (te, le, pe), (tl, ll, pl) = out
    for name in ("x", "labels", "mask"):
        a, b = getattr(te, name), getattr(tl, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert le == ll and torch.equal(pe, pl)


def test_lazy_dataset_serves(tmp_path):
    eager, lazy = _lazy_and_eager(tmp_path)
    cfg = Config(layers=[5, 8, 3], dropout_rate=0.0)
    model = build_model("gcn", cfg.layers, 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = load_frozen(cfg, lazy, model, device="cpu")
    assert torch.equal(b.x, load_frozen(cfg, eager, model, device="cpu").x)
    with ServeEngine(cfg, lazy, model, device="cpu") as eng:
        rows = eng.query([3, 1, 4])
    np.testing.assert_array_equal(rows, b.predict_logits()[[3, 1, 4]])


# -- the fault layer lux reads through ---------------------------------------

@pytest.mark.parametrize("spec", [
    "", "seed=7", "retries=0,lux.read=1", "slow_ms=80,a.slow=2",
    "lux.read=perm,x@0.25,seed=3"])
def test_parse_spec_matches_roc_tpu(spec):
    seed, retries, slow_s, rules = inject.parse_spec(spec)
    jseed, jretries, jslow_s, jrules = jinject.parse_spec(spec)
    assert (seed, retries, slow_s) == (jseed, jretries, jslow_s)
    assert {k: (r.count, r.perm, r.prob) for k, r in rules.items()} == \
        {k: (r.count, r.perm, r.prob) for k, r in jrules.items()}


@pytest.mark.parametrize("bad", ["x", "a@2", "retries=-1", "s=-3"])
def test_parse_spec_refuses_what_roc_tpu_refuses(bad):
    for mod in (inject, jinject):
        with pytest.raises(ValueError):
            mod.parse_spec(bad)


def test_probabilistic_schedule_matches_roc_tpu():
    spec = "seed=11,io.p@0.3"
    fired = []
    for mod in (inject, jinject):
        mod.configure(spec)
        hits = []
        for i in range(64):
            try:
                mod.point("io.p")
            except mod.InjectedFault:
                hits.append(i)
        fired.append(hits)
        assert mod.counters()["io.p"] == {"calls": 64, "fired": len(hits)}
    assert fired[0] == fired[1] and 5 < len(fired[0]) < 40


def test_kill_sites_escape_retries():
    inject.configure("x.kill=1")
    with pytest.raises(inject.SimulatedCrash):
        fault.retrying("x.kill", lambda: fault.point("x.kill"),
                       base_s=0.001)
    assert fault.retry_counts() == {}


def test_lux_read_retried(tmp_path):
    """An armed ``lux.read`` fault is retried and counted
    (tests/test_fault.py:120 for roc_tpu); with ``retries=0`` it fails."""
    ds = _synthetic()
    path = str(tmp_path / ("g" + lux.LUX_SUFFIX))
    lux.write_lux(path, ds.graph)
    want = lux.read_rows_slice(path, 0, 10)
    inject.configure("seed=2,lux.read=2")
    got = lux.read_rows_slice(path, 0, 10)
    np.testing.assert_array_equal(got, want)
    assert inject.counters()["lux.read"] == {"calls": 3, "fired": 2}
    assert retry.retry_counts() == {"lux.read": 2}
    g = lux.read_lux(path)            # a whole read under the same spec
    np.testing.assert_array_equal(g.col_idx, ds.graph.col_idx)
    inject.configure("seed=2,retries=0,lux.read=1")
    with pytest.raises(OSError):
        lux.read_rows_slice(path, 0, 10)
    inject.configure("seed=2,lux.read=perm")
    with pytest.raises(inject.InjectedFault):
        datasets.load_roc_dataset(path[:-len(lux.LUX_SUFFIX)], 5, 3)


def test_fsync_replace(tmp_path):
    target = tmp_path / "t.bin"
    target.write_bytes(b"old")
    tmp = tmp_path / "t.bin.tmp"
    tmp.write_bytes(b"new")
    fault.fsync_replace(str(tmp), str(target))
    assert target.read_bytes() == b"new" and not tmp.exists()
