"""The port's streaming executor (roc_tpu_torch.stream) and the partition it
rotates, against roc_tpu's, on the CPU (the wrappers run the kernels'
plain versions; the ring's copies are synchronous).

Tolerances:
  partition arrays and meta, split_segments, predicted bytes    equal
  streamed vs in-core loss, 3 epochs, dropout 0                 1e-3
                                                     (as test_stream.py:49)
  streamed vs roc_tpu's StreamTrainer, 3 epochs, dropout 0.5    1e-5 relative
  the four storage tiers on the integer fixture                 bitwise
  spill stores across packages                                  bitwise
  served rows under -stream vs the in-core eval                 1e-5 of each
                                                                row's max-abs
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.graph import partition as jpart
from roc_tpu.models import build_model as jbuild
from roc_tpu.stream import segments as jseg
from roc_tpu.stream import spill as jspill
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import make_trainer as jmake_trainer
from roc_tpu_torch.analysis import witness
from roc_tpu_torch.graph import datasets, lux
from roc_tpu_torch.graph import partition
from roc_tpu_torch.graph.csr import add_self_edges, from_edges
from roc_tpu_torch.graph.datasets import Dataset
from roc_tpu_torch.models import build_model
from roc_tpu_torch.stream import host as stream_host
from roc_tpu_torch.stream import incore_resident_bytes, segments, spill
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import make_trainer
from roc_tpu_torch.train.frozen import load_frozen


@pytest.fixture(autouse=True)
def _lock_order_witness():
    # every test here runs under the armed lock-order witness: the locks it
    # creates record their acquisition orders, and an order outside the
    # port's threads.json fails the test at teardown
    with witness.armed_scope():
        yield


ROOT = Path(__file__).resolve().parents[1]
MODELS = ["gcn", "gcn-chain", "sage", "gin", "gat"]


@pytest.fixture(autouse=True)
def _binned_runs_under_jax_0_9():
    """run_binned's one-shot eager warning calls jax.core.trace_state_clean,
    which jax 0.9.0 no longer exports (ROADMAP queue C)."""
    from roc_tpu.ops.pallas import binned
    old = binned._EAGER_WARNED
    binned._EAGER_WARNED = True
    yield
    binned._EAGER_WARNED = old


def _cfg(ds, *, model="gcn", parts=1, stream=False, dropout=0.0, **kw):
    layers = kw.pop("layers", [ds.in_dim, 16, ds.num_classes])
    return dict(layers=layers, num_epochs=3, dropout_rate=dropout,
                eval_every=10**9, num_parts=parts, model=model, heads=2,
                stream=stream, **kw)


def _trainer(ds, **kw):
    cfg = Config(**_cfg(ds, **kw), device="cpu",
                 aggregate_backend=kw.pop("backend", "binned"),
                 aggregate_precision="exact")
    return make_trainer(cfg, ds, build_model(
        cfg.model, cfg.layers, cfg.dropout_rate, heads=2))


# -- partition ---------------------------------------------------------------

def _graphs():
    ds = datasets.get("roc-audit", seed=1)
    rng = np.random.default_rng(3)
    n = 300
    skew = add_self_edges(from_edges(
        n, rng.integers(0, n, 4000), np.minimum(
            rng.geometric(0.02, 4000), n - 1)))
    return {"roc-audit": ds.graph, "skewed": skew}


@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("name", ["roc-audit", "skewed"])
def test_partition_bitwise_equal_roc_tpu(name, parts):
    from roc_tpu.graph.csr import Csr as JCsr
    g = _graphs()[name]
    jg = JCsr(g.num_nodes, g.num_edges, g.row_ptr, g.col_idx)
    a, b = jpart.partition_graph(jg, parts), partition.partition_graph(g,
                                                                       parts)
    for f in ("num_parts", "shard_nodes", "shard_edges", "num_nodes",
              "num_edges", "bounds", "num_valid", "num_edges_valid",
              "edge_starts", "edge_src", "edge_dst", "in_degree",
              "node_mask"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert partition.bounds_from_row_ptr(g.row_ptr, parts) == \
        [tuple(b) for b in jpart.bounds_from_row_ptr(g.row_ptr, parts)]
    for fn in ("edge_block_arrays", "edge_block_arrays_t"):
        for x, y in zip(getattr(jpart, fn)(jg, a.meta),
                        getattr(partition, fn)(g, b.meta)):
            assert np.array_equal(x, y), fn
    feats = np.arange(g.num_nodes * 3, dtype=np.float32).reshape(-1, 3)
    assert np.array_equal(b.meta.pad_nodes(feats), a.meta.pad_nodes(feats))
    assert np.array_equal(b.meta.unpad_nodes(b.meta.pad_nodes(feats)), feats)
    v = np.arange(g.num_nodes)
    assert np.array_equal(b.meta.to_padded(v), a.meta.to_padded(v))


def test_partition_cut_overrides_and_refusals():
    g = _graphs()["roc-audit"]
    p = partition.partition_graph(g, 3)
    q = partition.partition_graph(g, 3, bounds=p.bounds,
                                  shard_nodes=p.shard_nodes + 8,
                                  shard_edges=p.shard_edges + 8)
    assert q.shard_nodes == p.shard_nodes + 8
    with pytest.raises(ValueError, match="not contiguous"):
        partition.validate_bounds(np.array([[0, 5], [7, g.num_nodes - 1]]),
                                  g.num_nodes)
    with pytest.raises(ValueError, match="cannot hold"):
        partition.compute_meta(g.row_ptr, 3, shard_nodes=8)


# -- segments ----------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_segments_and_predicted_bytes_equal_roc_tpu(name):
    layers = [32, 16, 16, 8]
    a = jseg.split_segments(jbuild(name, layers, 0.5, "", heads=2))
    b = segments.split_segments(build_model(name, layers, 0.5, heads=2))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (y.index, y.table_tid, y.own_in_tids, y.out_tids, y.is_last,
                y.out_dims) == (x.index, x.table_tid, x.own_in_tids,
                                x.out_tids, x.is_last, x.out_dims)
        assert [op.out for op in y.body] == [op.out for op in x.body]
        assert (y.head is None) == (x.head is None)
    for ai, ei in ((4, 4), (2, 2), (2, 4)):
        assert segments.predicted_epoch_bytes(
            b, 4, 120, 900, 40, 8, act_itemsize=ai, esrc_itemsize=ei,
            edst_itemsize=ei) == jseg.predicted_epoch_bytes(
            a, 4, 120, 900, 40, 8, act_itemsize=ai, esrc_itemsize=ei,
            edst_itemsize=ei)


# -- streamed training --------------------------------------------------------

@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_streamed_loss_matches_incore(model):
    """Dropout 0, 4 shards through 2 slots against the in-core trainer:
    the rotation is a schedule, not another algorithm (test_stream.py:49)."""
    ds = datasets.get("roc-audit", seed=1)
    ref = _trainer(ds, model=model)
    tr = _trainer(ds, model=model, parts=4, stream=True)
    for _ in range(3):
        want, got = float(ref.run_epoch()), float(tr.run_epoch())
        assert abs(want - got) <= 1e-3
    assert torch.allclose(tr.predict_logits(), ref.predict_logits(),
                          atol=1e-4)


@pytest.mark.parametrize("model", ["gcn", "sage", "gat", "gin"])
def test_streamed_training_matches_roc_tpu_stream(model):
    """Dropout 0.5 (each shard's masks from fold_in(step_key, i)), 3
    epochs: within 1e-5 relative of roc_tpu's StreamTrainer."""
    layers = [8, 4, 4] if model == "gat" else [8, 16, 4]
    kw = _cfg(datasets.get("roc-audit", seed=1), model=model, parts=4,
              stream=True, dropout=0.5, layers=layers)
    jtr = jmake_trainer(JConfig(**kw), jdatasets.get("roc-audit", seed=1),
                        jbuild(model, layers, 0.5, "", heads=2))
    tr = _trainer(datasets.get("roc-audit", seed=1), model=model, parts=4,
                  stream=True, dropout=0.5, layers=layers)
    assert (tr._S, tr._E, tr._K) == (jtr._S, jtr._E, jtr._K)
    assert np.array_equal(tr._tbl_idx, jtr._tbl_idx)
    for _ in range(3):
        want, got = float(jtr.run_epoch()), float(tr.run_epoch())
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    want = jtr._meta.unpad_nodes(np.asarray(jtr.predict_logits()))
    got = tr.predict_logits().numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * np.maximum(scale, 1.0)).all()


def test_streamed_epoch_stats_and_transfer_accounting():
    ds = datasets.get("roc-audit", seed=1)
    tr = _trainer(ds, parts=4, stream=True)
    tr.run_epoch()
    st = tr.stream_stats()
    for k in ("stream_stall_s", "stream_transfer_s", "stream_overlap_frac",
              "stream_stall_frac", "stream_bytes", "stream_scatter_s",
              "stream_scatter_overlap_frac"):
        assert k in st, k
    assert 0.0 <= st["stream_overlap_frac"] <= 1.0
    # the port's own prediction prices exactly what _fetch ships
    assert st["stream_bytes"] == tr.predicted_epoch_xfer_bytes()["port"]
    assert st["num_parts"] == 4 and st["segments"] == 3
    assert st["host_stores"]["pinned"] is False


# -- the tiers on the integer fixture -----------------------------------------

def _int_dataset():
    """tests/test_stream_tiers.py's fixture: 64 nodes, every in-degree 4,
    {0,1} features."""
    n, F, C = 64, 8, 4
    src = np.concatenate([(np.arange(n) + k) % n for k in (1, 17, 33)])
    dst = np.tile(np.arange(n), 3)
    g = add_self_edges(from_edges(n, src, dst))
    assert np.unique(np.diff(g.row_ptr)).tolist() == [4]
    rng = np.random.default_rng(0)
    feats = rng.integers(0, 2, size=(n, F)).astype(np.float32)
    ids = rng.integers(0, C, size=n).astype(np.int64)
    return Dataset("int-tiers", g, feats, lux.one_hot(ids, C), ids,
                   np.zeros(n, np.int32), F, C)


def _int_params(params):
    """Sparse {0,1} weights (one 1 per column): every activation stays an
    exact small dyadic rational (test_stream_tiers.py:73-85)."""
    out = {}
    for k, x in params.items():
        w = torch.zeros_like(x)
        w[torch.arange(x.shape[1]) % x.shape[0],
          torch.arange(x.shape[1])] = 1.0
        out[k] = w
    return out


COMBOS = [("fp32", False, False), ("bf16", True, False),
          ("fp32+spill", False, True), ("bf16+spill", True, True)]


def test_tier_combos_bitwise_on_integer_fixture(tmp_path):
    """The epoch-1 loss and the logits bitwise across the four tier
    combinations, equal to roc_tpu's streamed fp32 loss, and within 1e-3
    of the in-core trainer's."""
    ds = _int_dataset()
    losses, logits = {}, {}
    for name, bf16, sp in COMBOS:
        cfg = Config(layers=[ds.in_dim, 8, ds.num_classes], num_epochs=1,
                     dropout_rate=0.0, eval_every=10**9, num_parts=4,
                     stream=True, bf16_storage=bf16, device="cpu",
                     stream_spill=str(tmp_path / name) if sp else "")
        tr = make_trainer(cfg, ds, build_model("gcn", cfg.layers, 0.0))
        tr.params = _int_params(tr.params)
        logits[name] = tr.predict_logits()
        losses[name] = float(tr.run_epoch())
        if sp:
            assert {f for f in os.listdir(tmp_path / name)} == \
                {f"{k}{t}.spill" for k in ("act", "cot")
                 for t in tr._spill_tids}
        tr.close()
    assert len(set(losses.values())) == 1, losses
    for name in ("bf16", "fp32+spill", "bf16+spill"):
        assert torch.equal(logits[name], logits["fp32"]), name
    # roc_tpu's streamed fp32 epoch on the same fixture
    import jax.numpy as jnp
    from roc_tpu.graph.csr import Csr as JCsr
    from roc_tpu.graph.datasets import Dataset as JDataset
    g = ds.graph
    jds = JDataset("int-tiers", JCsr(g.num_nodes, g.num_edges, g.row_ptr,
                                     g.col_idx), ds.features, ds.labels,
                   ds.label_ids, ds.mask, ds.in_dim, ds.num_classes)
    jcfg = JConfig(layers=[ds.in_dim, 8, ds.num_classes], num_epochs=1,
                   dropout_rate=0.0, eval_every=10**9, num_parts=4,
                   stream=True)
    jtr = jmake_trainer(jcfg, jds, jbuild("gcn", jcfg.layers, 0.0, ""))
    jtr.params = {k: jnp.asarray(v.numpy())
                  for k, v in _int_params(
                      {k: torch.from_numpy(np.array(v))
                       for k, v in jtr.params.items()}).items()}
    assert float(jtr.run_epoch()) == losses["fp32"]
    ref = make_trainer(Config(layers=[ds.in_dim, 8, ds.num_classes],
                              dropout_rate=0.0, device="cpu"), ds,
                       build_model("gcn", [ds.in_dim, 8, ds.num_classes],
                                   0.0))
    ref.params = _int_params(ref.params)
    assert abs(float(ref.run_epoch()) - losses["fp32"]) <= 1e-3


def test_bf16_tier_narrows_the_edge_wire():
    """Under -bf16-storage a shard whose table fits 16 bits ships its CSR
    sources as 16-bit words, widened on the device to the same indices."""
    ds = _int_dataset()
    cfgs = [Config(layers=[ds.in_dim, 8, ds.num_classes], num_parts=4,
                   stream=True, bf16_storage=b, device="cpu")
            for b in (False, True)]
    a, b = (make_trainer(c, ds, build_model("gcn", c.layers)) for c in cfgs)
    assert a._col.dtype == np.int32 and b._col.dtype == np.int16
    assert np.array_equal(b._col.view(np.uint16).astype(np.int32), a._col)
    assert b.predicted_epoch_xfer_bytes()["port"] < \
        a.predicted_epoch_xfer_bytes()["port"]


# -- host stores and spill ----------------------------------------------------

def test_pinned_allocator_falls_back_on_cpu():
    """Without a CUDA device the allocator hands back writable NumPy
    memory and counts it as fallback (test_stream_tiers.py:162)."""
    assert not stream_host.pinned_supported()
    stream_host.reset_stats()
    a = stream_host.alloc((4, 3), np.float32)
    a[:] = 7.0
    src = np.arange(12, dtype=np.float32).reshape(4, 3)
    b = stream_host.to_store(src)
    assert np.array_equal(b, src)
    st = stream_host.stats()
    assert st["pinned"] is False and st["pinned_bytes"] == 0
    assert st["fallback_bytes"] >= 2 * 48


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("writer", ["port", "roc_tpu"])
def test_spill_stores_interchangeable(tmp_path, writer, bf16):
    """A store written by either package opens in the other with the same
    bytes; bf16 is roc_tpu's ml_dtypes bfloat16 and the port's raw words."""
    import ml_dtypes
    vals = np.linspace(-3, 3, 30, dtype=np.float32).reshape(6, 5)
    jdt = np.dtype(ml_dtypes.bfloat16) if bf16 else np.dtype(np.float32)
    pdt = stream_host.BF16 if bf16 else np.dtype(np.float32)
    want = vals.astype(jdt)
    p = str(tmp_path / "s.spill")
    if writer == "port":
        m = spill.create_store(p, (6, 5), pdt)
        m[:] = want.view(pdt)
    else:
        m = jspill.create_store(p, (6, 5), jdt)
        m[:] = want
    m.flush()
    del m
    back = (jspill if writer == "port" else spill).open_store(p)
    assert back.shape == (6, 5)
    assert np.array_equal(np.asarray(back).view(np.uint8),
                          want.view(np.uint8))


def test_spill_corrupt_or_torn_header_raises_typed(tmp_path):
    p = str(tmp_path / "c.spill")
    m = spill.create_store(p, (4, 4), np.float32)
    m[:] = 1.0
    m.flush()
    del m
    raw = bytearray(open(p, "rb").read())
    raw[9] ^= 0xFF
    with open(p, "wb") as f:
        f.write(raw)
    with pytest.raises(spill.SpillHeaderError, match="CRC"):
        spill.open_store(p)
    torn = str(tmp_path / "torn.spill")
    with open(torn, "wb") as f:
        f.write(b"RSPL" + b"\0" * 10)
    with pytest.raises(spill.SpillHeaderError, match="truncated header"):
        spill.open_store(torn)
    short = str(tmp_path / "short.spill")
    m = spill.create_store(short, (8, 8), np.float32)
    m.flush()
    del m
    with open(short, "r+b") as f:
        f.truncate(spill.HEADER_BYTES + 16)
    with pytest.raises(spill.SpillHeaderError, match="data region"):
        spill.open_store(short)
    with pytest.raises(spill.SpillError, match="unsupported dtype"):
        spill.create_store(str(tmp_path / "x.spill"), (2, 2), np.int64)


# -- gates --------------------------------------------------------------------

def test_budget_gate_text_equals_roc_tpu():
    ds = datasets.synthetic("oocore", 3000, 6.0, 16, 4, n_train=600,
                            n_val=600, n_test=600, seed=5)
    jds = jdatasets.synthetic("oocore", 3000, 6.0, 16, 4, n_train=600,
                              n_val=600, n_test=600, seed=5)
    need = incore_resident_bytes(ds)
    from roc_tpu.stream import incore_resident_bytes as jneed
    assert need == jneed(jds)
    kw = _cfg(ds, stream_budget=str(need // 3))
    with pytest.raises(SystemExit) as got:
        make_trainer(Config(**kw, device="cpu"), ds,
                     build_model("gcn", kw["layers"]))
    with pytest.raises(SystemExit) as want:
        jmake_trainer(JConfig(**kw), jds, jbuild("gcn", kw["layers"]))
    assert str(got.value) == str(want.value)
    assert "rerun with -stream" in str(got.value)
    tr = _trainer(ds, parts=8, stream=True, stream_budget=str(need // 3))
    assert np.isfinite(float(tr.run_epoch()))


def test_stream_slots_fit_where_incore_does_not():
    """Two slots hold less than the in-core path places, at 16 shards.
    On test_stream.py's fixture at 8 shards (its halo width is nearly the
    whole owner, so a table is ~9 shards' rows) roc_tpu's two slots come to
    548,224 B against 575,696; the port's slot also carries each shard's
    transposed CSR (int64 row pointers over the table's rows), and its two
    come to 609,696 B there, 6 % over."""
    ds = datasets.synthetic("oocore", 3000, 6.0, 16, 4, n_train=600,
                            n_val=600, n_test=600, seed=5)
    tr = _trainer(ds, parts=16, stream=True)
    assert tr.slot_bytes() * tr.config.stream_slots < \
        incore_resident_bytes(ds)


@pytest.mark.parametrize("kw,match", [
    (dict(stream=True, parts=4, multihost=True), "SPMD trainer"),
    (dict(stream=True, parts=1), "needs -parts >= 2"),
    (dict(stream=True, parts=4, use_bf16=True), "-stream computes in fp32")])
def test_stream_refusals(kw, match):
    ds = datasets.get("roc-audit", seed=1)
    with pytest.raises(SystemExit, match=match):
        _trainer(ds, **kw)


def test_spill_requires_stream():
    with pytest.raises(SystemExit, match="requires -stream"):
        Config(layers=[8, 4], stream_spill="/tmp/nope")


# -- slots, checkpoints and serving -------------------------------------------

def test_slot_tensors_reused_across_rotations():
    """Every rotation refills the same device tensors (same data_ptr): the
    card holds stream_slots slots however many shards rotate."""
    ds = datasets.get("roc-audit", seed=1)
    tr = _trainer(ds, parts=4, stream=True)
    seen = {}
    fetch = tr._fetch

    def spy(item):
        a = fetch(item)
        for k in ("row_ptr", "indeg", "table"):
            if k in a:
                seen.setdefault((a["slot"], k), set()).add(a[k].data_ptr())
        return a

    tr._ring._fetch_fn = spy
    tr.run_epoch()
    tr.evaluate()
    assert {s for s, _ in seen} == {0, 1}
    assert all(len(p) == 1 for p in seen.values()), seen
    bufs = {id(b) for s in tr._slots for b in s.dev.values()}
    tr.run_epoch()
    assert bufs == {id(b) for s in tr._slots for b in s.dev.values()}


def test_checkpoints_cross_between_stream_and_incore(tmp_path):
    ds = datasets.get("roc-audit", seed=1)
    st = _trainer(ds, parts=4, stream=True)
    st.run_epoch()
    path = str(tmp_path / "s.npz")
    st.save_checkpoint(path)
    inc = _trainer(ds)
    inc.restore(path)
    assert inc.epoch == st.epoch
    for k in st.params:
        assert torch.equal(inc.params[k], st.params[k])
        assert torch.equal(inc.opt_state.m[k], st.opt_state.m[k])
    want = [float(st.run_epoch()), float(inc.run_epoch())]
    assert abs(want[0] - want[1]) <= 1e-3
    inc.save_checkpoint(path)
    st2 = _trainer(ds, parts=4, stream=True)
    st2.restore(path)
    for k in inc.params:
        assert torch.equal(st2.params[k], inc.params[k])


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_load_frozen_under_stream_serves_incore_rows(tmp_path, model):
    ds = datasets.get("roc-audit", seed=1)
    layers = [8, 4, 4] if model == "gat" else [8, 16, 4]
    m = build_model(model, layers, heads=2)
    path = str(tmp_path / "w.npz")
    checkpoint.save(path, m.init_params((0, 5)))
    base = dict(dataset="roc-audit", layers=layers, model=model, heads=2,
                aggregate_backend="binned", aggregate_precision="exact")
    inc = load_frozen(Config(**base), ds, m, path, device="cpu")
    st = load_frozen(Config(**base, stream=True, num_parts=3), ds, m, path,
                     device="cpu")
    assert st.x is None and st.gdata is None and st.stream_trainer
    want, got = inc.predict_logits(), st.predict_logits()
    assert got.shape == want.shape == (ds.graph.num_nodes, layers[-1])
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    assert ((got - want).abs() <= 1e-5 * scale).all()


def test_serve_selftest_under_stream():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "roc_tpu_torch.serve", "--selftest",
         "--device", "cpu", "-stream", "-parts", "3"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "streamed through 3 shards" in proc.stdout
    assert "# serve selftest: OK" in proc.stdout


def test_cli_streams_reddit_small(tmp_path):
    """python -m roc_tpu_torch -dataset reddit-small -layers 602-64-41 -e 3
    -stream -parts 4 -device cpu trains and prints the metric line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "roc_tpu_torch", "-dataset", "reddit-small",
         "-layers", "602-64-41", "-e", "3", "-stream", "-parts", "4",
         "-device", "cpu", "-v"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "# stream: 4 shards x 3 segments through 2 slots" in proc.stdout
    assert "[INFER][0] train_loss:" in proc.stdout


def test_ring_stats_consistent_under_concurrent_readers():
    """The worker and the consumers write busy_s and stall_s, readers
    snapshot them (test_stream.py:171): with more consumer threads than
    cores and a short switch interval, every snapshot stays consistent and
    busy_s absorbs every fetch."""
    import threading
    import time

    from roc_tpu_torch.stream.ring import PrefetchRing

    fetched = []

    def fetch(item):
        time.sleep(0.001)
        fetched.append(item)
        return item

    ring = PrefetchRing(4, fetch)
    bad, stop = [], threading.Event()
    n = (os.cpu_count() or 1) + 2

    def reader():
        while not stop.is_set():
            st = ring.epoch_stats()
            if not (np.isfinite(st["stall_s"]) and st["stall_s"] >= 0.0
                    and st["transfer_s"] >= 0.0
                    and 0.0 <= st["overlap_frac"] <= 1.0):
                bad.append(st)
                return

    def consumer(base):
        for i in range(24):
            assert ring.wait(("item", base, i)) == ("item", base, i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        rt = threading.Thread(target=reader)
        cs = [threading.Thread(target=consumer, args=(b,)) for b in range(n)]
        rt.start()
        for t in cs:
            t.start()
        for t in cs:
            t.join(60.0)
        stop.set()
        rt.join(10.0)
        assert not rt.is_alive() and not any(t.is_alive() for t in cs)
        assert bad == [] and len(fetched) == n * 24
        assert ring.epoch_stats()["transfer_s"] >= n * 24 * 0.001
        ring.reset_epoch_stats()
        assert ring.epoch_stats()["transfer_s"] == 0.0
    finally:
        sys.setswitchinterval(old)
        ring.close()


def test_obs_records_carry_stream_fields(tmp_path):
    """Under -obs a streamed run's metrics records carry the epoch's
    stream_* fields, its wire bytes are the bytes streamed, and the
    watchdog takes the stall feed (driver.py:594-659)."""
    from roc_tpu_torch.obs import load_jsonl
    ds = datasets.get("roc-audit", seed=1)
    tr = _trainer(ds, parts=4, stream=True, obs=True,
                  obs_dir=str(tmp_path))
    tr.train(print_fn=lambda *a, **k: None)
    recs = [r for r in load_jsonl(str(tmp_path / "metrics.jsonl"))
            if r.get("type") == "metrics"]
    assert len(recs) == 3
    for r in recs:
        assert r["wire_bytes"] == r["stream_bytes"] > 0
        assert 0.0 <= r["stream_stall_frac"] <= 1.0
    assert tr.watchdog.stall_observed == 3


# -- the graph stub and reshard ---------------------------------------------------

@pytest.fixture(scope="module")
def stub_prefix(tmp_path_factory):
    ds = datasets.synthetic("stub", 600, 6.0, 12, 5, n_train=120, n_val=100,
                            n_test=100, seed=7)
    prefix = str(tmp_path_factory.mktemp("stub") / "g")
    lux.write_dataset(prefix, ds.graph, ds.features, ds.label_ids, ds.mask)
    return prefix


def _stream_cfg(prefix, **kw):
    return Config(filename=prefix, layers=[12, 16, 5], num_parts=4,
                  num_epochs=3, dropout_rate=0.5, eval_every=10**9,
                  stream=True, device="cpu", aggregate_backend="binned",
                  aggregate_precision="exact", **kw)


def test_stream_streams_a_graph_stub_bitwise(stub_prefix):
    """-stream -perhost: the shards come off the .lux byte ranges and
    train bit for bit as the full graph's streamed run (executor.py:
    189-200)."""
    from roc_tpu_torch.graph.datasets import GraphStub
    full = make_trainer(_stream_cfg(stub_prefix),
                        datasets.load_roc_dataset(stub_prefix, 12, 5),
                        build_model("gcn", [12, 16, 5], 0.5))
    stub_ds = datasets.load_roc_dataset(stub_prefix, 12, 5,
                                        graph_stub=True)
    assert isinstance(stub_ds.graph, GraphStub)
    stub = make_trainer(_stream_cfg(stub_prefix, perhost_load=True),
                        stub_ds, build_model("gcn", [12, 16, 5], 0.5))
    assert stub._lux_path and not stub._balance_supported()
    assert full._balance_supported()
    assert (stub._S, stub._E, stub._K) == (full._S, full._E, full._K)
    assert np.array_equal(stub._tbl_idx, full._tbl_idx)
    for _ in range(3):
        assert float(stub.run_epoch()) == float(full.run_epoch())
    assert torch.equal(stub.predict_logits(), full.predict_logits())
    stub.close()
    full.close()


@pytest.mark.parametrize("on_stub", [False, True])
def test_stream_reshard_same_bounds_is_bit_for_bit(stub_prefix, on_stub):
    """A reshard onto the current cut rebuilds the maps and keeps every
    bit of the run (the frozen shapes, the same K); on the .lux path it
    re-reads the byte ranges."""
    ds = datasets.load_roc_dataset(stub_prefix, 12, 5, graph_stub=on_stub)
    a = make_trainer(_stream_cfg(stub_prefix, perhost_load=on_stub), ds,
                     build_model("gcn", [12, 16, 5], 0.5))
    b = make_trainer(_stream_cfg(stub_prefix, perhost_load=on_stub), ds,
                     build_model("gcn", [12, 16, 5], 0.5))
    la = [float(a.run_epoch())]
    K = b._K
    lb = [float(b.run_epoch())]
    assert b.reshard(np.asarray(b.part.bounds)) >= 0.0
    assert b._K == K
    la += [float(a.run_epoch()) for _ in range(2)]
    lb += [float(b.run_epoch()) for _ in range(2)]
    assert la == lb
    a.close()
    b.close()


def _skewed_bounds(n, P=4):
    cuts = np.linspace(0, n // 2, P).astype(np.int64)
    lo = np.concatenate([[0], cuts[1:]])
    hi = np.concatenate([cuts[1:] - 1, [n - 1]])
    return np.stack([lo, hi], axis=1)


def test_stream_reshard_new_cut_and_frozen_width(stub_prefix):
    """A reshard onto a balanced cut under the skewed cut's frozen shapes
    trains as a fresh run on the balanced cut (1e-5: the padding
    differs); a cut that needs a wider halo than the frozen K raises."""
    ds = datasets.load_roc_dataset(stub_prefix, 12, 5)
    model = build_model("gcn", [12, 16, 5], 0.5)
    from roc_tpu_torch.stream.executor import StreamTrainer
    skew = StreamTrainer(_stream_cfg(stub_prefix), ds, model,
                         bounds=_skewed_bounds(ds.graph.num_nodes))
    fresh = StreamTrainer(_stream_cfg(stub_prefix), ds, model)
    shapes = (skew._S, skew._E, skew._K)
    skew.reshard(np.asarray(fresh.part.bounds))
    assert (skew._S, skew._E, skew._K) == shapes
    assert np.array_equal(skew.part.bounds, fresh.part.bounds)
    for _ in range(3):
        np.testing.assert_allclose(float(skew.run_epoch()),
                                   float(fresh.run_epoch()), rtol=1e-5)
    from roc_tpu_torch.stream.executor import _stream_maps
    with pytest.raises(ValueError, match="frozen K"):
        _stream_maps(fresh.part.meta, fresh.part.edge_src, K_force=1)
    skew.close()
    fresh.close()


def test_stream_balancer_reshards_a_skewed_cut(stub_prefix):
    """-stream -balance-every 1 from a skewed cut (probe times injected):
    at least one reshard, the loss within 1e-3 of the unbalanced run."""
    from roc_tpu_torch.stream.executor import StreamTrainer
    ds = datasets.load_roc_dataset(stub_prefix, 12, 5)
    quiet = lambda *_: None  # noqa: E731
    bounds = _skewed_bounds(ds.graph.num_nodes)
    cfg = dataclasses.replace(_stream_cfg(stub_prefix), dropout_rate=0.0)
    ref = StreamTrainer(cfg, ds, build_model("gcn", [12, 16, 5], 0.0),
                        bounds=bounds)
    want = ref.train(print_fn=quiet).final_loss
    tr = StreamTrainer(dataclasses.replace(cfg, balance_every=1), ds,
                       build_model("gcn", [12, 16, 5], 0.0),
                       bounds=bounds)
    assert tr.balancer is not None
    tr.balancer.probe = lambda part, **_: [
        2e-9 * float(e) + 1e-6 for e in part.num_edges_valid]
    got = tr.train(print_fn=quiet)
    acts = [ev["action"] for ev in got.rebalance_events]
    assert "reshard" in acts, acts
    assert not np.array_equal(np.asarray(tr.part.bounds), bounds)
    assert abs(got.final_loss - want) < 1e-3 * max(abs(want), 1.0)
    ref.close()
    tr.close()
