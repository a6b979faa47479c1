"""The port's vertex reordering (roc_tpu_torch/graph/reorder.py) and the
``-file``/``-lazy``/``-reorder`` CLI, against roc_tpu: ``rcm_order``
element-equal to roc_tpu's NumPy path, ``permute_csr`` and
``reorder_dataset`` equal, the occupancy count equal to
``padded_rows_for(..., GEOM_MID)``, ``auto``'s decision and note equal,
training on a reordered graph isomorphic (final loss within 2e-4
relative, fp32 reassociation), and the flags parsed as roc_tpu parses
them."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.graph import reorder as jreorder
from roc_tpu.graph.csr import Csr as JCsr
from roc_tpu.ops.pallas.binned import GEOM_MID, padded_rows_for
from roc_tpu.train.config import parse_args as jparse_args
from roc_tpu_torch.graph import convert, datasets, lux, reorder
from roc_tpu_torch.graph.csr import add_self_edges, from_edges
from roc_tpu_torch.graph.datasets import Dataset
from roc_tpu_torch.models import build_model
from roc_tpu_torch.train.config import Config, parse_args
from roc_tpu_torch.train.driver import Trainer

ROOT = Path(__file__).resolve().parents[1]


def _jcsr(g):
    return JCsr(g.num_nodes, g.num_edges, g.row_ptr, g.col_idx)


def _community_graph(n, q, e, seed, shuffle=True):
    """Community-structured edges over n nodes (communities of q), ids
    shuffled: tests/test_reorder.py's fixture."""
    rng = np.random.default_rng(seed)
    k = n // q
    comm = rng.integers(0, k, e) * q
    src = comm + rng.integers(0, q, e)
    dst = comm + rng.integers(0, q, e)
    if shuffle:
        relabel = rng.permutation(n)
        src, dst = relabel[src], relabel[dst]
    keep = src != dst
    return add_self_edges(from_edges(n, src[keep], dst[keep]))


def _uniform_graph(n, e, seed):
    rng = np.random.default_rng(seed)
    return add_self_edges(from_edges(n, rng.integers(0, n, e),
                                     rng.integers(0, n, e)))


def _isolated_graph():
    """A triangle among 10 nodes: 7 vertices with a self edge only."""
    return add_self_edges(from_edges(10, np.array([0, 1, 2]),
                                     np.array([1, 2, 0])))


GRAPHS = {
    "cora": lambda: datasets.get("cora", seed=1).graph,
    "ring": lambda: datasets.synthetic(
        "r", 3000, 6.0, 4, 8, n_train=10, n_val=10, n_test=10, seed=2,
        inter_mode="ring").graph,
    "lesmis": lambda: convert.les_miserables().graph,
    "isolated": _isolated_graph,
    "directed": lambda: from_edges(50, np.arange(49), np.arange(1, 50)),
    "empty": lambda: from_edges(0, np.zeros(0, np.int64),
                                np.zeros(0, np.int64)),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_rcm_order_equals_roc_tpu(name):
    g = GRAPHS[name]()
    order = reorder.rcm_order(g)
    want = jreorder.rcm_order(_jcsr(g), use_native=False)
    assert order.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(order, want)
    assert sorted(order) == list(range(g.num_nodes))


@pytest.mark.parametrize("name", ["cora", "isolated", "empty"])
def test_permute_csr_equals_roc_tpu(name):
    g = GRAPHS[name]()
    order = reorder.rcm_order(g)
    gp = reorder.permute_csr(g, order)
    jp = jreorder.permute_csr(_jcsr(g), order)
    gp.validate()
    np.testing.assert_array_equal(gp.row_ptr, jp.row_ptr)
    np.testing.assert_array_equal(gp.col_idx, jp.col_idx)
    assert gp.col_idx.dtype == jp.col_idx.dtype


def test_reorder_dataset_equals_roc_tpu():
    ds = datasets.synthetic("ro", 500, 6.0, 12, 4, n_train=150, n_val=100,
                            n_test=100, seed=7)
    jds = jdatasets.synthetic("ro", 500, 6.0, 12, 4, n_train=150, n_val=100,
                              n_test=100, seed=7)
    got, order = reorder.reorder_dataset(ds)
    want, jorder = jreorder.reorder_dataset(jds)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(got.graph.col_idx, want.graph.col_idx)
    np.testing.assert_array_equal(got.graph.row_ptr, want.graph.row_ptr)
    for f in ("features", "labels", "label_ids", "mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


OCCUPANCY = {
    "community": lambda: _community_graph(4096, 256, 30_000, seed=0),
    "uniform": lambda: _uniform_graph(4096, 20_000, seed=1),
    "cora": GRAPHS["cora"],
    "isolated": _isolated_graph,
    # > 2^20 cells and > 4 E keys: the sparse np.unique count
    "sparse_table": lambda: from_edges(600_000, np.arange(0, 600_000, 997),
                                       np.arange(599_999, -1, -997)),
}


@pytest.mark.parametrize("name", list(OCCUPANCY))
def test_padded_rows_equal_roc_tpu(name):
    g = OCCUPANCY[name]()
    want = padded_rows_for(g.col_idx.astype(np.int64),
                           g.dst_idx.astype(np.int64), GEOM_MID)
    assert reorder.padded_rows(g) == want
    if name == "sparse_table":
        blocks = int(g.col_idx.max()) // 512 + 1
        bins = int(g.dst_idx.max()) // 512 + 1
        assert blocks * bins > max(4 * g.num_edges, 1 << 20)


def _wrap(g, seed):
    rng = np.random.default_rng(seed)
    return Dataset(name="m", graph=g,
                   features=rng.normal(size=(g.num_nodes, 4)).astype(
                       np.float32),
                   labels=None, label_ids=np.zeros(g.num_nodes, np.int64),
                   mask=np.zeros(g.num_nodes, np.int32), in_dim=4,
                   num_classes=2)


# tests/test_reorder.py:111's fixtures: an id-shuffled community graph
# (kept) and a uniform one (skipped)
AUTO = {"kept": lambda: _community_graph(32768, 256, 150_000, seed=8),
        "skipped": lambda: _uniform_graph(4096, 20_000, seed=9)}


@pytest.mark.parametrize("case", list(AUTO))
def test_auto_decides_as_roc_tpu(case):
    ds = _wrap(AUTO[case](), 3)
    got, applied, note = reorder.maybe_reorder_dataset(ds, "auto")
    jds = jdatasets.Dataset(**{f: getattr(ds, f) for f in (
        "name", "features", "labels", "label_ids", "mask", "in_dim",
        "num_classes")}, graph=_jcsr(ds.graph))
    want, japplied, jnote = jreorder.maybe_reorder_dataset(jds, "auto")
    assert (applied, note) == (japplied, jnote)
    assert applied == (case == "kept") and case in note
    if applied:
        np.testing.assert_array_equal(got.graph.col_idx, want.graph.col_idx)
        np.testing.assert_array_equal(got.features, want.features)
    else:
        assert got is ds
    off = reorder.maybe_reorder_dataset(ds, "off")
    assert off == (ds, False, "")
    with pytest.raises(ValueError, match="on|off|auto"):
        reorder.maybe_reorder_dataset(ds, "always")


@pytest.mark.parametrize("model,backend", [("gcn", "xla"),
                                           ("gcn", "binned"),
                                           ("gat", "binned")])
def test_reordered_dataset_trains_isomorphically(model, backend):
    """The same losses, up to fp32 reassociation, with and without the
    order: features, labels and masks move with their vertices (and the
    kernel backend's plain versions, GAT's edge map included, take rows
    that are not sorted)."""
    ds = datasets.synthetic("ro", 500, 6.0, 12, 4, n_train=150, n_val=100,
                            n_test=100, seed=7)
    dsr, _ = reorder.reorder_dataset(ds)
    assert any(np.any(np.diff(dsr.graph.col_idx[a:b]) < 0) for a, b in
               zip(dsr.graph.row_ptr[:-1], dsr.graph.row_ptr[1:]))
    layers = [12, 8, 4]
    cfg = dict(layers=layers, num_epochs=3, dropout_rate=0.0,
               eval_every=10**9, seed=3, device="cpu", model=model,
               heads=2, aggregate_backend=backend,
               aggregate_precision="exact")
    t0 = Trainer(Config(**cfg), ds, build_model(model, layers, 0.0,
                                                heads=2))
    t1 = Trainer(Config(**cfg), dsr, build_model(model, layers, 0.0,
                                                 heads=2))
    for i in range(3):
        l0, l1 = float(t0.run_epoch()), float(t1.run_epoch())
        np.testing.assert_allclose(l1, l0, rtol=2e-4, err_msg=f"epoch {i}")


def test_edge_map_of_a_reordered_graph():
    """``DeviceCsr``'s transpose and edge map on rows that are not sorted:
    forward edge e (u -> v) is transposed edge t_pos[e], in row u, with
    destination v."""
    from roc_tpu_torch.ops import DeviceCsr
    g = reorder.permute_csr(GRAPHS["cora"](),
                            reorder.rcm_order(GRAPHS["cora"]()))
    csr = DeviceCsr.from_csr(g, "cpu", edge_map=True)
    t_pos = csr.t_pos.numpy()
    assert sorted(t_pos) == list(range(g.num_edges))
    t_row = np.searchsorted(csr.t_row_ptr.numpy(), t_pos, side="right") - 1
    np.testing.assert_array_equal(t_row, g.col_idx)
    np.testing.assert_array_equal(csr.t_col_idx.numpy()[t_pos], g.dst_idx)


# -- the CLI ---------------------------------------------------------------------

NEW_FLAGS = [[], ["-file", "data/x"], ["-file", "p", "-lazy"],
             ["-reorder"], ["-reorder", "auto"], ["-reorder", "off"],
             ["-lazy", "-reorder", "on", "-file", "q"]]


@pytest.mark.parametrize("argv", NEW_FLAGS, ids=lambda a: " ".join(a) or "-")
def test_parse_args_matches_roc_tpu_for_the_new_flags(argv):
    ours, ref = parse_args(argv), jparse_args(argv)
    for f in ("filename", "lazy_load", "reorder", "dataset"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert Config().reorder == "off" and Config().filename == ""


def test_parse_args_refuses_a_bad_reorder():
    with pytest.raises(SystemExit):
        parse_args(["-reorder", "sometimes"])


def _cli(*args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "roc_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


_INFER = re.compile(r"^\t\[INFER\]\[\d+\] train_loss: ")


@pytest.fixture(scope="module")
def lesmis_prefix(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("lesmis") / "lesmis")
    ds = convert.les_miserables()
    lux.write_dataset(prefix, ds.graph, ds.features, ds.label_ids, ds.mask)
    return prefix


def test_cli_file_lazy_prints_what_eager_prints(lesmis_prefix):
    base = ["-file", lesmis_prefix, "-layers", "77-16-5", "-e", "20",
            "-device", "cpu"]
    eager, lazy = _cli(*base), _cli(*base, "-lazy")
    assert eager.returncode == 0, eager.stderr
    assert lazy.returncode == 0, lazy.stderr
    lines = eager.stdout.splitlines()
    assert len(lines) == 4 and all(_INFER.match(ln) for ln in lines)
    assert lazy.stdout == eager.stdout
    assert f"dataset = {lesmis_prefix} seed = 1" in eager.stderr
    assert "Warning" not in lazy.stderr


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_cli_reorder(lesmis_prefix, mode):
    proc = _cli("-file", lesmis_prefix, "-layers", "77-16-5", "-e", "6",
                "-device", "cpu", "-reorder", mode)
    assert proc.returncode == 0, proc.stderr
    note = {"on": "# RCM locality reorder applied (77 nodes, ",
            "auto": "# RCM locality reorder skipped: padded rows"}[mode]
    assert note in proc.stderr
    assert [_INFER.match(ln) is not None
            for ln in proc.stdout.splitlines()] == [True, True]


def test_cli_file_needs_a_gpu_or_device_cpu(lesmis_prefix):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default legitimately runs there")
    proc = _cli("-file", lesmis_prefix, "-layers", "77-16-5", "-e", "2")
    assert proc.returncode != 0 and "INFER" not in proc.stdout
    assert "-device cpu" in proc.stderr


def test_cli_needs_file_or_dataset():
    proc = _cli("-layers", "77-16-5", "-device", "cpu")
    assert proc.returncode == 2
    assert "one of -file or -dataset is required" in proc.stderr
    bad = _cli("-dataset", "lesmis", "-layers", "77-16-4", "-device", "cpu")
    assert bad.returncode == 2 and "-layers tail 4" in bad.stderr


def test_vendored_graph_loads_by_name_in_the_cli():
    proc = _cli("-dataset", "davis", "-layers", "32-16-2", "-e", "1",
                "-device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "test_accuracy: " in proc.stdout and "/16)" in proc.stdout
