"""The port's converters (roc_tpu_torch/graph/convert.py, the CLI
``python -m roc_tpu_torch.graph``) against roc_tpu's (graph/convert.py,
tools/convert.py) on the fixtures of tests/test_convert.py: every front end
and error equal field by field, the vendored real graphs equal, the CLI's
files byte-equal, and the golden curves of docs/GOLDEN.md on the port's
CPU trainer.

Tolerances: the converters and files are exact.  The karate trainer from
roc_tpu's initial parameters (dropout 0, xla, exact) stays within 1e-3 of
roc_tpu's loss and of each logits row's max-abs after 20 epochs (fp32
sums and GEMMs in another order)."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from roc_tpu.graph import convert as jconvert
from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild_model
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import Trainer as JTrainer
from roc_tpu_torch.graph import convert, datasets, lux
from roc_tpu_torch.graph.__main__ import main as convert_main
from roc_tpu_torch.models import build_model
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer

ROOT = Path(__file__).resolve().parents[1]


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _assert_same(a, b):
    """Two datasets (the port's and roc_tpu's) equal field by field."""
    assert a.name == b.name
    assert (a.graph.num_nodes, a.graph.num_edges) == \
        (b.graph.num_nodes, b.graph.num_edges)
    np.testing.assert_array_equal(a.graph.row_ptr, b.graph.row_ptr)
    np.testing.assert_array_equal(a.graph.col_idx, b.graph.col_idx)
    for f in ("features", "labels", "label_ids", "mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.in_dim, a.num_classes) == (b.in_dim, b.num_classes)


# -- front ends: (name, fixture files, call(mod, d)) -------------------------

def _edges_basic(d):
    _write(d / "g.txt", "# comment\n0 1\n1 2\n2,0\n\n")


def _edges_dup(d):
    _write(d / "g.txt", "0 1\n1 0\n0 1\n1 2\n")


def _edges_sidecars(d):
    _write(d / "g.txt", "0 1\n1 2\n3 0\n")
    _write(d / "f.csv", "1,0\n0,1\n1,1\n0,0\n")
    _write(d / "l.txt", "0\n1\n1\n0\n")


def _edges_self_loop(d):
    _write(d / "g.txt", "2 2\n0 1\n")


def _edges_masks(d):
    _write(d / "g.txt", "0 1\n1 2\n2 3\n3 4\n")
    _write(d / "m.mask", "Train\nVal\nTest\nNone\nTrain\n")
    _write(d / "m.txt", "0\n0\n1\n2\n3\n")


def _ogb(d):
    root = d / "raw"
    (root / "split").mkdir(parents=True)
    _write(root / "edge.csv", "0,1\n1,2\n2,3\n")
    _write(root / "node-feat.csv", "1,0\n0,1\n1,1\n0,0\n")
    _write(root / "node-label.csv", "0\n1\n1\n0\n")
    _write(root / "split" / "train.csv", "0\n1\n")
    _write(root / "split" / "valid.csv", "2\n")
    _write(root / "split" / "test.csv", "3\n")


def _ogb_bare(d):
    (d / "raw").mkdir()
    _write(d / "raw" / "edge.csv", "0,1\n1,2\n2,3\n4,0\n")


def _mtx(d):
    _write(d / "g.mtx", "%%MatrixMarket matrix coordinate pattern symmetric\n"
           "% a comment\n4 4 3\n2 1\n3 2\n4 1\n")


def _mtx_general(d):
    _write(d / "g.mtx", "%%MATRIXMARKET Matrix Coordinate Real General\n"
           "5 5 4\n1 2 1.0\n2 3 0.5\n5 4 2\n3 1 1\n")
    _write(d / "l.txt", "0\n1\n2\n1\n0\n")


FRONT_ENDS = [
    ("edges_basic", _edges_basic,
     lambda m, d: m.from_edge_list(str(d / "g.txt"))),
    ("edges_undirected_dedup", _edges_dup,
     lambda m, d: m.from_edge_list(str(d / "g.txt"), undirected=True,
                                   self_edges=False)),
    ("edges_sidecars_split", _edges_sidecars,
     lambda m, d: m.from_edge_list(
         str(d / "g.txt"), feats_path=str(d / "f.csv"),
         labels_path=str(d / "l.txt"), split=(2, 1, 1), seed=0)),
    ("edges_keep_self_loop", _edges_self_loop,
     lambda m, d: m.from_edge_list(str(d / "g.txt"), undirected=True,
                                   self_edges=False)),
    ("edges_num_nodes", _edges_basic,
     lambda m, d: m.from_edge_list(str(d / "g.txt"), num_nodes=7, seed=3)),
    ("edges_mask_file", _edges_masks,
     lambda m, d: m.from_edge_list(str(d / "g.txt"),
                                   mask_path=str(d / "m.mask"))),
    ("edges_mask_ints", _edges_masks,
     lambda m, d: m.from_edge_list(str(d / "g.txt"),
                                   mask_path=str(d / "m.txt"))),
    ("ogb", _ogb, lambda m, d: m.from_ogb_dir(str(d / "raw"))),
    ("ogb_directed_bare", _ogb_bare,
     lambda m, d: m.from_ogb_dir(str(d / "raw"), undirected=False, seed=2)),
    ("mtx_symmetric", _mtx, lambda m, d: m.from_mtx(str(d / "g.mtx"))),
    ("mtx_general", _mtx_general,
     lambda m, d: m.from_mtx(str(d / "g.mtx"), labels_path=str(d / "l.txt"),
                             undirected=True, split=(3, 1, 1), seed=5)),
]


@pytest.mark.parametrize("name,make,call", FRONT_ENDS,
                         ids=[f[0] for f in FRONT_ENDS])
def test_front_end_matches_roc_tpu(tmp_path, name, make, call):
    make(tmp_path)
    _assert_same(call(convert, tmp_path), call(jconvert, tmp_path))


def _err_out_of_range(d):
    _write(d / "g.txt", "0 7\n")
    return lambda m: m.from_edge_list(str(d / "g.txt"), num_nodes=4)


def _err_negative_endpoint(d):
    _write(d / "g.txt", "5 -1\n0 1\n")
    return lambda m: m.from_edge_list(str(d / "g.txt"), num_nodes=10,
                                      undirected=True)


def _err_negative_label(d):
    _write(d / "g.txt", "0 1\n1 2\n")
    _write(d / "l.txt", "0\n-1\n1\n")
    return lambda m: m.from_edge_list(str(d / "g.txt"),
                                      labels_path=str(d / "l.txt"))


def _err_identity_too_big(d):
    return lambda m: m._finish("big", 70000, np.zeros(0, np.int64),
                               np.zeros(0, np.int64), None, None, None,
                               undirected=False, self_edges=False)


def _err_truncated_mtx(d):
    _write(d / "g.mtx", "%%MatrixMarket matrix coordinate pattern general\n"
           "4 4 3\n2 1\n3 2\n")
    return lambda m: m.from_mtx(str(d / "g.mtx"))


def _err_mtx_header(d):
    _write(d / "g.mtx", "not a header\n1 1 0\n")
    return lambda m: m.from_mtx(str(d / "g.mtx"))


def _err_edge_line(d):
    _write(d / "g.txt", "0 1\n3\n")
    return lambda m: m.from_edge_list(str(d / "g.txt"))


def _err_unknown_mask(d):
    _write(d / "g.txt", "0 1\n1 2\n")
    _write(d / "m.mask", "Train\nHoldout\nTest\n")
    return lambda m: m.from_edge_list(str(d / "g.txt"),
                                      mask_path=str(d / "m.mask"))


def _err_split_too_small(d):
    return lambda m: m.stratified_split(np.array([0, 0, 1]), 4, 0, 0)


ERRORS = [(_err_out_of_range, "out of range"),
          (_err_negative_endpoint, "out of range"),
          (_err_negative_label, "negative label"),
          (_err_identity_too_big, "identity features"),
          (_err_truncated_mtx, "truncated"),
          (_err_mtx_header, "MatrixMarket"),
          (_err_edge_line, "need 'src dst'"),
          (_err_unknown_mask, "Unrecognized mask"),
          (_err_split_too_small, "exceeds labeled nodes|larger than")]


@pytest.mark.parametrize("make,match", ERRORS,
                         ids=[e[0].__name__[5:] for e in ERRORS])
def test_errors_match_roc_tpu(tmp_path, make, match):
    call = make(tmp_path)
    with pytest.raises(ValueError, match=match):
        call(convert)
    with pytest.raises((ValueError, AssertionError)):
        call(jconvert)


@pytest.mark.parametrize("seed", [0, 3])
def test_stratified_split_matches_roc_tpu(seed):
    ids = np.array([0] * 50 + [1] * 30 + [2] * 20)
    mask = convert.stratified_split(ids, 6, 10, 20, seed=seed)
    np.testing.assert_array_equal(
        mask, jconvert.stratified_split(ids, 6, 10, 20, seed=seed))
    assert set(np.unique(ids[mask == lux.MASK_TRAIN])) == {0, 1, 2}


REAL = [("karate", "karate_club", 34, 2 * 78 + 34),
        ("davis", "davis_women", 32, 2 * 89 + 32),
        ("lesmis", "les_miserables", 77, 2 * 254 + 77)]


@pytest.mark.parametrize("name,ctor,nodes,edges", REAL,
                         ids=[r[0] for r in REAL])
def test_vendored_graph_matches_roc_tpu(name, ctor, nodes, edges):
    """The data/ directory resolves from the port's module too, and the
    graph equals roc_tpu's directly and through ``datasets.get``."""
    assert os.path.samefile(convert._VENDOR_DIR, jconvert._VENDOR_DIR)
    ds = getattr(convert, ctor)()
    assert (ds.graph.num_nodes, ds.graph.num_edges) == (nodes, edges)
    _assert_same(ds, getattr(jconvert, ctor)())
    _assert_same(datasets.get(name, seed=5), jdatasets.get(name))
    assert name in datasets.names()


# -- the converter CLI ---------------------------------------------------------

def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "_roc_tpu_convert_cli", ROOT / "tools" / "convert.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _same_files(a: Path, b: Path):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    return names


@pytest.mark.parametrize("cmd", ["karate", "lesmis"])
def test_cli_output_is_byte_equal_to_tools_convert(tmp_path, cmd):
    jmain = _jax_cli()
    assert jmain([cmd, "-o", str(tmp_path / "jax" / "g")]) == 0
    if cmd == "karate":     # once through ``python -m``
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "-m", "roc_tpu_torch.graph", cmd, "-o",
             str(tmp_path / "port" / "g")], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "python -m roc_tpu_torch -file" in proc.stderr
    else:
        assert convert_main([cmd, "-o", str(tmp_path / "port" / "g")]) == 0
    assert _same_files(tmp_path / "port", tmp_path / "jax") == [
        "g.add_self_edge.lux", "g.feats.bin", "g.feats.csv", "g.label",
        "g.mask"]


def test_cli_rocfile_reorder_with_transpose_is_byte_equal(tmp_path):
    """rocfile --reorder --with-transpose: the RCM pass over an on-disk
    dataset, written with its transposed sidecar; then a plain rewrite to
    the same prefix refreshes the stale sidecar in both tools."""
    jmain = _jax_cli()
    for tool, run in (("port", convert_main), ("jax", jmain)):
        d = tmp_path / tool
        assert run(["lesmis", "-o", str(d / "in" / "a")]) == 0
        assert run(["rocfile", "--file", str(d / "in" / "a"), "--in-dim",
                    "77", "--classes", "5", "-o", str(d / "out" / "b"),
                    "--reorder", "--with-transpose"]) == 0
    names = _same_files(tmp_path / "port" / "out", tmp_path / "jax" / "out")
    assert "b" + lux.TLUX_SUFFIX in names
    a = lux.read_lux(str(tmp_path / "port" / "in" / "a") + lux.LUX_SUFFIX)
    b = lux.read_lux(str(tmp_path / "port" / "out" / "b") + lux.LUX_SUFFIX)
    assert a.num_edges == b.num_edges
    assert not np.array_equal(a.col_idx, b.col_idx)
    for tool, run in (("port", convert_main), ("jax", jmain)):
        d = tmp_path / tool
        assert run(["lesmis", "-o", str(d / "out" / "b")]) == 0
    _same_files(tmp_path / "port" / "out", tmp_path / "jax" / "out")
    t = lux.read_lux(str(tmp_path / "port" / "out" / "b") + lux.TLUX_SUFFIX)
    np.testing.assert_array_equal(t.col_idx, a.transpose().col_idx)


def test_cli_reorder_auto_and_edgelist(tmp_path, capsys):
    _write(tmp_path / "g.txt", "0 1\n1 2\n2 3\n3 0\n4 5\n")
    _write(tmp_path / "l.txt", "0\n1\n0\n1\n0\n1\n")
    args = ["edgelist", "--edges", str(tmp_path / "g.txt"), "--labels",
            str(tmp_path / "l.txt"), "--undirected", "--split", "2,2,2",
            "--seed", "4", "--reorder", "auto"]
    assert convert_main(args + ["-o", str(tmp_path / "port" / "e")]) == 0
    assert "# RCM locality reorder skipped" in capsys.readouterr().err
    assert _jax_cli()(args + ["-o", str(tmp_path / "jax" / "e")]) == 0
    _same_files(tmp_path / "port", tmp_path / "jax")
    with pytest.raises(SystemExit):
        convert_main(["edgelist", "--edges", str(tmp_path / "g.txt"),
                      "--split", "1,2", "-o", str(tmp_path / "x")])


# -- the golden curves (docs/GOLDEN.md) on the port's CPU trainer ------------

# name -> (layers, epochs): the recipe -lr 0.01 -decay 0.0005 -dropout 0.5
# at the default seed 1
GOLDEN = {"karate": ([34, 16, 2], 100), "davis": ([32, 16, 2], 100),
          "lesmis": ([77, 16, 5], 200)}


def _golden_run(name):
    ds = datasets.get(name)
    layers, epochs = GOLDEN[name]
    cfg = Config(layers=layers, num_epochs=epochs, learning_rate=0.01,
                 weight_decay=5e-4, dropout_rate=0.5, eval_every=10**9,
                 device="cpu")
    tr = Trainer(cfg, ds, build_model("gcn", layers, 0.5, "sum"))
    tr.train(print_fn=lambda *a: None)
    pred = tr.predict_logits().argmax(-1).numpy()
    return ds, tr.evaluate(), pred


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_curve_on_the_port(name):
    """karate: test 31/32, node 8 the sole miss (Zachary's own model's
    miss); davis: 15/16, node 15 (Dorothy Murchison) the sole miss;
    lesmis: val >= 13/19, test >= 43/48, train loss <= 1.0."""
    ds, m, pred = _golden_run(name)
    if name == "karate":
        assert (int(m.test_correct), int(m.test_all)) == (31, 32)
        assert list(np.nonzero(pred != ds.label_ids)[0]) == [8]
    elif name == "davis":
        assert (int(m.test_correct), int(m.test_all)) == (15, 16)
        women = np.arange(18)
        assert list(women[pred[:18] != ds.label_ids[:18]]) == [15]
    else:
        assert int(m.val_correct) >= 13 and int(m.val_all) == 19
        assert int(m.test_correct) >= 43 and int(m.test_all) == 48
        assert float(m.train_loss) <= 1.0


def test_karate_trainer_tracks_roc_tpu():
    """20 epochs from roc_tpu's initial parameters (dropout 0, xla, exact):
    loss and logits within 1e-3."""
    base = dict(layers=[34, 16, 2], num_epochs=20, learning_rate=0.01,
                weight_decay=5e-4, dropout_rate=0.0, eval_every=10**9,
                aggregate_backend="xla", aggregate_precision="exact")
    jtr = JTrainer(JConfig(**base), jconvert.karate_club(),
                   jbuild_model("gcn", base["layers"], 0.0, "sum"))
    tr = Trainer(Config(device="cpu", **base), convert.karate_club(),
                 build_model("gcn", base["layers"], 0.0, "sum"))
    tr.params = checkpoint.params_from_jax(
        {k: np.asarray(v) for k, v in jtr.params.items()}, "cpu")
    tr.opt_state = checkpoint.opt_state_from_jax(
        jax.device_get(jtr.opt_state), "cpu")
    jloss = jtr.train(print_fn=lambda *a: None).final_loss
    loss = tr.train(print_fn=lambda *a: None).final_loss
    want = np.asarray(jtr.predict_logits(), np.float64)
    got = tr.predict_logits().numpy().astype(np.float64)
    row = (np.abs(got - want).max(1) / np.abs(want).max(1)).max()
    print(f"karate, 20 epochs: loss {abs(loss - jloss) / abs(jloss):.2e} "
          f"relative, logits {row:.2e} of the row max-abs")
    assert abs(loss - jloss) <= 1e-3 * abs(jloss)
    assert row <= 1e-3
