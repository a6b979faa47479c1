"""The port's host graph builders in C++ (roc_tpu_torch/native) against
their NumPy twins and against roc_tpu (tests/test_native.py's checks, on
the port's entry points).

Every comparison is element-equal (the builders reorder nothing that the
NumPy paths do not): the `.lux` reads and slices, cut, CSV values (on
``np.loadtxt``'s grammar: comments, blank lines, whitespace, Python's float
spellings), transpose and edge map, RCM order and halo maps.  The >= 2^20-edge cases
take the paths roc_tpu gates by that threshold (transpose, RCM).  A
failed build raises, with no fallback; ``ROC_TPU_NO_NATIVE=1`` alone
selects the NumPy paths.
"""

import os

import numpy as np
import pytest
import torch

from roc_tpu.graph import lux as jlux
from roc_tpu.graph import reorder as jreorder
from roc_tpu.graph.csr import Csr as JCsr
from roc_tpu.graph.partition import _python_bounds as j_python_bounds
from roc_tpu.graph.partition import bounds_from_row_ptr as jbounds
from roc_tpu.graph.partition import partition_graph as jpartition
from roc_tpu.parallel import halo as jhalo
from roc_tpu_torch import native
from roc_tpu_torch.graph import datasets, lux, reorder
from roc_tpu_torch.graph.csr import (NATIVE_MIN_EDGES, Csr, add_self_edges,
                                     from_edges)
from roc_tpu_torch.graph.partition import (_python_bounds,
                                           bounds_from_row_ptr,
                                           partition_graph)
from roc_tpu_torch.models import build_model
from roc_tpu_torch.ops.aggregate import DeviceCsr
from roc_tpu_torch.parallel import halo
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import Trainer


@pytest.fixture(scope="module")
def ds():
    return datasets.synthetic("t", 300, 4.0, 10, 4, n_train=60, n_val=60,
                              n_test=60, seed=51)


@pytest.fixture(scope="module")
def big():
    """A graph past roc_tpu's native threshold (>= 2^20 edges) with a hub
    source, isolated vertices and self-edges."""
    rng = np.random.default_rng(17)
    n, e = 60_000, 1_060_000
    src = rng.integers(0, n - 50, e)
    dst = rng.integers(0, n - 50, e)
    src[:20_000] = 7
    g = add_self_edges(from_edges(n, src, dst))
    assert g.num_edges >= NATIVE_MIN_EDGES
    return g


@pytest.fixture
def no_native(monkeypatch):
    """ROC_TPU_NO_NATIVE=1, with the library made unreachable: anything
    that still calls it fails the test."""
    monkeypatch.setenv("ROC_TPU_NO_NATIVE", "1")

    def refuse():
        raise AssertionError("the native library ran under "
                             "ROC_TPU_NO_NATIVE=1")
    monkeypatch.setattr(native, "lib", refuse)


def _jcsr(g):
    return JCsr(g.num_nodes, g.num_edges, g.row_ptr, g.col_idx)


def _numpy(monkeypatch, fn, *a, **k):
    """``fn`` under ROC_TPU_NO_NATIVE=1 (the NumPy twin)."""
    with monkeypatch.context() as m:
        m.setenv("ROC_TPU_NO_NATIVE", "1")
        return fn(*a, **k)


def test_build_is_hashed_cached_and_loads():
    from roc_tpu_torch.ops.kernels.build import BUILD_DIR, source_key
    L = native.lib()
    path = native.build()
    assert path.parent == BUILD_DIR
    assert path.name == (f"libroc_native_"
                         f"{source_key(native.SOURCE, native.GXX_FLAGS)}.so")
    assert path.exists() and native.info["cached"]
    assert native.lib() is L
    for sym in ("roc_lux_header", "roc_lux_read_slice", "roc_partition",
                "roc_parse_feats_csv", "roc_halo_sizes", "roc_halo_fill",
                "roc_rcm_order", "roc_csr_transpose"):
        assert hasattr(L, sym), sym


def test_failed_build_raises_with_no_fallback(tmp_path, monkeypatch, ds):
    bad = tmp_path / "broken.cc"
    bad.write_text('extern "C" int roc_lux_header( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "broken.cc" in str(e.value) and "error" in str(e.value)
    # a library that cannot build is an error at the call site, not a
    # silent NumPy run
    path = str(tmp_path / "g") + lux.LUX_SUFFIX
    lux.write_lux(path, ds.graph)
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        lux.read_lux(path)
    # ...and the switch still selects the NumPy read
    monkeypatch.setenv("ROC_TPU_NO_NATIVE", "1")
    assert np.array_equal(lux.read_lux(path).col_idx, ds.graph.col_idx)


def test_lux_roundtrip_bytes_equal_roc_tpu(ds, tmp_path):
    g = ds.graph
    ours, ref = (str(tmp_path / n) + lux.LUX_SUFFIX for n in ("port", "jax"))
    lux.write_lux(ours, g)
    jlux.write_lux(ref, _jcsr(g))
    assert open(ours, "rb").read() == open(ref, "rb").read()
    assert native.lux_header(ours) == (g.num_nodes, g.num_edges)
    rows, cols = native.lux_read_slice(ours, 0, g.num_nodes, 0, g.num_edges)
    assert rows.dtype == np.uint64 and cols.dtype == np.uint32
    np.testing.assert_array_equal(rows.astype(np.int64), g.row_ptr[1:])
    np.testing.assert_array_equal(cols.astype(np.int32), g.col_idx)
    got = lux.read_lux(ours)                 # the native reads
    want = jlux.read_lux(ours)
    for f in ("row_ptr", "col_idx"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_lux_slices_equal_numpy_reads(ds, tmp_path, monkeypatch):
    path = str(tmp_path / "g") + lux.LUX_SUFFIX
    g = ds.graph
    lux.write_lux(path, g)
    lo, hi = 57, 203
    e0, e1 = int(g.row_ptr[lo]), int(g.row_ptr[hi])
    rows, cols = native.lux_read_slice(path, lo, hi, e0, e1)
    np.testing.assert_array_equal(rows.astype(np.int64),
                                  g.row_ptr[1 + lo:1 + hi])
    np.testing.assert_array_equal(cols.astype(np.int32), g.col_idx[e0:e1])
    for fn, args in ((lux.read_header, (path,)),
                     (lux.read_rows_slice, (path, lo, hi)),
                     (lux.read_cols_slice, (path, g.num_nodes, e0, e1))):
        got, want = fn(*args), _numpy(monkeypatch, fn, *args)
        assert np.array_equal(np.asarray(got), np.asarray(want)), fn
        assert np.asarray(got).dtype == np.asarray(want).dtype
    # the range checks run before any read, natively as in NumPy
    with pytest.raises(ValueError, match="runs past the end"):
        lux.read_rows_slice(path, 0, g.num_nodes + 1)
    with pytest.raises(ValueError, match="invalid"):
        lux.read_cols_slice(path, g.num_nodes, 5, 4)


def test_partition_equals_numpy_and_roc_tpu(ds, monkeypatch):
    g = ds.graph
    # a hub row takes a part of its own: the cut yields fewer than P parts
    # and the repair splits the rest
    skew = from_edges(50, np.r_[np.zeros(400, int), np.arange(50)],
                      np.r_[np.zeros(400, int), np.arange(50)])
    for graph in (g, skew):
        for parts in (1, 2, 4, 7):
            n, nb = native.partition(graph.row_ptr[1:], graph.num_edges,
                                     parts)
            py = _python_bounds(graph.row_ptr, parts)
            assert py == j_python_bounds(graph.row_ptr, parts)
            assert n == len(py)
            assert [tuple(b) for b in nb] == py
            got = bounds_from_row_ptr(graph.row_ptr, parts)
            assert got == _numpy(monkeypatch, bounds_from_row_ptr,
                                 graph.row_ptr, parts)
            assert got == [tuple(b) for b in jbounds(graph.row_ptr, parts)]
            assert len(got) == parts


@pytest.mark.parametrize("edge_cap_of", [1, 3, 50])
def test_partition_writes_every_part(ds, edge_cap_of):
    """A cut that yields more parts than asked (an edge count below the
    rows', so a small cap) comes back whole: the second call is sized by
    the first's count."""
    raw = ds.graph.row_ptr[1:]
    num_edges = ds.graph.num_edges // edge_cap_of // 4
    n, nb = native.partition(raw, num_edges, 4)
    cap, want, cnt, left = -(-num_edges // 4), [], 0, 0
    for v, d in enumerate(np.diff(ds.graph.row_ptr)):
        cnt += int(d)
        if cnt > cap:
            want.append((left, v))
            cnt, left = 0, v + 1
    if cnt > 0 or left < len(raw):
        want.append((left, len(raw) - 1))
    assert n == len(want) > 4
    assert [tuple(int(v) for v in b) for b in nb] == want


def test_feature_csv_equals_numpy_and_roc_tpu(ds, tmp_path, monkeypatch):
    prefix = str(tmp_path / "d")
    feats = np.random.default_rng(3).standard_normal(
        ds.features.shape).astype(np.float32) * 1e3
    np.savetxt(prefix + ".feats.csv", feats, delimiter=",", fmt="%.9g")
    n, d = feats.shape
    got = native.parse_feats_csv(prefix + ".feats.csv", n, d)
    want = np.loadtxt(prefix + ".feats.csv", delimiter=",", dtype=np.float32,
                      ndmin=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, feats)          # %.9g round-trips
    np.testing.assert_array_equal(lux.load_features(prefix, n, d), feats)
    os.remove(prefix + ".feats.bin")
    np.testing.assert_array_equal(
        _numpy(monkeypatch, lux.load_features, prefix, n, d), feats)
    os.remove(prefix + ".feats.bin")
    np.testing.assert_array_equal(jlux.load_features(prefix, n, d), feats)


@pytest.mark.parametrize("text,rows", [
    ("1.0,,2.0\n3,4,5\n", 2), ("1.0,2.0\n3,4,5\n", 2),
    ("1,2,3,9\n4,5,6\n", 2), ("1,2,x\n4,5,6\n", 2), ("1,2,3\n", 2),
    ("1,2,3\n4,5,6\n7,8,9\n", 2)])
def test_malformed_csv_is_refused(tmp_path, text, rows):
    """An empty cell, too few or too many columns, junk, a short or a long
    file: refused as the NumPy path refuses it (ValueError), and by
    roc_tpu's reader."""
    p = tmp_path / "bad.csv"
    p.write_text(text)
    with pytest.raises(ValueError):
        native.parse_feats_csv(str(p), rows, 3)
    with pytest.raises(ValueError):
        got = np.loadtxt(str(p), delimiter=",", dtype=np.float32, ndmin=2)
        if got.shape != (rows, 3):
            raise ValueError("shape")
    prefix = str(tmp_path / "d")
    os.replace(p, prefix + ".feats.csv")
    with pytest.raises((ValueError, AssertionError, OSError)):
        jlux.load_features(prefix, rows, 3)
    with pytest.raises(ValueError):
        lux.load_features(prefix, rows, 3)


def test_csv_blank_tail_and_missing_file(tmp_path):
    p = tmp_path / "blank.csv"
    p.write_text("1,2,3\n4,5,6\n\n\r\n# done\n")
    np.testing.assert_array_equal(native.parse_feats_csv(str(p), 2, 3),
                                  [[1, 2, 3], [4, 5, 6]])
    # a line of blanks is a row, not a blank line, to np.loadtxt too
    p.write_text("1,2,3\n4,5,6\n \n")
    with pytest.raises(ValueError):
        native.parse_feats_csv(str(p), 2, 3)
    with pytest.raises(OSError):
        native.parse_feats_csv(str(tmp_path / "absent.csv"), 2, 3)


_GRAMMAR = [
    "1,2\n3,4\n", "1,2\n\n3,4\n", "1,2\n   \n3,4\n", "1,2\n# c\n3,4\n",
    "1,2 # c\n3,4\n", " 1 , 2 \n3,4\n", "\t1,\t2\v\n3,4\n", "0x1p3,2\n3,4\n",
    "1_0,2\n3,4\n", "+1,+inf\n3,4\n", "Infinity,-nan\n3,NaN\n",
    "nan(1),2\n3,4\n", "1.,.5\n3,4\n", "1e,2\n3,4\n", ".,2\n3,4\n",
    "1d5,2\n3,4\n", "1,2,\n3,4\n", ",2\n3,4\n", "1,2\r\n3,4\r\n",
    "1,2\r3,4\r", "1,2\n3,4", "1,2\n3,4\n\n\n", "1,2\n3,4\n  \n",
    "1,2\n3,4\n#x\n", "1,2\n3,4\nz\n", "1 2,3\n3,4\n", "1,2\f\n3,4\n",
    "16777217,0.1\n3.4028235677973366e38,1e-46\n", "1e400,-1e-400\n3,4\n",
    "#,\n1,2\n3,4\n", "1,2#\n3,4\n", "1,#2\n3,4\n", "-0,2\n3,4\n",
    "1,2\x00\n3,4\n", "1,2\x1c\n3,4\n", "INF,-Inf\n3,4\n", "infinit,2\n3,4\n",
    "1E+05,2E-3\n3,4\n", "1e+,2\n3,4\n", "--1,2\n3,4\n", "1,2\n  #c\n3,4\n",
    "1,2\r\r3,4", "1,2\n\x1c\n3,4\n", "1" + "0" * 400 + ",2\n3,4\n",
    "0." + "0" * 500 + "1,-2.5e-45\n3,4\n", "1,2\n3,4\n5,6\n", "1,2\n",
    "1.40129846e-45,1.1754942e-38\n0.30000001192092896,2.5\n"]


@pytest.mark.parametrize("text", _GRAMMAR, ids=range(len(_GRAMMAR)))
def test_csv_grammar_equals_loadtxt(tmp_path, text):
    """Comments, blank and blank-looking lines, line ends, whitespace and
    Python's float spellings (and what it refuses) as ``np.loadtxt``
    reads them at float32: the same bits (NaN signs included), or a
    ValueError from both."""
    p = tmp_path / "g.csv"
    p.write_bytes(text.encode())
    try:
        want = np.loadtxt(str(p), delimiter=",", dtype=np.float32, ndmin=2)
        if want.shape != (2, 2):
            raise ValueError("shape")
    except ValueError:
        with pytest.raises(ValueError):
            native.parse_feats_csv(str(p), 2, 2)
        return
    got = native.parse_feats_csv(str(p), 2, 2)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()


def test_csv_in_parallel_ranges_equals_loadtxt(tmp_path):
    """A file of several MiB, cut into one range of lines per core, with
    comments, blank lines and every line end at the cuts' mercy: the same
    bits as ``np.loadtxt``, and a bad field deep in the file named by its
    data row."""
    rng = np.random.default_rng(9)
    feats = (rng.standard_normal((3000, 150)) * 10.0 **
             rng.integers(-40, 38, (3000, 150))).astype(np.float32)
    ends = ("\n", "\r\n", "\r")
    lines, at = [], {}
    for i, row in enumerate(feats):
        if i % 97 == 0:
            lines.append("# a comment, 1,2,3")
        if i % 89 == 0:
            lines.append("")
        at[i] = len(lines)
        lines.append(" , ".join(f"{v:.9g}" for v in row) +
                     (" # trailing" if i % 7 == 0 else ""))

    def joined():
        return "".join(ln + ends[i % 3] for i, ln in enumerate(lines))
    text = joined()
    assert len(text) > 4 << 20
    p = tmp_path / "big.csv"
    p.write_bytes(text.encode())
    got = native.parse_feats_csv(str(p), *feats.shape)
    want = np.loadtxt(str(p), delimiter=",", dtype=np.float32, ndmin=2)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    np.testing.assert_array_equal(got, feats)
    lines[at[2500]] = "x," + lines[at[2500]].split(",", 1)[1]
    p.write_bytes(joined().encode())
    with pytest.raises(ValueError, match="row 2500 is malformed"):
        native.parse_feats_csv(str(p), *feats.shape)


@pytest.mark.parametrize("n,e", [(300, 2000), (64, 0), (50, 1),
                                 (1000, 20000)])
def test_transpose_and_edge_map_small(n, e):
    rng = np.random.default_rng(n + e)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if e > 100:
        src[:e // 4] = 7                     # a hub source
    g = add_self_edges(from_edges(n, src, dst))
    t_row, t_col, order = native.csr_transpose(g.row_ptr, g.col_idx,
                                               edge_map=True)
    np.testing.assert_array_equal(order,
                                  np.argsort(g.col_idx, kind="stable"))
    want = g.transpose()                     # small: the NumPy oracle
    jwant = _jcsr(g).transpose()
    for got, ref in ((t_row, want.row_ptr), (t_col, want.col_idx),
                     (t_row, jwant.row_ptr), (t_col, jwant.col_idx)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_transpose_at_the_threshold(big, monkeypatch):
    calls = []
    orig = native.csr_transpose
    monkeypatch.setattr(native, "csr_transpose",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    t, order = big.transpose_with_order()
    assert calls == [{"edge_map": True}]
    np.testing.assert_array_equal(order,
                                  np.argsort(big.col_idx, kind="stable"))
    t_np, order_np = _numpy(monkeypatch, big.transpose_with_order)
    assert len(calls) == 1
    np.testing.assert_array_equal(order, order_np)
    jt = _jcsr(big).transpose()
    for f in ("row_ptr", "col_idx"):
        a, b, c = getattr(t, f), getattr(t_np, f), getattr(jt, f)
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c), f
    assert np.array_equal(big.transpose().col_idx, t.col_idx)
    # the placement: one native call gives the transpose and t_pos
    calls.clear()
    dev = DeviceCsr.from_csr(big, "cpu", edge_map=True)
    assert calls == [{"edge_map": True}]
    dev_np = _numpy(monkeypatch, DeviceCsr.from_csr, big, "cpu",
                    edge_map=True)
    for a, b in zip(dev.tensors(), dev_np.tensors()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # forward edge e sits at t_pos[e] in the transpose, whose column there
    # is e's destination
    assert torch.equal(dev.t_col_idx[dev.t_pos.long()],
                       torch.as_tensor(big.dst_idx))


def test_out_of_range_sources_are_refused(big):
    col = big.col_idx.copy()
    col[123] = big.num_nodes
    bad = Csr(big.num_nodes, big.num_edges, big.row_ptr, col)
    with pytest.raises(ValueError, match="out of range"):
        bad.transpose()
    with pytest.raises(ValueError, match="out of range"):
        bad.transpose_with_order()
    # the library checks too, before writing past its buffers
    with pytest.raises(ValueError, match="out of range"):
        native.csr_transpose(bad.row_ptr, bad.col_idx)
    col[123] = -1
    with pytest.raises(ValueError, match="out of range"):
        native.csr_transpose(bad.row_ptr, col)
    with pytest.raises(ValueError, match="out of range"):
        native.rcm_order(bad.row_ptr, col, big.row_ptr, big.col_idx)
    # row offsets that are not a CSR's never reach the library
    for rp in ([0, 2, 1, 3], [1, 2, 3], [0, 1, 2]):
        with pytest.raises(ValueError, match="monotonely"):
            native.csr_transpose(np.asarray(rp),
                                 np.zeros(3, np.int32))


def test_rcm_at_the_threshold_equals_roc_tpu(big, monkeypatch):
    calls = []
    orig = native.rcm_order
    monkeypatch.setattr(native, "rcm_order",
                        lambda *a: calls.append(1) or orig(*a))
    got = reorder.rcm_order(big)
    assert calls == [1]
    want = jreorder.rcm_order(_jcsr(big), use_native=False)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(
        _numpy(monkeypatch, reorder.rcm_order, big), want)
    assert calls == [1]


def test_rcm_small_graphs_keep_the_numpy_path(ds, monkeypatch):
    monkeypatch.setattr(native, "rcm_order", None)   # not reached
    got = reorder.rcm_order(ds.graph)
    np.testing.assert_array_equal(
        got, jreorder.rcm_order(_jcsr(ds.graph), use_native=False))


@pytest.mark.parametrize("parts", [2, 3, 4, 8])
def test_halo_maps_equal_numpy_and_roc_tpu(ds, parts, monkeypatch):
    g = ds.graph
    p = partition_graph(g, parts)
    got = halo.build_halo_maps(p)
    for want in (_numpy(monkeypatch, halo.build_halo_maps, p),
                 halo._build_halo_maps_numpy(p),
                 jhalo._build_halo_maps_numpy(jpartition(_jcsr(g), parts))):
        assert got.K == want.K
        assert got.halo_rows_total == want.halo_rows_total
        for f in ("send_idx", "edge_src_local"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_no_native_selects_every_numpy_path(ds, big, tmp_path, no_native):
    """Under ROC_TPU_NO_NATIVE=1 every wired site runs its NumPy twin (the
    fixture makes the library unreachable)."""
    g = ds.graph
    path = str(tmp_path / "g") + lux.LUX_SUFFIX
    lux.write_lux(path, g)
    assert np.array_equal(lux.read_lux(path).col_idx, g.col_idx)
    prefix = str(tmp_path / "d")
    np.savetxt(prefix + ".feats.csv", ds.features, delimiter=",", fmt="%.9g")
    np.testing.assert_array_equal(
        lux.load_features(prefix, *ds.features.shape), ds.features)
    assert len(bounds_from_row_ptr(g.row_ptr, 4)) == 4
    halo.build_halo_maps(partition_graph(g, 4))
    t, order = big.transpose_with_order()
    assert t.num_edges == big.num_edges
    DeviceCsr.from_csr(big, "cpu", edge_map=True)
    reorder.rcm_order(big)


def _gcn_losses(ds):
    cfg = Config(dataset="native-big", layers=[8, 8, 4], seed=3,
                 device="cpu", num_epochs=3, learning_rate=0.01,
                 weight_decay=5e-4, dropout_rate=0.5, eval_every=10**9,
                 aggregate_precision="fast")
    tr = Trainer(cfg, ds, build_model("gcn", cfg.layers, cfg.dropout_rate))
    return [float(tr.run_epoch()) for _ in range(3)]


def test_gcn_placed_natively_trains_bitwise(monkeypatch):
    """3 epochs of GCN (dropout 0.5) on a graph past the threshold: the CSR
    placed from the native transpose trains to the same bits as the one
    placed from the NumPy argsort (the same CSR bits reach the sum)."""
    ds = datasets.synthetic("native-big", 32_000, 16.5, 8, 4, n_train=4000,
                            n_val=1000, n_test=1000, seed=5)
    assert ds.graph.num_edges >= NATIVE_MIN_EDGES
    calls = []
    orig = native.csr_transpose
    monkeypatch.setattr(native, "csr_transpose",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = _gcn_losses(ds)
    assert calls, "the placement did not take the native transpose"
    n = len(calls)
    want = _numpy(monkeypatch, _gcn_losses, ds)
    assert len(calls) == n
    assert np.isfinite(got).all()
    assert np.array_equal(np.asarray(got, np.float64),
                          np.asarray(want, np.float64)), (got, want)
