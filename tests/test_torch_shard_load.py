"""Per-host loading (roc_tpu_torch.graph.shard_load, ``-perhost``) against
the single-host build and against roc_tpu's shard_load, on the CPU.

N simulated processes are N threads, each running the whole per-host
pipeline (meta broadcast, local slice reads, halo exchange) and meeting
where processes would meet, through ``ThreadAllGather``.

Tolerances: every array and count equal, element for element; the
-perhost trainer's CSRs, halo maps and node tensors bitwise the full
build's, and its losses equal.
"""

import os
import threading

import numpy as np
import pytest
import torch

from roc_tpu.graph import shard_load as jshard_load
from roc_tpu_torch.graph import datasets, lux, shard_load
from roc_tpu_torch.graph.datasets import GraphStub
from roc_tpu_torch.graph.partition import partition_graph
from roc_tpu_torch.models import build_model
from roc_tpu_torch.parallel.halo import build_halo_maps
from roc_tpu_torch.parallel.spmd import SpmdTrainer
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.driver import make_trainer


@pytest.fixture(scope="module")
def roc_dir(tmp_path_factory):
    ds = datasets.synthetic("shardload", 600, 6.0, 12, 5,
                            n_train=100, n_val=100, n_test=100, seed=7)
    prefix = str(tmp_path_factory.mktemp("roc") / "g")
    lux.write_dataset(prefix, ds.graph, ds.features, ds.label_ids, ds.mask)
    return prefix, ds


def _run_threads(nproc, fn):
    """fn(proc_index) in nproc threads; exceptions propagate."""
    results, errors = [None] * nproc, []

    def wrap(i):
        try:
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - rethrown below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(i,), daemon=True)
               for i in range(nproc)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    if errors:
        raise errors[0]
    return results


@pytest.mark.parametrize("num_parts,nproc",
                         [(4, 1), (4, 2), (8, 4), (6, 3)])
def test_perhost_equals_singlehost(roc_dir, num_parts, nproc):
    prefix, ds = roc_dir
    path = prefix + lux.LUX_SUFFIX
    part = partition_graph(ds.graph, num_parts)
    halo = build_halo_maps(part)
    L = num_parts // nproc
    ag = shard_load.ThreadAllGather(nproc)

    def per_process(i):
        allg = ag.for_process(i)
        meta = shard_load.meta_from_lux(path, num_parts, process_index=i,
                                        allgather=allg)
        ids = list(range(i * L, (i + 1) * L))
        local = shard_load.load_local_shards(path, meta, ids)
        return meta, local, shard_load.build_halo_local(meta, local, allg)

    for meta, local, lhalo in _run_threads(nproc, per_process):
        np.testing.assert_array_equal(meta.bounds, part.bounds)
        assert (meta.shard_nodes, meta.shard_edges) == \
            (part.shard_nodes, part.shard_edges)
        np.testing.assert_array_equal(meta.num_edges_valid,
                                      part.num_edges_valid)
        ids = list(local.part_ids)
        for f in ("edge_src", "edge_dst", "in_degree", "node_mask"):
            a, b = getattr(local, f), getattr(part, f)[ids]
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert lhalo.K == halo.K
        assert lhalo.halo_rows_total == halo.halo_rows_total
        np.testing.assert_array_equal(lhalo.send_idx, halo.send_idx[ids])
        np.testing.assert_array_equal(lhalo.edge_src_local,
                                      halo.edge_src_local[ids])
        np.testing.assert_array_equal(
            shard_load.load_local_degrees(path, meta, ids),
            part.in_degree[ids])
        global_bytes = (part.edge_src.nbytes + part.edge_dst.nbytes
                        + part.in_degree.nbytes + part.node_mask.nbytes)
        assert local.nbytes() == global_bytes * L // num_parts


def test_perhost_equals_roc_tpu_shard_load(roc_dir):
    prefix, _ = roc_dir
    path = prefix + lux.LUX_SUFFIX
    a = shard_load.meta_from_lux(path, 4)
    b = jshard_load.meta_from_lux(path, 4)
    for f in ("bounds", "num_valid", "num_edges_valid", "edge_starts"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    la = shard_load.load_local_shards(path, a, [1, 3])
    lb = jshard_load.load_local_shards(path, b, [1, 3])
    for f in ("edge_src", "edge_dst", "in_degree", "node_mask"):
        assert np.array_equal(getattr(la, f), getattr(lb, f)), f
    ha = shard_load.build_halo_local(a, shard_load.load_local_shards(
        path, a, range(4)))
    hb = jshard_load.build_halo_local(b, jshard_load.load_local_shards(
        path, b, range(4)))
    assert ha.K == hb.K and ha.halo_rows_total == hb.halo_rows_total
    assert np.array_equal(ha.send_idx, hb.send_idx)
    assert np.array_equal(ha.edge_src_local, hb.edge_src_local)
    assert shard_load.allgather_floors([[3, 9], [4, 1]], None) == \
        jshard_load.allgather_floors([[3, 9], [4, 1]], None) == [9, 4]


def test_graph_stub_loads_the_header_only(roc_dir):
    from roc_tpu.graph import datasets as jdatasets
    prefix, ds = roc_dir
    got = datasets.load_roc_dataset(prefix, 12, 5, graph_stub=True)
    want = jdatasets.load_roc_dataset(prefix, 12, 5, graph_stub=True)
    assert isinstance(got.graph, GraphStub)
    assert (got.graph.num_nodes, got.graph.num_edges) == \
        (want.graph.num_nodes, want.graph.num_edges) == \
        (ds.graph.num_nodes, ds.graph.num_edges)
    assert isinstance(got.features, np.memmap) and got.labels is None


def _cfg(prefix, perhost, **kw):
    return Config(filename=prefix, layers=[12, 8, 5], num_parts=4,
                  num_epochs=2, dropout_rate=0.5, eval_every=10**9,
                  device="cpu", perhost_load=perhost,
                  learning_rate=0.01, weight_decay=5e-4, **kw)


@pytest.mark.parametrize("halo_on", [True, False])
def test_perhost_trainer_equals_full_build(roc_dir, halo_on):
    prefix, _ = roc_dir
    mesh = ["cpu"] * 4
    full_ds = datasets.load_roc_dataset(prefix, 12, 5)
    stub_ds = datasets.load_roc_dataset(prefix, 12, 5, graph_stub=True)
    model = build_model("gcn", [12, 8, 5], 0.5)
    kw = dict(halo=halo_on, aggregate_backend="binned",
              aggregate_precision="exact")
    full = SpmdTrainer(_cfg(prefix, False, **kw), full_ds, model,
                       devices=mesh)
    per = SpmdTrainer(_cfg(prefix, True, **kw), stub_ds, model,
                      devices=mesh)
    assert not per._balance_supported() and full._balance_supported()
    if halo_on:
        assert per.halo.K == full.halo.K
        assert np.array_equal(per.halo.send_idx, full.halo.send_idx)
        assert per.gdata.overlap and full.gdata.overlap
    for a, b in zip(per.gdata.parts, full.gdata.parts):
        for ca, cb in ((a.csr, b.csr), (a.csr_local, b.csr_local),
                       (a.csr_remote, b.csr_remote)):
            assert (ca is None) == (cb is None)
            if ca is not None:
                for x, y in zip(ca, cb):
                    assert (x is None) == (y is None)
                    assert x is None or torch.equal(x, y)
    for f in ("x", "labels", "mask"):
        assert torch.equal(getattr(per, f), getattr(full, f)), f
    lp = [float(per.run_epoch()) for _ in range(2)]
    lf = [float(full.run_epoch()) for _ in range(2)]
    assert lp == lf


def test_perhost_refusals(roc_dir):
    prefix, ds = roc_dir
    stub = datasets.load_roc_dataset(prefix, 12, 5, graph_stub=True)
    model = build_model("gcn", [12, 8, 5], 0.0)
    # k = 4 on one device: overcommit is single-process only
    with pytest.raises(SystemExit, match="-perhost"):
        SpmdTrainer(_cfg(prefix, True), stub, model)
    # no -file
    with pytest.raises(SystemExit, match="needs -file"):
        SpmdTrainer(_cfg("", True), stub, model, devices=["cpu"] * 4)
    # a stub trains only through the -perhost SPMD path
    with pytest.raises(SystemExit, match="graph stub"):
        make_trainer(Config(layers=[12, 8, 5], device="cpu"), stub, model)


def test_perhost_cli_checks(roc_dir, capsys):
    from roc_tpu_torch.__main__ import main
    prefix, _ = roc_dir
    assert main(["-file", prefix, "-layers", "12-8-5", "-perhost",
                 "-device", "cpu"]) == 2
    assert main(["-file", prefix, "-layers", "12-8-5", "-parts", "4",
                 "-perhost", "-check-sharding", "-device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "-perhost requires -file and -parts > 1" in err
    assert "-check-sharding needs the full graph" in err


# -- edge blocks and ring groups from the byte ranges -------------------------------

@pytest.mark.parametrize("num_parts,nproc", [(4, 1), (4, 2), (8, 2)])
def test_edge_blocks_equal_singlehost(roc_dir, num_parts, nproc):
    """Each simulated process reads its blocks from the .lux byte ranges
    (forward) and the .t.lux sidecar (backward): element-equal to
    edge_block_arrays and its transpose, and to roc_tpu's loader."""
    from roc_tpu_torch.graph.partition import (edge_block_arrays,
                                               edge_block_arrays_t)
    prefix, ds = roc_dir
    path, tpath = prefix + lux.LUX_SUFFIX, prefix + lux.TLUX_SUFFIX
    if not os.path.exists(tpath):
        lux.write_transpose(prefix, ds.graph)
    part = partition_graph(ds.graph, num_parts)
    f_full = edge_block_arrays(ds.graph, part)
    b_full = edge_block_arrays_t(ds.graph, part)
    L = num_parts // nproc
    ag = shard_load.ThreadAllGather(nproc)

    def per_process(i):
        meta = shard_load.meta_from_lux(path, num_parts, process_index=i,
                                        allgather=ag.for_process(i))
        ids = list(range(i * L, (i + 1) * L))
        return (ids, shard_load.load_edge_blocks(path, meta, ids),
                shard_load.load_edge_blocks(tpath, meta, ids))

    for ids, f, b in _run_threads(nproc, per_process):
        for got, want in ((f, f_full), (b, b_full)):
            for a, w in zip(got, want):
                assert a.dtype == np.int64
                np.testing.assert_array_equal(a, w[ids])
    jmeta = jshard_load.meta_from_lux(path, num_parts)
    for pth in (path, tpath):
        want = jshard_load.load_edge_blocks(pth, jmeta, [1, 0])
        got = shard_load.load_edge_blocks(
            pth, shard_load.meta_from_lux(path, num_parts), [1, 0])
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)


def test_edge_blocks_all_pad_tail(tmp_path):
    """A late block that starts past the edge count is all pad edges,
    equal to edge_block_arrays' tail (roc_tpu's test_shard_load.py:252)."""
    from roc_tpu_torch.graph.partition import (_EDGE_ALIGN, _round_up,
                                               edge_block_arrays)
    ds = datasets.synthetic("tinyblk", 120, 2.0, 4, 3, n_train=10,
                            n_val=10, n_test=10, seed=11)
    g, P = ds.graph, 16
    prefix = str(tmp_path / "t")
    lux.write_lux(prefix + lux.LUX_SUFFIX, g)
    part = partition_graph(g, P)
    Eb = _round_up(-(-g.num_edges // P), _EDGE_ALIGN)
    assert (P - 1) * Eb > g.num_edges, "the shape must end in pad blocks"
    meta = shard_load.meta_from_lux(prefix + lux.LUX_SUFFIX, P)
    got = shard_load.load_edge_blocks(prefix + lux.LUX_SUFFIX, meta,
                                      list(range(P)))
    full = edge_block_arrays(g, part)
    np.testing.assert_array_equal(got[0], full[0])
    np.testing.assert_array_equal(got[1], full[1])


def test_edge_blocks_fuzz_equal_singlehost(tmp_path):
    """Random shapes and part counts (self-loop-only rows, hubs, P not
    dividing E), both orientations (roc_tpu's test_shard_load.py:276)."""
    from roc_tpu_torch.graph.csr import add_self_edges, from_edges
    from roc_tpu_torch.graph.partition import edge_block_arrays
    rng = np.random.default_rng(31)
    for trial in range(5):
        n = int(rng.integers(40, 900))
        e = int(rng.integers(0, 4000))
        P = int(rng.choice([2, 3, 4, 7, 8, 16]))
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        if e > 50 and trial % 2:
            dst[: e // 3] = int(rng.integers(0, n))   # hub
        g = add_self_edges(from_edges(n, src, dst))
        prefix = str(tmp_path / f"f{trial}")
        lux.write_lux(prefix + lux.LUX_SUFFIX, g)
        lux.write_transpose(prefix, g)
        part = partition_graph(g, P)
        meta = shard_load.meta_from_lux(prefix + lux.LUX_SUFFIX, P)
        for path, full in [
                (prefix + lux.LUX_SUFFIX, edge_block_arrays(g, part)),
                (prefix + lux.TLUX_SUFFIX,
                 edge_block_arrays(g.transpose(), part))]:
            got = shard_load.load_edge_blocks(path, meta, list(range(P)))
            msg = f"trial {trial}: n={n} e={e} P={P} {path[-6:]}"
            np.testing.assert_array_equal(got[0], full[0], err_msg=msg)
            np.testing.assert_array_equal(got[1], full[1], err_msg=msg)


def test_edge_blocks_header_mismatch(roc_dir, tmp_path):
    prefix, _ = roc_dir
    other = datasets.synthetic("o", 50, 2.0, 4, 3, n_train=5, n_val=5,
                               n_test=5, seed=1)
    lux.write_lux(str(tmp_path / "o.lux"), other.graph)
    meta = shard_load.meta_from_lux(prefix + lux.LUX_SUFFIX, 4)
    with pytest.raises(ValueError, match="mismatched transpose sidecar"):
        shard_load.load_edge_blocks(str(tmp_path / "o.lux"), meta, [0])


def _same_csr(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        assert x is None or torch.equal(x, y)


@pytest.mark.parametrize("mode", ["edge", "ring"])
def test_perhost_edge_and_ring_equal_full_build(roc_dir, mode):
    """-perhost -edge-shard on (blocks from the .lux and the sidecar) and
    -perhost -exchange ring (groups from the part slices): blocks,
    windows, groups, node tensors and the epochs' losses bitwise the full
    build's."""
    prefix, ds = roc_dir
    if not os.path.exists(prefix + lux.TLUX_SUFFIX):
        lux.write_transpose(prefix, ds.graph)
    mesh = ["cpu"] * 4
    kw = dict(aggregate_backend="binned", aggregate_precision="exact")
    kw.update(edge_shard="on" if mode == "edge" else "off",
              exchange="ring" if mode == "ring" else "")
    full = SpmdTrainer(_cfg(prefix, False, **kw),
                       datasets.load_roc_dataset(prefix, 12, 5),
                       build_model("gcn", [12, 8, 5], 0.5), devices=mesh)
    per = SpmdTrainer(_cfg(prefix, True, **kw),
                      datasets.load_roc_dataset(prefix, 12, 5,
                                                graph_stub=True),
                      build_model("gcn", [12, 8, 5], 0.5), devices=mesh)
    assert per.gdata.mode == full.gdata.mode == mode
    if mode == "edge":
        a, b = per.gdata.edge, full.gdata.edge
        assert (a.span_fwd, a.span_bwd) == (b.span_fwd, b.span_bwd)
        assert np.array_equal(a.fwd_base, b.fwd_base)
        assert np.array_equal(a.bwd_base, b.bwd_base)
        for x, y in zip(a.fwd + a.bwd, b.fwd + b.bwd):
            _same_csr(x, y)
    else:
        for f in ("ring_src", "ring_dst"):
            assert np.array_equal(getattr(per.ring_maps, f),
                                  getattr(full.ring_maps, f))
        for ra, rb in zip(per.gdata.ring, full.gdata.ring):
            for x, y in zip(ra, rb):
                assert (x is None) == (y is None)
                if x is not None:
                    _same_csr(x, y)
    for f in ("x", "labels", "mask"):
        assert torch.equal(getattr(per, f), getattr(full, f)), f
    assert torch.equal(per.gdata.in_degree, full.gdata.in_degree)
    lp = [float(per.run_epoch()) for _ in range(2)]
    lf = [float(full.run_epoch()) for _ in range(2)]
    assert lp == lf


def test_perhost_edge_needs_the_sidecar(tmp_path):
    ds = datasets.synthetic("nos", 120, 3.0, 12, 5, n_train=20, n_val=20,
                            n_test=20, seed=2)
    prefix = str(tmp_path / "g")
    lux.write_dataset(prefix, ds.graph, ds.features, ds.label_ids, ds.mask)
    stub = datasets.load_roc_dataset(prefix, 12, 5, graph_stub=True)
    cfg = _cfg(prefix, True, edge_shard="on")
    with pytest.raises(SystemExit, match="needs the transposed sidecar"):
        SpmdTrainer(cfg, stub, build_model("gcn", [12, 8, 5]),
                    devices=["cpu"] * 4)
    lux.write_transpose(prefix, ds.graph)
    t = prefix + lux.TLUX_SUFFIX
    os.utime(t, (1, 1))
    with pytest.raises(SystemExit, match="older than"):
        SpmdTrainer(cfg, stub, build_model("gcn", [12, 8, 5]),
                    devices=["cpu"] * 4)
    # GAT edge -perhost off the kernel backend: roc_tpu's refusal
    os.utime(t, None)
    with pytest.raises(SystemExit, match="plan attention backend"):
        SpmdTrainer(_cfg(prefix, True, edge_shard="on", model="gat",
                         heads=2, aggregate_backend="xla"), stub,
                    build_model("gat", [12, 8, 5], heads=2),
                    devices=["cpu"] * 4)
