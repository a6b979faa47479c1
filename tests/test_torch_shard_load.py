"""Per-host loading (roc_tpu_torch.graph.shard_load, ``-perhost``) against
the single-host build and against roc_tpu's shard_load, on the CPU.

N simulated processes are N threads, each running the whole per-host
pipeline (meta broadcast, local slice reads, halo exchange) and meeting
where processes would meet, through ``ThreadAllGather``.

Tolerances: every array and count equal, element for element; the
-perhost trainer's CSRs, halo maps and node tensors bitwise the full
build's, and its losses equal.
"""

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
