"""The port's edge sharding (roc_tpu_torch.parallel.spmd, ``-edge-shard``)
against roc_tpu's, on the CPU: roc_tpu's SpmdTrainer runs on the 8 host
devices of tests/conftest.py (``-aggr-backend xla``: its xla edge sum and
``_edge_attend``), the port's blocks on one CPU device with the mesh
``["cpu"] * 8`` (k = 1).

Tolerances:
  block windows (bases, spans), with and without floors      equal
  one edge-block sum and its gradient on integer data        bitwise (avg's
                                                             gradient 1e-6)
  3-epoch edge trainers vs roc_tpu's                         1e-5 relative,
                                                             accuracy counts
                                                             equal
  edge attention gradients vs the single-device composition  1e-5
  -edge-shard auto on roc_tpu's hub graph                    the same mode
                                                             as roc_tpu,
                                                             loss 1e-5
"""

import dataclasses
import functools
import io
import threading
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild
from roc_tpu.parallel import spmd as jspmd
from roc_tpu.parallel.spmd import SpmdTrainer as JSpmd
from roc_tpu.train.config import Config as JConfig
from roc_tpu_torch import ops
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.graph import csr as tcsr
from roc_tpu_torch.graph.partition import (edge_block_arrays,
                                           edge_block_arrays_t,
                                           partition_graph)
from roc_tpu_torch.graph.shard_load import ThreadAllGather
from roc_tpu_torch.models import build_model
from roc_tpu_torch.parallel import spmd
from roc_tpu_torch.parallel.spmd import SpmdTrainer
from roc_tpu_torch.train.config import Config

MESH8 = ["cpu"] * 8
LAYERS = [10, 8, 4]
OPT = dict(learning_rate=0.01, weight_decay=5e-4, eval_every=10**9,
           num_epochs=3)


def _synth(pkg, seed=5):
    return pkg.synthetic("es", 400, 5.0, 10, 4, n_train=80, n_val=80,
                         n_test=80, seed=seed)


@pytest.fixture(scope="module")
def ds():
    return _synth(datasets)


def hub_graph(pkg, n=300, hub_deg=150, seed=2):
    """roc_tpu's hub graph (test_edge_shard.py:24): one vertex whose
    in-degree alone passes the per-part edge cap."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, size=3 * n)
    d = rng.integers(0, n, size=3 * n)
    hub_src = rng.integers(0, n, size=hub_deg)
    s = np.concatenate([s, hub_src])
    d = np.concatenate([d, np.zeros(hub_deg, np.int64)])
    keep = s != d
    return pkg.add_self_edges(pkg.from_edges(n, s[keep], d[keep]))


def _hub_ds(pkg_ds, pkg_csr, hub_deg=2000):
    """roc_tpu's auto-selection fixture (test_edge_shard.py:101), with a
    trainable mask."""
    g = hub_graph(pkg_csr, hub_deg=hub_deg)
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 4, size=g.num_nodes)
    mask = np.where(rng.random(g.num_nodes) < 0.5, 1, 2).astype(np.int32)
    return pkg_ds.Dataset(
        name="hub", graph=g,
        features=rng.normal(size=(g.num_nodes, 10)).astype(np.float32),
        labels=None, label_ids=lab, mask=mask, in_dim=10, num_classes=4)


@functools.lru_cache(maxsize=None)
def _roc_tpu_edge(model, aggr, dropout, parts, hub=False, edge="on"):
    """roc_tpu's edge SpmdTrainer, 3 epochs: (mode, losses, counts)."""
    from roc_tpu.graph import csr as jcsr
    jds = _hub_ds(jdatasets, jcsr) if hub else _synth(jdatasets)
    cfg = JConfig(layers=LAYERS, dropout_rate=dropout, num_parts=parts,
                  edge_shard=edge, aggregate_backend="xla", model=model,
                  aggr=aggr, heads=2, **OPT)
    tr = JSpmd(cfg, jds, jbuild(model, LAYERS, dropout, aggr, heads=2))
    losses = [float(tr.run_epoch()) for _ in range(3)]
    m = tr.evaluate()
    return tr.gdata.mode, losses, tuple(
        int(getattr(m, f)) for f in ("train_correct", "val_correct",
                                     "test_correct"))


def _port(ds, model="gcn", aggr="", dropout=0.0, parts=4, edge="on",
          **kw):
    kw.setdefault("aggregate_backend", "xla")
    cfg = Config(layers=LAYERS, dropout_rate=dropout, num_parts=parts,
                 edge_shard=edge, model=model, aggr=aggr, heads=2,
                 device="cpu", **OPT, **kw)
    return SpmdTrainer(cfg, ds, build_model(model, LAYERS, dropout, aggr,
                                            heads=2), devices=MESH8)


def _run(tr):
    losses = [float(tr.run_epoch()) for _ in range(3)]
    m = tr.evaluate()
    return losses, tuple(int(getattr(m, f)) for f in
                         ("train_correct", "val_correct", "test_correct"))


# -- blocks and windows ----------------------------------------------------------

@pytest.mark.parametrize("parts", [2, 4, 8])
def test_block_windows_equal_roc_tpu(ds, parts):
    g = ds.graph
    p = partition_graph(g, parts)
    NS = parts * p.shard_nodes
    for gat, sct in (edge_block_arrays(g, p), edge_block_arrays_t(g, p)):
        want = jspmd._block_window(sct, NS)
        got = spmd.block_window(sct, NS)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        assert np.all(got[0] + got[1] <= NS)


def test_block_windows_floors_across_processes(ds):
    """Two simulated processes with two blocks each: the allgathered span
    is the single-host span, the bases the single host's rows."""
    g = ds.graph
    p = partition_graph(g, 4)
    NS = 4 * p.shard_nodes
    _, sct = edge_block_arrays(g, p)
    fb, fs = spmd.block_window(sct, NS)
    ag = ThreadAllGather(2)
    out = [None, None]

    def run(i):
        out[i] = spmd.block_window(sct[2 * i:2 * i + 2], NS,
                                   ag.for_process(i))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    for i, (b, s) in enumerate(out):
        assert s == fs and np.array_equal(b, fb[2 * i:2 * i + 2])


def test_block_csrs_hold_the_live_edges(ds):
    """Each block's forward CSR holds its live edges at their window rows,
    the backward CSR the transposed cut's: different edges per block."""
    tr = _port(ds)
    g, p = ds.graph, tr.part
    eb = tr.gdata.edge
    NS = 4 * p.shard_nodes
    for cut, csrs, bases in ((edge_block_arrays(g, p), eb.fwd, eb.fwd_base),
                             (edge_block_arrays_t(g, p), eb.bwd,
                              eb.bwd_base)):
        gat, sct = cut
        for b, (csr, base) in enumerate(zip(csrs, bases)):
            live = sct[b] != NS - 1
            dst = spmd._csr_dst(csr).numpy() + int(base)
            assert np.array_equal(dst, sct[b][live])
            assert np.array_equal(csr.col_idx.numpy(), gat[b][live])
    assert not np.array_equal(eb.fwd_base, eb.bwd_base) or \
        eb.span_fwd != eb.span_bwd or not all(
            torch.equal(a.col_idx, b.col_idx) for a, b in zip(eb.fwd, eb.bwd))


# -- one edge-block sum, bitwise ----------------------------------------------------

def _int_dataset(pkg, seed=4):
    ds = pkg.synthetic("ei", 160, 3.0, 6, 3, n_train=30, n_val=30,
                       n_test=30, seed=seed)
    feats = np.random.default_rng(seed).integers(
        -8, 9, size=ds.features.shape).astype(np.float32)
    return dataclasses.replace(ds, features=feats)


def _jax_aggregate(jtr, x, ct, aggr):
    """roc_tpu's per-shard GraphCtx aggregate inside its shard_map, and its
    VJP at ``ct``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    S = jtr.part.shard_nodes
    gd = jtr.gdata
    specs = jax.tree.map(lambda a: PS("parts"), gd)

    def body(xb, gdb):
        return jspmd._shard_gctx(jspmd._squeeze_gd(gdb), S,
                                 "halo").aggregate(xb, aggr)

    f = jax.shard_map(body, mesh=jtr.mesh, in_specs=(PS("parts"), specs),
                      out_specs=PS("parts"))
    y, vjp = jax.vjp(lambda a: f(a, gd), jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("aggr", ["sum", "avg"])
def test_edge_sum_and_gradient_bitwise_roc_tpu(aggr):
    """Each block's window sum placed in block order, the owners' rows,
    and the gradient over the transposed cut's blocks, against roc_tpu's
    edge sum and its psum_scatter (a gradient that reused the forward's
    blocks would differ)."""
    cfgj = JConfig(layers=[6, 4, 3], dropout_rate=0.0, num_parts=4,
                   edge_shard="on", aggregate_backend="xla",
                   eval_every=10**9)
    jtr = JSpmd(cfgj, _int_dataset(jdatasets), jbuild("gcn", [6, 4, 3]))
    tr = SpmdTrainer(Config(layers=[6, 4, 3], dropout_rate=0.0,
                            num_parts=4, edge_shard="on", device="cpu",
                            aggregate_backend="binned",
                            aggregate_precision="exact", eval_every=10**9),
                     _int_dataset(datasets), build_model("gcn", [6, 4, 3]),
                     devices=MESH8)
    assert tr.gdata.mode == "edge" and jtr.gdata.mode == "edge"
    x = tr.x.numpy().copy()
    # integer cotangents, 0 on pad rows (a step's cotangent is 0 there:
    # only pad edges, dropped by the port's CSRs, lead to them)
    ct = np.random.default_rng(1).integers(-4, 5, size=x.shape).astype(
        np.float32)
    S = tr.part.shard_nodes
    for i, nv in enumerate(tr.part.num_valid):
        ct[i * S + int(nv):(i + 1) * S] = 0
    y_j, g_j = _jax_aggregate(jtr, x, ct, aggr)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tr.gctx.aggregate(xt, aggr)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    y_t, g_t = y.detach().numpy(), g.numpy()
    assert np.array_equal(y_t.view(np.uint32), y_j.view(np.uint32))
    if aggr == "avg":
        np.testing.assert_allclose(g_t, g_j, rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(g_t.view(np.uint32), g_j.view(np.uint32))


def test_edge_attention_gradients_match_one_device(ds):
    """``_EdgeAttend``'s hand-derived backward against autograd of the
    single-device plain composition, on the padded rows."""
    tr = _port(ds, "gat")
    S, P = tr.part.shard_nodes, 4
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(P * S, 2, 3)).astype(np.float32))
    a_s = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    a_d = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(P * S, 2, 3)).astype(np.float32))
    live = torch.cat([torch.arange(int(nv)) + i * S
                      for i, nv in enumerate(tr.part.num_valid)])
    g[torch.ones(P * S, dtype=torch.bool).index_fill_(0, live, False)] = 0
    ins = [t.clone().requires_grad_(True) for t in (h, a_s, a_d)]
    out = tr.gctx.attend(*ins, 0.2)
    got = torch.autograd.grad(out, ins, g)
    # the same edges on one device: every block's live (src, dst)
    es, ed = zip(*spmd._block_edges(tr.gdata))
    es, ed = torch.cat(es), torch.cat(ed)
    order = torch.argsort(ed, stable=True)
    ref_in = [t.clone().requires_grad_(True) for t in (h, a_s, a_d)]
    ref = ops.gat_attend(ref_in[0], ref_in[0], es[order], ed[order], P * S,
                         ref_in[1], ref_in[2], 0.2)
    want = torch.autograd.grad(ref, ref_in, g)
    np.testing.assert_allclose(out[live].detach(), ref[live].detach(),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# -- the trainer against roc_tpu's ---------------------------------------------------

@pytest.mark.parametrize("parts,dropout", [(2, 0.0), (4, 0.0), (4, 0.5),
                                           (8, 0.5)])
def test_edge_gcn_trainer_matches_roc_tpu(ds, parts, dropout):
    mode, want_l, want_c = _roc_tpu_edge("gcn", "", dropout, parts)
    assert mode == "edge"
    tr = _port(ds, "gcn", "", dropout, parts)
    assert tr.gdata.mode == "edge" and tr.k == 1
    got_l, got_c = _run(tr)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_c == want_c


@pytest.mark.parametrize("model,aggr,backend",
                         [("sage", "avg", "xla"), ("gat", "", "xla"),
                          ("gcn", "", "binned"), ("gat", "", "binned")])
def test_edge_sage_gat_and_kernel_backend_match_roc_tpu(ds, model, aggr,
                                                        backend):
    mode, want_l, want_c = _roc_tpu_edge(model, aggr, 0.5, 4)
    got_l, got_c = _run(_port(ds, model, aggr, 0.5, 4,
                              aggregate_backend=backend,
                              aggregate_precision="exact"))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_c == want_c


# -- -edge-shard auto ---------------------------------------------------------------

def test_auto_selection_follows_roc_tpu():
    """The hub graph flips to edge mode and trains as roc_tpu's auto run;
    a uniform graph stays vertex; off overrides; GAT never auto-enables
    off the plan backend (the port's kernel backend) and does on it."""
    hub = _hub_ds(datasets, tcsr)
    err = io.StringIO()
    with redirect_stderr(err):
        t = _port(hub, edge="auto")
    assert t.gdata.mode == "edge"
    assert "auto-enabling edge-sharded aggregation" in err.getvalue()
    mode, want_l, want_c = _roc_tpu_edge("gcn", "", 0.0, 4, hub=True,
                                         edge="auto")
    assert mode == "edge"
    got_l, got_c = _run(t)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_c == want_c
    assert spmd.padded_max_tax(t.part) > SpmdTrainer.EDGE_SHARD_TAX
    assert _port(_synth(datasets), edge="auto").gdata.mode == "vertex"
    assert _port(hub, edge="off").gdata.mode == "vertex"
    assert _port(hub, "gat", edge="auto").gdata.mode == "vertex"
    assert _port(hub, "gat", edge="auto", aggregate_backend="binned",
                 aggregate_precision="exact").gdata.mode == "edge"
    assert _port(hub, "sage", "max", edge="auto").gdata.mode == "vertex"
    # k > 1: overcommit is vertex-only, auto stays off
    cfg = Config(layers=LAYERS, num_parts=16, device="cpu",
                 eval_every=10**9)
    assert SpmdTrainer(cfg, hub, build_model("gcn", LAYERS),
                       devices=MESH8).gdata.mode == "vertex"


def test_hub_graph_taxes():
    """roc_tpu's hub tax test (test_edge_shard.py:86): the hub's part makes
    vertex sharding pay; the edge cut stays tight."""
    tr = _port(_hub_ds(datasets, tcsr, hub_deg=600), parts=8)
    assert spmd.padded_max_tax(tr.part) > 0.30
    assert tr.edge_tax() < 0.05


# -- refusals and overrides ------------------------------------------------------

def test_edge_refusals_and_the_ring_override(ds, capsys):
    from roc_tpu_torch.__main__ import main
    cfg = Config(layers=LAYERS, num_parts=16, edge_shard="on", device="cpu",
                 eval_every=10**9)
    with pytest.raises(SystemExit, match="supports the halo/allgather "
                       "vertex exchanges only"):
        SpmdTrainer(cfg, ds, build_model("gcn", LAYERS), devices=MESH8)
    err = io.StringIO()
    with redirect_stderr(err):
        tr = _port(ds, exchange="ring")
    assert tr.gdata.mode == "edge"
    assert "-edge-shard on overrides -exchange ring" in err.getvalue()
    with pytest.raises(ValueError, match="supports sum/avg"):
        tr.gctx.aggregate(tr.x, "max")
    base = ["-dataset", "roc-audit", "-layers", "8-16-4", "-device", "cpu"]
    assert main(base + ["-parts", "4", "-exchange", "ring",
                        "-edge-shard", "on"]) == 2
    assert main(base + ["-parts", "4", "-edge-shard", "on", "-model",
                        "sage", "-aggr", "max"]) == 2
    assert main(base + ["-edge-shard", "on"]) == 2
    out = capsys.readouterr().err
    assert "-exchange ring and -edge-shard are mutually exclusive" in out
    assert out.count("-edge-shard supports sum/avg aggregation and needs "
                     "-parts > 1") == 2


def test_edge_verbose_lines_and_wire(ds):
    from roc_tpu.obs import channel as jchannel
    err = io.StringIO()
    with redirect_stderr(err):
        tr = _port(ds, verbose=True, bf16_storage=True,
                   aggregate_precision="fast")
    assert "# edge blocks: P=4 Eb=" in err.getvalue()
    # edge mode keeps the fp32 wire and counts the allgather's rows
    assert tr.gdata.xch == ("fp32", "nearest", "plain")
    assert tr.wire_bytes() == jchannel.wire_bytes_per_step(
        "allgather", 4, tr.part.shard_nodes, tr._aggregate_widths())
    assert not tr._balance_supported()


def test_check_sharding_covers_ring_and_edge(ds):
    """-check-sharding holds ring and edge trainers against one device
    (roc_tpu's checker, mode-blind)."""
    from roc_tpu_torch.parallel.check import check_shard_consistency
    for kw in (dict(exchange="ring"), dict(edge_shard="on")):
        cfg = Config(layers=LAYERS, num_parts=4, dropout_rate=0.0,
                     eval_every=10**9, device="cpu", **kw)
        tr = SpmdTrainer(cfg, ds, build_model("gcn", LAYERS),
                         devices=MESH8)
        m1, mp = check_shard_consistency(cfg, ds, build_model("gcn", LAYERS),
                                         sharded_trainer=tr, count_tol=0)
        assert int(m1.train_all) == int(mp.train_all) == 80
