"""The port's ring exchange (roc_tpu_torch.parallel.ring, ``-exchange ring``)
against roc_tpu's, on the CPU: roc_tpu's SpmdTrainer runs on the 8 host
devices of tests/conftest.py (``-aggr-backend xla``), the port's parts on
one CPU device with the mesh ``["cpu"] * 8`` (k = 1).

Tolerances:
  RingMaps, one process and 2 simulated processes (floors)  element-equal
  one ring sum and its gradient on integer data             bitwise (avg's
                                                            gradient 1e-6)
  3-epoch ring trainers vs roc_tpu's ring SpmdTrainer       1e-5 relative,
                                                            accuracy counts
                                                            equal
  ring max/min: empty rows, NaN                             exact
  the bf16 wire under ring vs roc_tpu's                     1e-4 relative

Settings are roc_tpu's test_parallel.py ``cfg_for`` (lr 0.01, weight decay
5e-4), as in test_torch_spmd.py.
"""

import functools
import io
import threading
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.graph.csr import Csr as JCsr
from roc_tpu.graph.partition import partition_graph as jpartition
from roc_tpu.models import build_model as jbuild
from roc_tpu.parallel import ring as jring
from roc_tpu.parallel.spmd import SpmdTrainer as JSpmd
from roc_tpu.train.config import Config as JConfig
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.graph.partition import partition_graph
from roc_tpu_torch.graph.shard_load import ThreadAllGather
from roc_tpu_torch.models import build_model
from roc_tpu_torch.parallel import ring, spmd
from roc_tpu_torch.parallel.spmd import SpmdTrainer
from roc_tpu_torch.train.config import Config

MESH8 = ["cpu"] * 8
LAYERS = [12, 8, 4]
OPT = dict(learning_rate=0.01, weight_decay=5e-4, eval_every=10**9,
           num_epochs=3)


def _synth(pkg):
    return pkg.synthetic("t", 200, 3.0, 12, 4, n_train=50, n_val=50,
                         n_test=50, seed=31)


@pytest.fixture(scope="module")
def ds():
    return _synth(datasets)


def _aggr(model, aggr):
    return aggr if model == "sage" else ""


@functools.lru_cache(maxsize=None)
def _roc_tpu_ring(model, aggr, dropout, parts=4, bf16=None):
    """roc_tpu's ring SpmdTrainer, 3 epochs: (losses, correct counts)."""
    extra = {}
    if bf16 is not None:
        extra = dict(bf16_storage=True, bf16_rounding=bf16[0],
                     bf16_exchange=bf16[1], aggregate_precision="fast")
    a = _aggr(model, aggr)
    cfg = JConfig(layers=LAYERS, dropout_rate=dropout, num_parts=parts,
                  exchange="ring", aggregate_backend="xla", model=model,
                  aggr=a, heads=2, edge_shard="off", **OPT, **extra)
    tr = JSpmd(cfg, _synth(jdatasets), jbuild(model, LAYERS, dropout, a,
                                              heads=2))
    assert tr.gdata.mode == "ring"
    losses = [float(tr.run_epoch()) for _ in range(3)]
    m = tr.evaluate()
    return losses, tuple(int(getattr(m, f)) for f in
                         ("train_correct", "val_correct", "test_correct"))


def _port(ds, model="gcn", aggr="", dropout=0.0, parts=4, **kw):
    a = _aggr(model, aggr)
    kw.setdefault("aggregate_backend", "xla")
    cfg = Config(layers=LAYERS, dropout_rate=dropout, num_parts=parts,
                 exchange="ring", model=model, aggr=a, heads=2,
                 device="cpu", **OPT, **kw)
    return SpmdTrainer(cfg, ds, build_model(model, LAYERS, dropout, a,
                                            heads=2), devices=MESH8)


def _run(tr):
    losses = [float(tr.run_epoch()) for _ in range(3)]
    m = tr.evaluate()
    return losses, tuple(int(getattr(m, f)) for f in
                         ("train_correct", "val_correct", "test_correct"))


# -- the groups ------------------------------------------------------------------

@pytest.mark.parametrize("parts", [2, 3, 4, 8])
def test_ring_groups_equal_roc_tpu(ds, parts):
    g = ds.graph
    jp = jpartition(JCsr(g.num_nodes, g.num_edges, g.row_ptr, g.col_idx),
                    parts)
    p = partition_graph(g, parts)
    want = jring.build_ring_groups(jp)
    got = ring.build_ring_groups(p)
    for f in ("ring_src", "ring_dst"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("parts,nproc", [(4, 2), (8, 4)])
def test_ring_groups_floors_across_processes(ds, parts, nproc):
    """Each simulated process groups its own parts; the allgathered floor
    gives every process the single-host group width, so the rows equal
    the full build's."""
    p = partition_graph(ds.graph, parts)
    full = jring.build_ring_groups_arrays(p.edge_src, p.edge_dst, parts,
                                          p.shard_nodes)
    L = parts // nproc
    ag = ThreadAllGather(nproc)
    out = [None] * nproc

    def run(i):
        ids = list(range(i * L, (i + 1) * L))
        out[i] = (ids, ring.build_ring_groups_arrays(
            p.edge_src[ids], p.edge_dst[ids], parts, p.shard_nodes,
            allgather=ag.for_process(i)))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(nproc)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    for ids, rm in out:
        assert np.array_equal(rm.ring_src, full.ring_src[ids])
        assert np.array_equal(rm.ring_dst, full.ring_dst[ids])


def test_ring_device_groups_hold_the_live_edges(ds):
    """Every group CSR reads its owner's rows; together they hold each
    part's live edges once (pad slots and pad edges dropped)."""
    p = partition_graph(ds.graph, 4)
    rm = ring.build_ring_groups(p)
    groups = ring.ring_device_groups(rm, p.num_valid, p.shard_nodes, "cpu")
    S = p.shard_nodes
    for i in range(4):
        got = []
        for q, csr in enumerate(groups[i]):
            if csr is None:
                continue
            dst = spmd._csr_dst(csr).numpy()
            got += list(zip(q * S + csr.col_idx.numpy().astype(np.int64),
                            dst))
        ne = int(p.num_edges_valid[i])
        want = list(zip(p.edge_src[i, :ne].astype(np.int64),
                        p.edge_dst[i, :ne].astype(np.int64)))
        assert sorted(got) == sorted(want)


# -- one ring sum, bitwise ----------------------------------------------------------

def _int_dataset(pkg, seed=3):
    ds = pkg.synthetic("ri", 160, 3.0, 6, 3, n_train=30, n_val=30,
                       n_test=30, seed=seed)
    rng = np.random.default_rng(seed)
    import dataclasses
    feats = rng.integers(-8, 9, size=ds.features.shape).astype(np.float32)
    return dataclasses.replace(ds, features=feats)


def _jax_aggregate(jtr, x, ct, aggr, exchange):
    """roc_tpu's per-shard GraphCtx aggregate inside its shard_map, and its
    VJP at ``ct``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from roc_tpu.parallel import spmd as jspmd
    S = jtr.part.shard_nodes
    gd = jtr.gdata
    specs = jax.tree.map(lambda a: PS("parts"), gd)

    def body(xb, gdb):
        return jspmd._shard_gctx(jspmd._squeeze_gd(gdb), S,
                                 exchange).aggregate(xb, aggr)

    f = jax.shard_map(body, mesh=jtr.mesh, in_specs=(PS("parts"), specs),
                      out_specs=PS("parts"))
    y, vjp = jax.vjp(lambda a: f(a, gd), jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(ct))[0])


def _pad_free_cotangent(tr, shape):
    """Integer cotangents, 0 on pad rows: a step's cotangent is 0 there
    (pad rows are masked out of the loss and only pad edges, which the
    port's CSRs drop and roc_tpu's keep, lead to them)."""
    ct = np.random.default_rng(1).integers(-4, 5, size=shape).astype(
        np.float32)
    S = tr.part.shard_nodes
    for i, nv in enumerate(tr.part.num_valid):
        ct[i * S + int(nv):(i + 1) * S] = 0
    return ct


def _port_aggregate(tr, x, ct, aggr):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tr.gctx.aggregate(xt, aggr)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    return y.detach().numpy(), g.numpy()


@pytest.mark.parametrize("aggr", ["sum", "avg", "max"])
def test_ring_sum_and_gradient_bitwise_roc_tpu(aggr):
    """The ring's owner-order adds (and max-of-maxes) on integer data,
    value and gradient, against roc_tpu's ``_ring_aggregate``; the
    gradient flows back through every visiting group's transpose."""
    cfgj = JConfig(layers=[6, 4, 3], dropout_rate=0.0, num_parts=4,
                   exchange="ring", aggregate_backend="xla",
                   edge_shard="off", eval_every=10**9)
    jtr = JSpmd(cfgj, _int_dataset(jdatasets), jbuild("gcn", [6, 4, 3]))
    tr = SpmdTrainer(Config(layers=[6, 4, 3], dropout_rate=0.0,
                            num_parts=4, exchange="ring", device="cpu",
                            aggregate_backend="binned",
                            aggregate_precision="exact", eval_every=10**9),
                     _int_dataset(datasets), build_model("gcn", [6, 4, 3]),
                     devices=MESH8)
    x = tr.x.numpy().copy()
    np.testing.assert_array_equal(x, np.asarray(jtr.x))
    ct = _pad_free_cotangent(tr, x.shape)
    y_j, g_j = _jax_aggregate(jtr, x, ct, aggr, "ring")
    y_t, g_t = _port_aggregate(tr, x, ct, aggr)
    assert np.array_equal(y_t.view(np.uint32), y_j.view(np.uint32))
    if aggr == "avg":
        # the quotients' cotangents are no longer integers: their sums
        # agree up to the order of the adds
        np.testing.assert_allclose(g_t, g_j, rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(g_t.view(np.uint32), g_j.view(np.uint32))


def test_ring_max_min_empty_rows_and_nan(ds):
    """Rows no group reaches come out 0 (not the identity); a NaN source
    still reaches its destinations."""
    tr = _port(ds, "sage", "max")
    x = torch.randn(tr.x.shape[0], 3)
    S = tr.part.shard_nodes
    x[3] = float("nan")
    for aggr in ("max", "min"):
        y = tr.gctx.aggregate(x, aggr)
        deg = tr.gdata.in_degree
        pad = torch.cat([torch.arange(int(nv), S) + i * S for i, nv in
                         enumerate(tr.part.num_valid)])
        assert torch.equal(y[pad], torch.zeros_like(y[pad]))
        assert torch.isfinite(y[pad]).all() and deg.numel() == y.shape[0]
        # part 0's row 3 is a source of some live row: NaN survives there
        src_rows = tr.part.edge_src[0, :int(tr.part.num_edges_valid[0])]
        reached = tr.part.edge_dst[0, :int(tr.part.num_edges_valid[0])][
            src_rows == 3]
        assert reached.size and torch.isnan(y[int(reached[0])]).all()


# -- the trainer against roc_tpu's ---------------------------------------------------

@pytest.mark.parametrize("model,aggr,dropout",
                         [("gcn", "", 0.0), ("gcn", "", 0.5),
                          ("sage", "avg", 0.0), ("sage", "max", 0.5),
                          ("gat", "", 0.0), ("gat", "", 0.5)])
def test_ring_trainer_matches_roc_tpu(ds, model, aggr, dropout):
    want_l, want_c = _roc_tpu_ring(model, aggr, dropout)
    tr = _port(ds, model, aggr, dropout)
    assert tr.gdata.mode == "ring" and tr.k == 1
    got_l, got_c = _run(tr)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_c == want_c


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_ring_kernel_backend_matches_roc_tpu(ds, model):
    """The kernel backend (each group's sum through ``aggregate_sum``,
    its plain version on the CPU) against roc_tpu's xla ring."""
    want_l, want_c = _roc_tpu_ring(model, "", 0.5)
    got_l, got_c = _run(_port(ds, model, "", 0.5,
                              aggregate_backend="binned",
                              aggregate_precision="exact"))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_c == want_c


@pytest.mark.parametrize("rounding,exchange", [
    ("nearest", "plain"), ("stochastic", "plain"),
    ("nearest", "compensated")])
def test_ring_bf16_wire_matches_roc_tpu(ds, rounding, exchange):
    """The carry rotates in the wire's format (each position's own
    stochastic bits) and is decoded at each step's boundary."""
    want_l, want_c = _roc_tpu_ring("gcn", "", 0.5,
                                   bf16=(rounding, exchange))
    tr = _port(ds, "gcn", "", 0.5, bf16_storage=True,
               bf16_rounding=rounding, bf16_exchange=exchange,
               aggregate_precision="fast")
    assert tr.gdata.xch == ("bf16", rounding, exchange)
    got_l, got_c = _run(tr)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    assert got_c == want_c


# -- refusals, banners, the wire -------------------------------------------------------

def test_ring_under_overcommit_is_refused(ds):
    cfg = Config(layers=LAYERS, num_parts=16, exchange="ring", device="cpu",
                 eval_every=10**9)
    with pytest.raises(SystemExit, match="supports the halo/allgather "
                       "vertex exchanges only"):
        SpmdTrainer(cfg, ds, build_model("gcn", LAYERS), devices=MESH8)


def test_ring_verbose_lines_and_wire_bytes(ds):
    err = io.StringIO()
    with redirect_stderr(err):
        tr = _port(ds, "gcn", "", 0.0, verbose=True)
    assert "# ring: 4 owner groups per part, Eo=" in err.getvalue()
    from roc_tpu.obs import channel as jchannel
    S = tr.part.shard_nodes
    widths = tr._aggregate_widths()
    assert tr.wire_bytes() == jchannel.wire_bytes_per_step(
        "ring", 4, S, widths) == 3 * S * 4 * sum(widths)
    assert not tr._balance_supported()
