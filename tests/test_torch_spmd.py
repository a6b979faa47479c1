"""The port's SPMD trainer (roc_tpu_torch.parallel) against roc_tpu's, on the
CPU: the JAX side runs its shard_map trainer on the 8 host devices of
tests/conftest.py, the port its parts on one CPU device, with the mesh
``["cpu"] * 8`` for roc_tpu's layout (k = P / 8 parts a position past 8).

Tolerances:
  halo maps, both builders, exchange index maps            element-equal
  the wire codec, 3 modes, values and cotangents           bitwise (NaN
                                                           payloads aside)
  3-epoch SpmdTrainer vs roc_tpu's (-aggr-backend xla)     1e-5 relative,
                                                           accuracy counts
                                                           equal
  halo overlap on vs off (the port, kernel backend)        1e-5 relative
  bf16 wire trainers vs roc_tpu's                          1e-4 relative
  -check-sharding                                          rtol 1e-3,
                                                           count_tol 0

The trainer runs use roc_tpu's SPMD test settings (test_parallel.py's
``cfg_for``: lr 0.01, weight decay 5e-4).  At the port's default decay,
0.05, one weight's gradient on this graph sits near zero, where Adam's
first step takes its sign: float reassociation between the sharded and
the single-device sums flips it in roc_tpu itself (its SPMD trainer's
loss leaves its own single-device trainer's by 4e-4 on the GAT case).
"""

import dataclasses
import functools
import io
import types
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.graph.partition import partition_graph as jpartition
from roc_tpu.models import build_model as jbuild
from roc_tpu.obs import channel as jchannel
from roc_tpu.parallel import budget as jbudget
from roc_tpu.parallel import halo as jhalo
from roc_tpu.parallel.spmd import SpmdTrainer as JSpmd
from roc_tpu.train.config import Config as JConfig
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.graph.partition import partition_graph
from roc_tpu_torch.models import build_model
from roc_tpu_torch.obs import channel
from roc_tpu_torch.parallel import budget, halo, spmd, wire
from roc_tpu_torch.parallel.check import (check_shard_consistency,
                                          predict_classes)
from roc_tpu_torch.parallel.mesh import make_mesh
from roc_tpu_torch.parallel.spmd import SpmdTrainer
from roc_tpu_torch.train.config import Config, parse_args
from roc_tpu_torch.train.driver import Trainer, make_trainer

MESH8 = ["cpu"] * 8
LAYERS = [12, 8, 4]
# roc_tpu's SPMD test settings (test_parallel.py:cfg_for)
OPT = dict(learning_rate=0.01, weight_decay=5e-4, eval_every=10**9,
           num_epochs=3)


def _synth(pkg):
    return pkg.synthetic("t", 200, 3.0, 12, 4, n_train=50, n_val=50,
                         n_test=50, seed=31)


@pytest.fixture(scope="module")
def ds():
    return _synth(datasets)


@functools.lru_cache(maxsize=None)
def _roc_tpu_run(model, parts, halo_on, dropout, bf16=None):
    """roc_tpu's SpmdTrainer, 3 epochs: (losses, (train, val, test)
    correct counts); each configuration built and run once per module."""
    kw = {"heads": 2} if model == "gat" else {}
    aggr = "max" if model == "sage" else ""
    extra = {}
    if bf16 is not None:
        extra = dict(bf16_storage=True, bf16_rounding=bf16[0],
                     bf16_exchange=bf16[1], aggregate_precision="fast")
    cfg = JConfig(layers=LAYERS, dropout_rate=dropout, num_parts=parts,
                  halo=halo_on, aggregate_backend="xla", model=model,
                  aggr=aggr, edge_shard="off", **OPT, **kw, **extra)
    tr = JSpmd(cfg, _synth(jdatasets),
               jbuild(model, LAYERS, dropout, aggr, heads=2))
    losses = [float(tr.run_epoch()) for _ in range(3)]
    m = tr.evaluate()
    return losses, tuple(int(getattr(m, f)) for f in
                         ("train_correct", "val_correct", "test_correct"))


def _port(ds, model="gcn", parts=4, halo_on=True, dropout=0.0,
          devices=MESH8, **kw):
    aggr = "max" if model == "sage" else ""
    kw.setdefault("aggregate_backend", "xla")
    cfg = Config(layers=LAYERS, dropout_rate=dropout, num_parts=parts,
                 halo=halo_on, model=model, aggr=aggr, heads=2,
                 device="cpu", **OPT, **kw)
    return SpmdTrainer(cfg, ds, build_model(model, LAYERS, dropout, aggr,
                                            heads=2), devices=devices)


def _run(tr):
    losses = [float(tr.run_epoch()) for _ in range(3)]
    m = tr.evaluate()
    return losses, tuple(int(getattr(m, f)) for f in
                         ("train_correct", "val_correct", "test_correct"))


# -- halo maps and the exchange's index maps ---------------------------------

@pytest.mark.parametrize("parts", [2, 3, 4, 8])
def test_halo_maps_equal_roc_tpu(ds, parts):
    from roc_tpu.graph.csr import Csr as JCsr
    g = ds.graph
    jp = jpartition(JCsr(g.num_nodes, g.num_edges, g.row_ptr, g.col_idx),
                    parts)
    p = partition_graph(g, parts)
    want = jhalo._build_halo_maps_numpy(jp)
    for got in (halo.build_halo_maps(p), halo._build_halo_maps_reference(p)):
        assert got.K == want.K
        assert got.halo_rows_total == want.halo_rows_total
        for f in ("send_idx", "edge_src_local"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    ref = jhalo._build_halo_maps_reference(jp)
    assert np.array_equal(ref.send_idx, want.send_idx)


def test_part_csr_is_the_host_transpose(ds):
    """part_csr's sort gives Csr.transpose's arrays (square), and the
    stable argsort's over a rectangular table, edge map included."""
    g = ds.graph
    got = [None if a is None else a.numpy() for a in halo.part_csr(
        g.col_idx, g.dst_idx, g.num_nodes, g.num_nodes, True)]
    order = g.transpose_order()
    t = g.transpose(order)
    t_pos = np.empty(order.size, np.int32)
    t_pos[order] = np.arange(order.size)
    for a, b in zip(got, (g.row_ptr, g.col_idx, t.row_ptr, t.col_idx,
                          t_pos)):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(2)
    S, T = 37, 300
    ed = np.sort(rng.integers(0, S, 2000))
    es = rng.integers(0, T, 2000)
    r, c, tr, tc, tp = halo.part_csr(es, ed, S, T, False)
    o = np.argsort(es, kind="stable")
    assert tp is None and np.array_equal(tc.numpy(), ed[o])
    assert np.array_equal(tr.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(es, minlength=T))]))
    assert np.array_equal(r.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(ed, minlength=S))]))
    assert np.array_equal(c.numpy(), es)


@pytest.mark.parametrize("parts,k", [(4, 1), (8, 2), (8, 4), (6, 3)])
def test_exchange_tables_rebuild_every_source(ds, parts, k):
    """Each part's table, read at its edges' table-local sources, gives the
    padded-global source rows: the send map and the receive map compose
    to the gather roc_tpu's all_to_all performs, at any k."""
    p = partition_graph(ds.graph, parts)
    hm = halo.build_halo_maps(p)
    S = p.shard_nodes
    x = torch.arange(parts * S, dtype=torch.float32)[:, None] * \
        torch.tensor([[1.0, -2.0]])
    for xch in (wire.FP32_WIRE, ("bf16", "nearest", "compensated")):
        gd = spmd.shard_graph(hm.edge_src_local, p.edge_dst,
                              p.num_edges_valid, p.in_degree, hm.send_idx,
                              S, k, "cpu", "xla", "exact", xch)
        for i, table in enumerate(spmd.exchange_tables(gd, x)):
            assert table.shape == (S + parts * hm.K, 2)
            ne = int(p.num_edges_valid[i])
            got = table[torch.as_tensor(hm.edge_src_local[i, :ne]).long()]
            want = x[torch.as_tensor(p.edge_src[i, :ne]).long()]
            # compensated: hi + lo of an integer below 2^16 is exact
            assert torch.equal(got, want)


# -- the wire codec ----------------------------------------------------------

_MODES = {"nearest": ("bf16", "nearest", "plain"),
          "stochastic": ("bf16", "stochastic", "plain"),
          "compensated": ("bf16", "nearest", "compensated")}


def _wire_values(D, B, H):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(D * B, H)) * 10.0 ** rng.integers(
        -30, 30, size=(D * B, H))).astype(np.float32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0,
                        np.finfo(np.float32).max, -np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny, 1e-45, 3.0],
                       np.float32)
    x.reshape(-1)[:special.size] = special
    x.reshape(-1)[-special.size:] = special
    return x


@pytest.mark.parametrize("mode", list(_MODES))
def test_wire_codec_bitwise_roc_tpu(mode):
    """_wire_down then _wire_up inside roc_tpu's shard_map (each of 8 mesh
    positions its own block; the stochastic bits folded from its
    axis_index) against the port's per-position encode, values and
    cotangents bitwise."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from roc_tpu.parallel import spmd as jspmd
    from roc_tpu.parallel.mesh import make_mesh as jmake_mesh

    D, B, H = 8, 24, 5
    xch = _MODES[mode]
    gd = types.SimpleNamespace(xch_dtype=xch[0], xch_round=xch[1],
                               xch_comp=xch[2])
    x = _wire_values(D, B, H)
    g = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    mesh = jmake_mesh(D)

    def body(xb):
        return jspmd._wire_up(jspmd._wire_down(xb, gd), gd, jnp.float32, H)

    def enc_body(xb):
        return jspmd._wire_down(xb, gd).astype(jnp.float32)

    sm = functools.partial(jax.shard_map, mesh=mesh, in_specs=PS("parts"),
                           out_specs=PS("parts"))
    j_up, vjp = jax.vjp(sm(body), jnp.asarray(x))
    j_ct = vjp(jnp.asarray(g))[0]
    j_enc = sm(enc_body)(jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    outs, encs = [], []
    for d, blk in enumerate(xt.split(B)):
        e = wire.wire_down(blk, xch, d)
        encs.append(e.detach().to(torch.float32))
        outs.append(wire.wire_up(e, xch, torch.float32, H))
    up = torch.cat(outs)
    (ct,) = torch.autograd.grad(up, xt, torch.from_numpy(g))

    def bits(a):
        # NaN payloads are the libraries' own (torch's bf16 cast makes
        # 0xFFFF, XLA's the canonical 0x7FC0): one pattern for every NaN
        a = np.asarray(a, np.float32)
        return np.where(np.isnan(a), np.uint32(0x7FC00000),
                        a.view(np.uint32))

    assert np.array_equal(bits(j_enc), bits(torch.cat(encs).numpy()))
    assert np.array_equal(bits(j_up), bits(up.detach().numpy()))
    assert np.array_equal(bits(j_ct), bits(ct.numpy()))


def test_sr_bits_are_jax_uint16_bits():
    import jax
    key = jax.random.fold_in(jax.random.PRNGKey(wire.SR_SEED), 3)
    want = np.asarray(jax.random.bits(key, (7, 33), jax.numpy.uint16))
    got = wire.sr_bits(7 * 33, 3, "cpu").numpy().reshape(7, 33)
    assert np.array_equal(got.view(np.uint16), want)


def test_stochastic_rounding_in_chunks_is_one_pass(monkeypatch):
    """The draw and the rounding run _CHUNK elements at a time: 7-element
    chunks give the one-pass bits."""
    x = torch.from_numpy(_wire_values(1, 24, 5))
    want = wire.sr_bf16(x, 2)
    monkeypatch.setattr(wire, "_CHUNK", 7)
    wire.clear_bits()
    got = wire.sr_bf16(x, 2)
    wire.clear_bits()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_bf16_compute_under_the_bf16_wire(ds):
    """-bf16 with -bf16-storage: x is bf16 (the wire passes it through)
    and the later layers fp32 (encoded): both paths in one step."""
    ref = _run(_port(ds, "gcn", 4, True, 0.5))
    for halo_on in (True, False):
        got = _run(_port(ds, "gcn", 4, halo_on, 0.5, use_bf16=True,
                         bf16_storage=True, aggregate_precision="fast"))
        np.testing.assert_allclose(got[0], ref[0], rtol=5e-2)


# -- the trainer against roc_tpu's --------------------------------------------

GCN_CASES = [(p, h, d) for p in (2, 4, 16, 32) for h in (True, False)
             for d in (0.0, 0.5)]


@pytest.mark.parametrize("parts,halo_on,dropout", GCN_CASES)
def test_gcn_trainer_matches_roc_tpu(ds, parts, halo_on, dropout):
    want_l, want_c = _roc_tpu_run("gcn", parts, halo_on, dropout)
    tr = _port(ds, "gcn", parts, halo_on, dropout)
    assert tr.k == max(1, parts // 8)
    got_l, got_c = _run(tr)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_c == want_c


@pytest.mark.parametrize("parts,dropout", [(2, 0.0), (2, 0.5), (4, 0.0),
                                           (4, 0.5)])
def test_halo_overlap_matches_roc_tpu_and_combined(ds, parts, dropout):
    """The local/remote split (kernel backend, k = 1; its plain versions
    on the CPU, in exact) against roc_tpu's halo run and against the
    port's combined-table run."""
    want_l, want_c = _roc_tpu_run("gcn", parts, True, dropout)
    on = _port(ds, "gcn", parts, True, dropout, aggregate_backend="binned",
               aggregate_precision="exact")
    off = _port(ds, "gcn", parts, True, dropout, aggregate_backend="binned",
                aggregate_precision="exact", halo_overlap=False)
    assert on.gdata.overlap and not off.gdata.overlap
    assert on.gdata.parts[0].csr is None     # sum-only: no table CSR
    l_on, c_on = _run(on)
    l_off, c_off = _run(off)
    np.testing.assert_allclose(l_on, l_off, rtol=1e-5)
    np.testing.assert_allclose(l_on, want_l, rtol=1e-5)
    assert c_on == c_off == want_c


@pytest.mark.parametrize("model", ["gat", "sage"])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_gat_and_sage_max_match_roc_tpu(ds, model, dropout):
    want_l, want_c = _roc_tpu_run(model, 4, True, dropout)
    got_l, got_c = _run(_port(ds, model, 4, True, dropout))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_c == want_c


def test_gat_kernel_backend_matches_xla(ds):
    """GAT on the kernel backend (the GAT kernels' plain twins, the CSR's
    edge map) and its halo overlap setting: the combined table stays for
    attention."""
    want = _run(_port(ds, "gat", 4, True, 0.5))
    tr = _port(ds, "gat", 4, True, 0.5, aggregate_backend="binned",
               aggregate_precision="exact")
    assert tr.gdata.parts[0].csr.t_pos is not None
    got = _run(tr)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == want[1]


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("halo_on", [True, False])
def test_bf16_wire_trainer_matches_roc_tpu(ds, mode, halo_on):
    """-bf16-storage: the exchanges move the codec's bf16 (roc_tpu at its
    fast precision, whose xla backend ignores the precision; the port's
    xla backend computes fp32 likewise)."""
    xch = _MODES[mode]
    want_l, want_c = _roc_tpu_run("gcn", 4, halo_on, 0.5,
                                  bf16=(xch[1], xch[2]))
    tr = _port(ds, "gcn", 4, halo_on, 0.5, bf16_storage=True,
               bf16_rounding=xch[1], bf16_exchange=xch[2],
               aggregate_precision="fast")
    assert tr.gdata.xch == xch
    got_l, got_c = _run(tr)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    assert got_c == want_c


# -- the check, the CLI, the routing ------------------------------------------

def test_check_sharding_passes(ds):
    cfg = Config(layers=LAYERS, num_parts=4, dropout_rate=0.0,
                 eval_every=10**9, device="cpu")
    m1, mp = check_shard_consistency(cfg, ds, build_model("gcn", LAYERS,
                                                          0.0),
                                     count_tol=0)
    assert int(m1.train_all) == int(mp.train_all) == 50
    t1 = Trainer(dataclasses.replace(cfg, num_parts=1), ds,
                 build_model("gcn", LAYERS, 0.0))
    tp = SpmdTrainer(cfg, ds, build_model("gcn", LAYERS, 0.0))
    assert np.array_equal(predict_classes(t1), predict_classes(tp))


def test_checker_catches_a_plan_bug(ds, monkeypatch):
    real = halo.build_halo_maps

    def broken(part):
        maps = real(part)
        send = maps.send_idx.copy()
        send[..., [0, 1]] = send[..., [1, 0]]   # reorder within pairs
        send[0, 1, 0] = 0                       # and corrupt one entry
        return halo.HaloMaps(maps.K, send, maps.edge_src_local,
                             maps.halo_rows_total)
    monkeypatch.setattr(spmd, "build_halo_maps", broken)
    cfg = Config(layers=LAYERS, num_parts=4, dropout_rate=0.0,
                 eval_every=10**9, device="cpu")
    with pytest.raises(AssertionError, match="shard-consistency"):
        check_shard_consistency(cfg, ds, build_model("gcn", LAYERS, 0.0))


def test_cli_trains_sharded_with_check(capsys):
    from roc_tpu_torch.__main__ import main
    err = io.StringIO()
    with redirect_stderr(err):
        rc = main(["-dataset", "roc-audit", "-layers", "8-16-4", "-e", "6",
                   "-parts", "4", "-check-sharding", "-device", "cpu", "-v"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[INFER][0] train_loss" in out and "[INFER][5]" in out
    assert "shard-consistency check passed (4 parts, halo=True)" in \
        err.getvalue()
    assert "# overcommit: 4 parts on 1 mesh position(s)" in err.getvalue()


def test_make_trainer_picks_spmd(ds):
    cfg = Config(layers=LAYERS, num_parts=4, device="cpu", eval_every=10**9)
    tr = make_trainer(cfg, ds, build_model("gcn", LAYERS))
    assert isinstance(tr, SpmdTrainer) and tr.k == 4
    assert tr.mesh == [torch.device("cpu")]
    assert make_mesh(4, MESH8) == [torch.device("cpu")] * 4
    assert make_mesh(16, MESH8) == [torch.device("cpu")] * 8


REFUSALS = {
    # ring and edge sharding run at k = 1 and are refused under
    # overcommit, as in roc_tpu; -multihost needs torchrun's environment
    "ring": (dict(exchange="ring"), "for ring/edge-shard"),
    "edge_shard_on": (dict(edge_shard="on"), "for ring/edge-shard"),
    "multihost": (dict(multihost=True), "-multihost reads torchrun"),
    "perhost_k4": (dict(perhost_load=True, filename="x"), "-perhost"),
    "non_divisible": (dict(num_parts=12), "multiple of the mesh"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_exit(ds, case, monkeypatch):
    from roc_tpu_torch.parallel import collectives
    for var in collectives.ENV:
        monkeypatch.delenv(var, raising=False)
    kw, match = REFUSALS[case]
    kw = dict(kw)
    parts = kw.pop("num_parts", 4)
    devices = MESH8 if case == "non_divisible" else None
    cfg = Config(layers=LAYERS, num_parts=parts, device="cpu",
                 eval_every=10**9, **kw)
    with pytest.raises(SystemExit, match=match):
        SpmdTrainer(cfg, ds, build_model("gcn", LAYERS), devices=devices)
    if case == "multihost":
        with pytest.raises(SystemExit, match=match):
            make_trainer(dataclasses.replace(cfg, num_parts=1), ds,
                         build_model("gcn", LAYERS))
    if case in ("ring", "edge_shard_on"):
        # one part a mesh position: the mode runs
        tr = SpmdTrainer(cfg, ds, build_model("gcn", LAYERS),
                         devices=MESH8)
        assert tr.gdata.mode == {"ring": "ring"}.get(case, "edge")
        assert np.isfinite(float(tr.run_epoch()))


def test_edge_shard_auto_over_the_tax_exits():
    """A hub-skewed graph whose padded-max tax passes 30 % at k = 1:
    roc_tpu turns on edge sharding there, and so does the port (it used
    to exit there): the run trains in edge mode; -edge-shard off runs the
    vertex path."""
    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.graph.datasets import Dataset
    from roc_tpu_torch.graph.lux import MASK_TRAIN, one_hot
    deg = np.concatenate([np.concatenate([np.ones(300, np.int64), [1300]])
                          for _ in range(6)])
    n = deg.size
    dst = np.repeat(np.arange(n), deg)
    g = from_edges(n, (dst * 7 + np.arange(dst.size)) % n, dst)
    rng = np.random.default_rng(5)
    lab = rng.integers(0, 4, size=n)
    dds = Dataset("drift", g, rng.normal(size=(n, 12)).astype(np.float32),
                  one_hot(lab, 4), lab, np.full(n, MASK_TRAIN, np.int32),
                  12, 4)
    cfg = Config(layers=LAYERS, num_parts=4, device="cpu", eval_every=10**9,
                 aggregate_backend="binned", aggregate_precision="exact")
    assert spmd.padded_max_tax(partition_graph(g, 4)) > 0.30
    auto = SpmdTrainer(cfg, dds, build_model("gcn", LAYERS), devices=MESH8)
    assert auto.gdata.mode == "edge"
    assert np.isfinite(float(auto.run_epoch()))
    tr = SpmdTrainer(dataclasses.replace(cfg, edge_shard="off"), dds,
                     build_model("gcn", LAYERS), devices=MESH8)
    assert tr.gdata.mode == "vertex"
    assert np.isfinite(float(tr.run_epoch()))
    # k > 1: overcommit is vertex-only, auto stays off (roc_tpu's rule)
    assert SpmdTrainer(cfg, dds, build_model("gcn", LAYERS)).gdata.mode == \
        "vertex"


def test_new_flags_parse_as_roc_tpu(monkeypatch):
    from roc_tpu.train.config import parse_args as jparse_args
    for var in ("ROC_BF16_ROUNDING", "ROC_BF16_EXCHANGE",
                "ROC_BALANCE_EVERY", "ROC_BALANCE_MIN_GAIN",
                "ROC_BALANCE_TRACE"):
        monkeypatch.delenv(var, raising=False)
    argv = ["-parts", "4", "-no-halo", "-no-halo-overlap", "-exchange",
            "allgather", "-check-sharding", "-bf16-rounding", "stochastic",
            "-bf16-exchange", "compensated", "-balance-every", "3",
            "-balance-min-gain", "0.1", "-balance-trace", "t.jsonl",
            "-perhost", "-multihost", "-edge-shard"]
    ours, ref = parse_args(argv), jparse_args(argv)
    for f in ("num_parts", "halo", "halo_overlap", "exchange",
              "check_sharding", "bf16_rounding", "bf16_exchange",
              "balance_every", "balance_min_gain", "balance_trace",
              "perhost_load", "multihost", "edge_shard"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.exchange_mode() == ref.exchange_mode() == "allgather"
    d, r = parse_args([]), jparse_args([])
    for f in ("halo", "halo_overlap", "exchange", "edge_shard",
              "bf16_rounding", "bf16_exchange", "balance_min_gain"):
        assert getattr(d, f) == getattr(r, f), f
    monkeypatch.setenv("ROC_BF16_ROUNDING", "stochastic")
    monkeypatch.setenv("ROC_BF16_EXCHANGE", "compensated")
    assert Config().bf16_rounding == JConfig().bf16_rounding == "stochastic"
    assert Config().bf16_exchange == JConfig().bf16_exchange == \
        "compensated"
    monkeypatch.setenv("ROC_BF16_ROUNDING", "up")
    for make in (Config, JConfig):
        with pytest.raises(SystemExit):
            make()


# -- wire bytes, budget -------------------------------------------------------

def test_wire_bytes_and_obs_record_match_roc_tpu(ds, tmp_path):
    for args in [("halo", 4, 56, [8, 4], 30, "fp32", "plain"),
                 ("allgather", 16, 16, [256, 41], 0, "bf16", "plain"),
                 ("halo", 8, 32, [64], 9, "bf16", "compensated"),
                 ("ring", 8, 32, [64], 0, "fp32", "plain")]:
        assert channel.wire_bytes_per_step(*args[:4], send_cols=args[4],
                                           xch_dtype=args[5],
                                           xch_comp=args[6]) == \
            jchannel.wire_bytes_per_step(*args[:4], send_cols=args[4],
                                         xch_dtype=args[5],
                                         xch_comp=args[6])
    from roc_tpu_torch.obs import load_jsonl
    from roc_tpu_torch.fault import inject
    tr = _port(ds, "gcn", 4, True, 0.0, obs=True,
               obs_dir=str(tmp_path / "obs"))
    try:
        tr.config.num_epochs = 1
        tr.train(print_fn=lambda *_: None)
    finally:
        inject.configure("")
    recs = [r for r in load_jsonl(str(tmp_path / "obs" / "metrics.jsonl"))
            if r["type"] == "metrics"]
    assert recs[0]["wire_bytes"] == tr.wire_bytes() > 0
    p = tr.part
    assert recs[0]["edges_per_shard"] == [
        int(p.in_degree[i].sum()) for i in range(4)]
    assert tr.wire_bytes() == 4 * tr.gdata.K * 4 * (8 + 4)


def test_budget_terms_equal_roc_tpu():
    args = (232965, 114615892, 602, 256, 41, 4)
    ours = budget.estimate_device_bytes(*args)
    ref = jbudget.estimate_device_bytes(*args, backend="xla")
    for f in ("features", "activations", "labels_mask", "params", "edges",
              "halo_table"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.plans > 0 and ours.staging > 0
    assert budget.estimate_device_bytes(*args, precision="exact").staging \
        == 0
    assert budget.device_capacity_bytes("cpu") == budget.H100_SXM_BYTES


def test_bf16_wire_under_stream_refused(ds):
    cfg = Config(layers=LAYERS, num_parts=4, stream=True, device="cpu",
                 bf16_storage=True, bf16_rounding="stochastic")
    with pytest.raises(SystemExit, match="nearest/plain wire"):
        make_trainer(cfg, ds, build_model("gcn", LAYERS))
