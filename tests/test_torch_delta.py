"""Dynamic-graph deltas of the port (roc_tpu_torch/serve/delta.py) against
roc_tpu's (roc_tpu/serve/delta.py) on the same seeded NumPy batches.

- journal: files written by either package open in the other and are
  byte-identical for the same batches; the recovery matrix (torn tail, bit
  rot, gap, bad magic, each kill window, the disabled journal) as
  tests/test_delta.py pins it for roc_tpu;
- patch: after >= 1000 mixed batches the port's CSR is bitwise
  ``from_edges`` of its live edges and of roc_tpu's manager's, the
  counters equal roc_tpu's (except cells_patched, replans and swaps, which
  count another structure), and the aggregation over the patched CSR is
  bitwise roc_tpu's binned aggregation over its patched plans (integer
  features: exact sums, any order);
- engine: served rows within 32 norm-ULPs of roc_tpu's binned engine after
  the same churn (exact; roc_tpu's kernels interpreted), bitwise equal to a
  fresh port engine on the mutated graph; the escalation while serving,
  close during an in-flight mutation, rejection, the warn-once no-op, the
  refusals.

Tolerances: bitwise everywhere but the served rows against roc_tpu
(<= 32 norm-ULPs: max |a - b| over the max-abs, in fp32 ULPs; its binned
cells sum in another order).
"""

import dataclasses
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from roc_tpu.graph.csr import from_edges as jfrom_edges
from roc_tpu.graph.csr import with_edge_delta as jwith_edge_delta
from roc_tpu_torch.fault import inject
from roc_tpu_torch.graph.csr import from_edges, with_edge_delta
from roc_tpu_torch.obs.ledger import get_ledger
from roc_tpu_torch.obs.watchdog import PerfWatchdog
from roc_tpu_torch.ops import DeviceCsr, scatter_gather
from roc_tpu_torch.ops.aggregate import csr_build_count
from roc_tpu_torch.serve.delta import (HEADROOM_EDGES, DeltaError,
                                       DeltaJournal, DeltaJournalError,
                                       DeltaManager)
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.graph_data import dense_graph_data

CPU = torch.device("cpu")
N_NODES = 96
N_EDGES = 200
EPS32 = float(np.finfo(np.float32).eps)

# edges guaranteed fresh against _graph()'s 0..63 base
_F1 = np.asarray([[70, 71], [72, 73]])
_F2 = np.asarray([[80, 81]])


@pytest.fixture(autouse=True)
def _binned_runs_under_jax_0_9(monkeypatch):
    """run_binned's one-shot eager warning calls jax.core.trace_state_clean,
    which jax 0.9.0 no longer exports (ROADMAP queue C)."""
    from roc_tpu.ops.pallas import binned
    monkeypatch.setattr(binned, "_EAGER_WARNED", [True])


def _graph(seed=3, n=N_NODES, e=N_EDGES):
    # base edges on nodes 0..63: an edge touching a node >= 64 is fresh
    rng = np.random.default_rng(seed)
    return from_edges(n, rng.integers(0, 64, e), rng.integers(0, 64, e))


def _manager(csr, journal_path, **kw):
    holder = {"gd": dense_graph_data(csr, "kernel", "exact", CPU,
                                     transpose=False)}
    mgr = DeltaManager(lambda: holder["gd"],
                       lambda g: holder.__setitem__("gd", g),
                       threading.RLock(), csr.num_nodes,
                       journal_path=journal_path, **kw)
    return holder, mgr


def _jax_gdata(s, d, n):
    import jax.numpy as jnp

    from roc_tpu.ops.aggregate import BinnedPlans
    from roc_tpu.ops.pallas import binned
    from roc_tpu.train.driver import DenseGraphData
    s, d = np.asarray(s, np.int64), np.asarray(d, np.int64)
    fwd = binned.build_binned_plan(s, d, n, n, tuned_ok=False)
    bwd = binned.build_binned_plan(d, s, n, n, tuned_ok=False)
    return DenseGraphData(
        edge_src=jnp.asarray(s, jnp.int32),
        edge_dst=jnp.asarray(d, jnp.int32),
        in_degree=jnp.asarray(np.bincount(d, minlength=n), jnp.float32),
        plans=BinnedPlans(fwd=fwd, bwd=bwd),
        backend="binned", precision="exact")


def _jax_manager(csr, journal_path):
    from roc_tpu.serve.delta import DeltaManager as JDeltaManager
    holder = {"gd": _jax_gdata(csr.col_idx, csr.dst_idx, csr.num_nodes)}
    mgr = JDeltaManager(lambda: holder["gd"],
                        lambda g: holder.__setitem__("gd", g),
                        threading.RLock(), csr.num_nodes,
                        journal_path=journal_path)
    return holder, mgr


def _csr_bytes(holder):
    c = holder["gd"].csr
    return c.row_ptr.numpy().tobytes() + c.col_idx.numpy().tobytes()


def _assert_csr_is(holder, src, dst, n=N_NODES):
    want = DeviceCsr.from_csr(from_edges(n, src, dst), CPU, transpose=False)
    got = holder["gd"].csr
    assert torch.equal(got.row_ptr, want.row_ptr)
    assert torch.equal(got.col_idx, want.col_idx)
    assert torch.equal(holder["gd"].in_degree,
                       torch.diff(want.row_ptr).to(torch.float32))


def _quiet_apply(mgr, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return mgr.apply(*a, **kw)


def _rec(n):
    return (np.arange(2 * n, dtype=np.int64).reshape(n, 2),
            np.zeros((0, 2), np.int64))


# -- journal: cross-package bytes and the recovery matrix -------------------

@pytest.mark.parametrize("writer", ["port", "roc_tpu"])
def test_journal_opens_across_packages_and_bytes_match(tmp_path, writer):
    from roc_tpu.serve.delta import DeltaJournal as JDeltaJournal
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, 500, (k, 2)), rng.integers(0, 500, (j, 2)))
               for k, j in ((3, 0), (0, 2), (5, 5), (1, 0))]
    paths = {}
    for name, cls in (("port", DeltaJournal), ("roc_tpu", JDeltaJournal)):
        paths[name] = str(tmp_path / f"{name}.wal")
        j = cls(paths[name])
        for seq, (a, r) in enumerate(batches, 1):
            j.append(seq, a, r)
        j.close()
    with open(paths["port"], "rb") as f1, open(paths["roc_tpu"], "rb") as f2:
        assert f1.read() == f2.read()
    reader = JDeltaJournal if writer == "port" else DeltaJournal
    j = reader(paths[writer])
    assert [r[0] for r in j.records] == [1, 2, 3, 4]
    for (seq, a, r), (wa, wr) in zip(j.records, batches):
        np.testing.assert_array_equal(a, wa.reshape(-1, 2))
        np.testing.assert_array_equal(r, wr.reshape(-1, 2))
    j.close()


def test_journal_roundtrip_and_truncate(tmp_path):
    p = str(tmp_path / "j.wal")
    j = DeltaJournal(p)
    for seq in (1, 2, 3):
        j.append(seq, *_rec(seq))
    j.close()
    j2 = DeltaJournal(p)
    assert [r[0] for r in j2.records] == [1, 2, 3]
    assert j2.base_seq == 0 and j2.last_seq == 3
    assert [r[0] for r in j2.records_after(1)] == [2, 3]
    j2.truncate_to(3)
    j2.close()
    j3 = DeltaJournal(p)
    assert j3.base_seq == 3 and j3.records == []
    j3.close()


def test_journal_torn_tail_truncated(tmp_path):
    p = str(tmp_path / "j.wal")
    j = DeltaJournal(p)
    j.append(1, *_rec(2))
    j.close()
    good = os.path.getsize(p)
    with open(p, "ab") as f:
        f.write(b"\x40\x00\x00\x00half")
    j2 = DeltaJournal(p)
    assert [r[0] for r in j2.records] == [1]
    assert j2.torn_bytes == 8 and os.path.getsize(p) == good
    j2.append(2, *_rec(1))       # appends land after the truncation
    j2.close()
    assert [r[0] for r in DeltaJournal(p).records] == [1, 2]


def test_journal_bitrot_is_typed_error(tmp_path):
    p = str(tmp_path / "j.wal")
    j = DeltaJournal(p)
    for seq in (1, 2):
        j.append(seq, *_rec(2))
    j.close()
    data = bytearray(open(p, "rb").read())
    data[24] ^= 0xFF             # inside record 1's payload
    open(p, "wb").write(bytes(data))
    with pytest.raises(DeltaJournalError, match="bit rot"):
        DeltaJournal(p)


def test_journal_sequence_gap_is_typed_error(tmp_path):
    p = str(tmp_path / "j.wal")
    j = DeltaJournal(p)
    j.append(1, *_rec(1))
    j.append(3, *_rec(1))        # seq 2 lost
    j.close()
    with pytest.raises(DeltaJournalError, match="sequence gap"):
        DeltaJournal(p)


@pytest.mark.parametrize("damage,match", [
    (lambda d: b"XXXX" + d[4:], "bad magic"),
    (lambda d: d[:4] + b"\x01" + d[5:], "header CRC"),
    (lambda d: d[:7], "truncated header")])
def test_journal_bad_magic_and_header(tmp_path, damage, match):
    p = str(tmp_path / "j.wal")
    DeltaJournal(p).close()
    data = open(p, "rb").read()
    open(p, "wb").write(damage(data))
    with pytest.raises(DeltaJournalError, match=match):
        DeltaJournal(p)


@pytest.mark.parametrize("site,recorded", [
    ("delta.journal.kill_record", False),   # lost before the WAL: gone
    ("delta.journal.kill_fsync", True),     # written + flushed: replays
    ("delta.journal.kill_ack", True),       # durable, patch never ran
])
def test_journal_kill_windows_replay_exactly(tmp_path, site, recorded):
    csr = _graph()
    jp = str(tmp_path / "j.wal")
    holder, mgr = _manager(csr, jp)
    _quiet_apply(mgr, _F1, None)
    inject.configure(f"seed=2,{site}=1")
    try:
        with pytest.raises(inject.SimulatedCrash):
            _quiet_apply(mgr, _F2, None)
    finally:
        inject.configure("")
    holder2, mgr2 = _manager(csr, jp)
    oh, om = _manager(csr, str(tmp_path / "oracle.wal"))
    _quiet_apply(om, _F1, None)
    if recorded:
        _quiet_apply(om, _F2, None)
    assert mgr2.applied_seq == om.applied_seq
    assert mgr2.counters["replayed"] == (2 if recorded else 1)
    assert _csr_bytes(holder2) == _csr_bytes(oh)
    for m in (mgr2, om):
        m.close()


def _escalating_batch(k=80):
    i = np.arange(k)
    return np.stack([64 + i % 32, (7 * i + 1) % N_NODES], 1)


@pytest.mark.parametrize("site", ["delta.swap.kill_pre",
                                  "delta.swap.kill_post"])
def test_swap_kill_windows_replay_exactly(tmp_path, site):
    csr = _graph()
    jp = str(tmp_path / "j.wal")
    holder, mgr = _manager(csr, jp, headroom=16)
    big = _escalating_batch()
    inject.configure(f"seed=2,{site}=1")
    try:
        with pytest.raises(DeltaError) as ei:
            _quiet_apply(mgr, big, None, wait_replan=True)
        assert isinstance(ei.value.__cause__, inject.SimulatedCrash)
    finally:
        inject.configure("")
    mgr.close()
    holder2, mgr2 = _manager(csr, jp, headroom=16)
    oh, om = _manager(csr, str(tmp_path / "oracle.wal"), headroom=16)
    _quiet_apply(om, big, None, wait_replan=True)
    assert mgr2.stats()["rebuilt"] and mgr2.applied_seq == om.applied_seq
    assert _csr_bytes(holder2) == _csr_bytes(oh)
    _assert_csr_is(holder2, *om._live_edges())
    for m in (mgr2, om):
        m.close()


@pytest.mark.parametrize("site", ["delta.ckpt.kill_tmp",
                                  "delta.ckpt.kill_rename",
                                  "delta.ckpt.kill_snap"])
def test_checkpoint_kill_windows_consistent(tmp_path, site):
    csr = _graph()
    jp = str(tmp_path / "j.wal")
    holder, mgr = _manager(csr, jp)
    _quiet_apply(mgr, _F1, None)
    _quiet_apply(mgr, None, np.asarray([[70, 71]]))
    inject.configure(f"seed=2,{site}=1")
    try:
        with pytest.raises(inject.SimulatedCrash):
            mgr.checkpoint()
    finally:
        inject.configure("")
    holder2, mgr2 = _manager(csr, jp)
    oh, om = _manager(csr, str(tmp_path / "oracle.wal"))
    _quiet_apply(om, _F1, None)
    _quiet_apply(om, None, np.asarray([[70, 71]]))
    assert mgr2.applied_seq == om.applied_seq
    assert _csr_bytes(holder2) == _csr_bytes(oh)
    for m in (mgr2, om):
        m.close()


def test_journal_disabled_demonstrably_loses_deltas(tmp_path):
    csr = _graph()
    holder, mgr = _manager(csr, None)          # volatile: no WAL
    _quiet_apply(mgr, _F1, None)
    mutated = _csr_bytes(holder)
    assert mgr.stats()["journal"] is None
    mgr.close()
    holder2, mgr2 = _manager(csr, None)
    assert _csr_bytes(holder2) != mutated
    assert _csr_bytes(holder2) == _csr_bytes(
        {"gd": dense_graph_data(csr, "kernel", "exact", CPU,
                                transpose=False)})
    mgr2.close()


# -- snapshots across packages ----------------------------------------------

def test_port_restores_from_roc_tpu_snapshot_and_journal(tmp_path):
    """roc_tpu checkpoints (its plan-cell snapshot + truncated journal),
    applies more batches; the port opens the pair through the snapshot's
    live_src / live_dst and replays the tail to roc_tpu's live edges."""
    csr = _graph()
    jp = str(tmp_path / "j.wal")
    jh, jm = _jax_manager(csr, jp)
    _quiet_apply(jm, _F1, None)
    _quiet_apply(jm, None, np.asarray([[70, 71]]))
    jm.checkpoint()
    _quiet_apply(jm, _F2, np.asarray([[int(csr.col_idx[0]),
                                       int(csr.dst_idx[0])]]))
    want = jm._live_edges()
    jm.close()
    holder, mgr = _manager(csr, jp)
    assert mgr.applied_seq == 3 and mgr.counters["replayed"] == 1
    _assert_csr_is(holder, *want)
    mgr.close()


def test_save_arrays_open_across_packages(tmp_path):
    from roc_tpu.train import checkpoint as jcheckpoint
    arrays = {"a": np.arange(12, dtype=np.int64).reshape(3, 4),
              "b": np.asarray([1.5, -2.0], np.float32)}
    extra = {"kind": "delta-snapshot", "seq": 4}
    for save, load in ((checkpoint.save_arrays, jcheckpoint.load_arrays),
                       (jcheckpoint.save_arrays, checkpoint.load_arrays)):
        p = str(tmp_path / "s.npz")
        save(p, arrays, extra, site="delta.ckpt")
        got, got_extra = load(p)
        assert got_extra == extra and set(got) == set(arrays)
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])
    data = bytearray(open(p, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(p, "wb").write(bytes(data))
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.load_arrays(p)


# -- the patch: >= 1000 mixed batches against roc_tpu's manager -------------

def test_thousand_batches_bitwise_vs_roc_tpu():
    from roc_tpu.ops.pallas import binned
    csr = _graph(seed=11)
    n = csr.num_nodes
    holder, mgr = _manager(csr, None, headroom=32)
    jh, jm = _jax_manager(jfrom_edges(n, csr.col_idx, csr.dst_idx), None)
    rng = np.random.default_rng(4)
    builds0 = csr_build_count()
    pending = []
    for i in range(1000):
        adds = rng.integers(0, n, (int(rng.integers(0, 6)), 2))
        rets = None
        if len(pending) >= 30 or (pending and rng.random() < 0.2):
            k = min(len(pending), int(rng.integers(1, 6)))
            rets = np.asarray([pending.pop(0) for _ in range(k)])
            if rng.random() < 0.1:          # a retire of a dead edge
                rets = np.concatenate([rets, [[90, 91]]])
        r = _quiet_apply(mgr, adds, rets, wait_replan=True)
        jr = _quiet_apply(jm, adds, rets, wait_replan=True)
        assert r["seq"] == jr["seq"]
        pending.extend(map(tuple, adds.tolist()))
    st, jst = mgr.stats(), jm.stats()
    # rebuilt follows the replans: set once the ladder has run
    differ = {k for k in st if st[k] != jst[k]}
    assert differ <= {"cells_patched", "replans", "swaps", "rebuilt"}
    assert st["batches"] == 1000 and st["applied_adds"] > 500
    assert st["noop_adds"] > 0 and st["noop_retires"] > 0
    assert st["replans"] == st["swaps"] >= 1     # the ladder ran too
    assert csr_build_count() - builds0 == st["replans"]
    live = mgr._live_edges()
    _assert_csr_is(holder, *live)
    _assert_csr_is(holder, *jm._live_edges())
    assert sorted(zip(*map(np.ndarray.tolist, live))) == \
        sorted(zip(*map(np.ndarray.tolist, jm._live_edges())))
    # integer features: the port's sum over its patched CSR and roc_tpu's
    # binned sum over its patched plan are exact, so bitwise equal
    x = rng.integers(-8, 9, (n, 16)).astype(np.float32)
    got = scatter_gather(torch.from_numpy(x), holder["gd"].csr, "sum",
                         "exact")
    want = binned.run_binned(x, jh["gd"].plans.fwd, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(holder["gd"].in_degree.numpy(),
                                  np.asarray(jh["gd"].in_degree))
    mgr.close()
    jm.close()


def test_patch_path_alternates_two_buffers_and_places_no_csr():
    csr = _graph()
    holder, mgr = _manager(csr, None)
    assert mgr.capacity == N_EDGES + HEADROOM_EDGES
    ptrs = []
    builds0 = csr_build_count()
    for k in range(4):
        _quiet_apply(mgr, np.asarray([[64 + k, 70]]), None)
        ptrs.append(int(holder["gd"].csr.col_idx.data_ptr()))
        assert ptrs[-1] == mgr.buffer_ptrs()[0]
    assert ptrs[0] == ptrs[2] != ptrs[1] == ptrs[3]
    assert csr_build_count() == builds0
    lp = mgr.last_patch
    assert lp["rows"] == 1 and lp["bytes_to_device"] == \
        8 * (N_NODES + 1) + 4 * (int(holder["gd"].in_degree[70]) + 1) + 8
    mgr.close()


def test_retire_then_readd_and_within_batch_ordering(tmp_path):
    csr = _graph()
    holder, mgr = _manager(csr, str(tmp_path / "j.wal"))
    e = (int(csr.col_idx[0]), int(csr.dst_idx[0]))
    r = _quiet_apply(mgr, None, np.asarray([e]))
    assert r["applied_retires"] == 1
    r = _quiet_apply(mgr, np.asarray([e]), None)     # re-add after retire
    assert r["applied_adds"] == 1
    r = _quiet_apply(mgr, np.asarray([[70, 71]]), np.asarray([[70, 71]]))
    assert r["applied_adds"] == 1 and r["applied_retires"] == 1
    live_s, live_d = mgr._live_edges()
    assert not ((live_s == 70) & (live_d == 71)).any()
    # the re-added edge went to the end of its row (roc_tpu's order)
    row = holder["gd"].csr
    d = e[1]
    lo, hi = int(row.row_ptr[d]), int(row.row_ptr[d + 1])
    assert int(row.col_idx[hi - 1]) == e[0] and hi > lo
    mgr.close()


def test_with_edge_delta_oracle_matches_roc_tpu():
    csr = _graph()
    jcsr = jfrom_edges(N_NODES, csr.col_idx, csr.dst_idx)
    e = [int(csr.col_idx[5]), int(csr.dst_idx[5])]
    add = [[70, 71], [70, 71], e]
    ret = [[70, 71], e]
    g2 = with_edge_delta(csr, add=add, retire=ret)
    j2 = jwith_edge_delta(jcsr, add=add, retire=ret)
    assert g2.num_edges == csr.num_edges + 1
    np.testing.assert_array_equal(g2.row_ptr, j2.row_ptr)
    np.testing.assert_array_equal(g2.col_idx, j2.col_idx)
    with pytest.raises(KeyError):
        with_edge_delta(csr, retire=[[95, 94]])


# -- validation, idempotence, counters, obs ---------------------------------

def test_rejection_is_typed_and_never_journaled(tmp_path):
    csr = _graph()
    holder, mgr = _manager(csr, str(tmp_path / "j.wal"))
    before = _csr_bytes(holder)
    for bad_add in ([[0, N_NODES]], [[-1, 0]],
                    np.asarray([[0.5, 1.5]], np.float64)):
        with pytest.raises(DeltaError):
            mgr.apply(np.asarray(bad_add), None)
    assert mgr.journal.records == [] and mgr.applied_seq == 0
    assert _csr_bytes(holder) == before, "rejected batch touched the CSR"
    assert mgr.stats()["rejected"] == 3
    mgr.close()


def test_idempotent_noops_counted_and_warned_once(tmp_path):
    csr = _graph()
    holder, mgr = _manager(csr, str(tmp_path / "j.wal"))
    live = (int(csr.col_idx[0]), int(csr.dst_idx[0]))
    with pytest.warns(RuntimeWarning, match="idempotent"):
        r = mgr.apply(np.asarray([live]), np.asarray([[90, 91]]))
    assert r["mode"] == "noop"
    assert r["noop_adds"] == 1 and r["noop_retires"] == 1
    assert mgr.applied_seq == 0 and mgr.journal.records == []
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # warned ONCE
        mgr.apply(np.asarray([live]), None)
    st = mgr.stats()
    assert st["noop_adds"] == 2 and st["noop_retires"] == 1
    assert st["batches"] == 2
    mgr.close()


def test_watchdog_delta_ewma_and_verdict_match_roc_tpu():
    from roc_tpu.obs.watchdog import PerfWatchdog as JPerfWatchdog
    wd, jwd = PerfWatchdog(ratio=2.0, warmup=2), \
        JPerfWatchdog(ratio=2.0, warmup=2)
    for i, t in enumerate((5.0, 0.010, 0.011, 0.009, 0.500, 0.012, 0.3)):
        assert wd.observe_delta(i, t) == jwd.observe_delta(i, t)
    assert wd.verdict() == jwd.verdict() == "delta-apply"
    for w in (wd, jwd):
        w.alerts.append({"kind": "serve-latency"})
    assert wd.verdict() == jwd.verdict() == "serve-latency"
    state = wd.state_dict()
    assert set(state) == set(jwd.state_dict())
    wd2 = PerfWatchdog()
    wd2.load_state(jwd.state_dict())
    assert wd2.state_dict() == state


def test_delta_counters_and_ledger_pair(tmp_path):
    csr = _graph()
    holder, mgr = _manager(csr, str(tmp_path / "j.wal"))
    _quiet_apply(mgr, _F2, None)
    st = mgr.stats()
    assert st["batches"] == 1 and st["applied_adds"] == 1
    assert st["seq"] == 1 and st["live_edges"] == N_EDGES + 1
    assert st["cells_patched"] == 1     # one row rewritten
    paired = [rec for kind, rec in get_ledger().records
              if kind == "measurement" and rec["model"] == "delta-apply"
              and "ratio" in rec]
    assert paired
    mgr.close()


def test_concurrent_apply_vs_close(tmp_path):
    """Applies serialize under _mu; each fully commits or raises
    DeltaError("closed"); the committed seqs form a dense prefix, which a
    restart replays exactly."""
    csr = _graph()
    jp = str(tmp_path / "j.wal")
    holder, mgr = _manager(csr, jp)
    committed = [[] for _ in range(3)]
    surprises = []
    started = threading.Barrier(4)

    def mutate(k):
        edge = np.asarray([[64 + k, 80 + k]])
        started.wait(10.0)
        for i in range(10_000):
            try:
                r = _quiet_apply(mgr, edge if i % 2 == 0 else None,
                                 edge if i % 2 == 1 else None)
            except DeltaError as e:
                assert "closed" in str(e), e
                return
            except BaseException as e:
                surprises.append(repr(e))
                return
            committed[k].append(r["seq"])

    threads = [threading.Thread(target=mutate, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    started.wait(10.0)
    time.sleep(0.1)
    mgr.close()
    for t in threads:
        t.join(30.0)
    assert not any(t.is_alive() for t in threads)
    assert surprises == []
    seqs = sorted(s for per in committed for s in per)
    assert seqs and seqs == list(range(1, len(seqs) + 1))
    holder2, mgr2 = _manager(csr, jp)
    assert mgr2.applied_seq == len(seqs)
    _assert_csr_is(holder2, *mgr2._live_edges())
    mgr2.close()


# -- the engine --------------------------------------------------------------

def _cfg(**kw):
    from roc_tpu_torch.train.config import Config
    base = dict(dataset="roc-audit", layers=[8, 16, 4], dropout_rate=0.0,
                model="gcn", aggregate_backend="binned", serve_batch=8,
                serve_wait_ms=1.0, aggregate_precision="exact")
    base.update(kw)
    return Config(**base)


def _engine(ds, delta_journal, start_queue=False, cfg=None, ckpt=None):
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.serve import ServeEngine
    cfg = cfg or _cfg()
    m = build_model(cfg.model, cfg.layers, cfg.dropout_rate, cfg.aggr,
                    heads=cfg.heads)
    return ServeEngine(cfg, ds, m, checkpoint_path=ckpt,
                       start_queue=start_queue, delta_journal=delta_journal,
                       device="cpu")


def _norm_ulps(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (
        max(float(np.abs(a).max()), 1e-30) * EPS32)


def test_engine_served_rows_after_churn(tmp_path):
    """The same churn through the port's engine and roc_tpu's binned
    engine (exact): <= 32 norm-ULPs between them, and the port's rows
    bitwise a fresh port engine's on the mutated graph."""
    from roc_tpu.graph import datasets as jdatasets
    from roc_tpu.models import build_model as jbuild_model
    from roc_tpu.serve import ServeEngine as JServeEngine
    from roc_tpu.train.config import Config as JConfig
    from roc_tpu_torch.graph import datasets
    ds = datasets.get("roc-audit", seed=1)
    n = ds.graph.num_nodes
    jcfg = JConfig(dataset="roc-audit", layers=[8, 16, 4], dropout_rate=0.0,
                   model="gcn", aggregate_backend="binned", serve_batch=8,
                   serve_wait_ms=1.0, aggregate_precision="exact")
    jm = jbuild_model("gcn", jcfg.layers, 0.0, jcfg.aggr)
    jeng = JServeEngine(jcfg, jdatasets.get("roc-audit", seed=1), jm,
                        start_queue=False,
                        delta_journal=str(tmp_path / "jax.wal"))
    ckpt = str(tmp_path / "p.npz")
    checkpoint.save(ckpt, {k: np.asarray(v)
                           for k, v in jeng.bundle.params.items()})
    eng = _engine(ds, str(tmp_path / "j.wal"), ckpt=ckpt)
    try:
        rng = np.random.default_rng(9)
        pending = []
        builds0 = csr_build_count()
        for _ in range(30):
            adds = rng.integers(0, n, (2, 2))
            rets = None
            if len(pending) >= 8:
                rets = np.asarray([pending.pop(0), pending.pop(0)])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                r = eng.apply_delta(adds, rets)
                jr = jeng.apply_delta(adds, rets)
            assert r["seq"] == jr["seq"]
            pending.extend(map(tuple, adds.tolist()))
        assert csr_build_count() == builds0
        ids = np.arange(n, dtype=np.int32)
        served = eng._serve_rows(ids)
        jserved = jeng._serve_rows(ids)
        assert _norm_ulps(jserved, served) <= 32
        live = eng.deltas._live_edges()
        ds2 = dataclasses.replace(ds, graph=from_edges(n, *live))
        fresh = _engine(ds2, None, ckpt=ckpt)
        try:
            np.testing.assert_array_equal(served, fresh._serve_rows(ids))
        finally:
            fresh.close()
        st = eng.stats()["deltas"]
        jst = jeng.delta_stats()
        assert {k for k in st if st[k] != jst[k]} <= {
            "cells_patched", "journal"}
    finally:
        eng.close()
        jeng.close()


def test_capacity_exhaustion_replan_while_serving(tmp_path, monkeypatch):
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.serve import delta as delta_mod
    monkeypatch.setattr(delta_mod, "HEADROOM_EDGES", 64)
    ds = datasets.get("roc-audit", seed=1)
    n = ds.graph.num_nodes
    eng = _engine(ds, str(tmp_path / "j.wal"), start_queue=True)
    try:
        eng.warmup()
        i = np.arange(300)
        big = np.stack([i % n, (7 * i + 1) % n], 1)
        inject.configure("seed=1,slow_ms=300,delta.replan.slow=1")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                r = eng.apply_delta(big, None)
            assert r["mode"] == "replanning"
            out = eng.query(np.arange(8, dtype=np.int32), timeout=60.0)
            assert out.shape == (8, ds.num_classes)
            assert eng.delta_stats()["swaps"] == 0   # the old CSR served
        finally:
            inject.configure("")
        # the ticket resolves after the swap and its checkpoint
        assert r["ticket"].wait(60.0), "replan swap never landed"
        st = eng.stats()["deltas"]
        assert st["replans"] == 1 and st["swaps"] == 1 and st["rebuilt"]
        assert st["checkpoints"] == 1
        _assert_csr_is({"gd": eng.bundle.gdata}, *eng.deltas._live_edges(),
                       n=n)
        assert eng.deltas.capacity == st["live_edges"] + 64
    finally:
        eng.close()


def test_close_during_inflight_mutation_resolves_everything(tmp_path,
                                                            monkeypatch):
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.serve import delta as delta_mod
    monkeypatch.setattr(delta_mod, "HEADROOM_EDGES", 64)
    ds = datasets.get("roc-audit", seed=1)
    n = ds.graph.num_nodes
    jp = str(tmp_path / "j.wal")
    eng = _engine(ds, jp, start_queue=True)
    eng.warmup()
    fut = eng.submit(np.arange(4, dtype=np.int32))
    i = np.arange(300)
    big = np.stack([i % n, (7 * i + 1) % n], 1)
    inject.configure("seed=1,slow_ms=200,delta.replan.slow=1")
    applied = threading.Event()

    def mutate():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            eng.apply_delta(big, None)
        applied.set()
    t = threading.Thread(target=mutate)
    t.start()
    try:
        assert applied.wait(30.0), "apply_delta never returned"
        eng.close()
    finally:
        inject.configure("")
        t.join(30.0)
    assert fut.result(5.0).shape == (4, ds.num_classes)
    st = eng.delta_stats()
    assert st["swaps"] == 1, "close() did not finish the in-flight swap"
    with pytest.raises(DeltaError, match="closed"):
        eng.deltas.apply(np.asarray([[0, 1]]), None)
    holder2, mgr2 = _manager(ds.graph, jp)
    assert mgr2.applied_seq == st["seq"] and mgr2.stats()["rebuilt"]
    mgr2.close()


def test_engine_without_deltas_raises_typed():
    from roc_tpu_torch.graph import datasets
    eng = _engine(datasets.get("roc-audit", seed=1), None)
    try:
        with pytest.raises(DeltaError, match="delta_journal"):
            eng.apply_delta(np.asarray([[0, 1]]), None)
        assert eng.delta_stats() == {} and eng.delta_seq() == 0
    finally:
        eng.close()


@pytest.mark.parametrize("kw,match", [
    (dict(stream=True, num_parts=2), "streamed executor"),
    (dict(aggregate_backend="xla"), "kernel aggregation backend"),
    (dict(model="gat", heads=2, layers=[8, 4, 4]), "graph attention"),
    (dict(model="sage", aggr="max"), "max aggregation"),
    (dict(model="sage", aggr="min"), "min aggregation")])
def test_refusals(kw, match):
    from roc_tpu_torch.graph import datasets
    ds = datasets.get("roc-audit", seed=1)
    with pytest.raises(DeltaError, match=match):
        _engine(ds, "", cfg=_cfg(**kw))


@pytest.mark.parametrize("kw", [dict(model="gin"),
                                dict(model="sage", aggr="avg"),
                                dict(model="gcn-chain", layers=[8, 16, 16, 4]),
                                dict(megafuse=True)])
def test_accepted_models_serve_the_live_graph(kw):
    """Every accepted model's patched engine serves bitwise what a fresh
    engine on the mutated graph serves."""
    from roc_tpu_torch.graph import datasets
    ds = datasets.get("roc-audit", seed=1)
    n = ds.graph.num_nodes
    cfg = _cfg(**kw)
    eng = _engine(ds, "", cfg=cfg)
    try:
        rng = np.random.default_rng(2)
        for _ in range(5):
            _quiet_apply(eng.deltas, rng.integers(0, n, (3, 2)),
                         np.stack([ds.graph.col_idx[:1],
                                   ds.graph.dst_idx[:1]], 1))
        ids = np.arange(n, dtype=np.int32)
        ds2 = dataclasses.replace(
            ds, graph=from_edges(n, *eng.deltas._live_edges()))
        fresh = _engine(ds2, None, cfg=cfg)
        try:
            np.testing.assert_array_equal(eng._serve_rows(ids),
                                          fresh._serve_rows(ids))
        finally:
            fresh.close()
    finally:
        eng.close()
