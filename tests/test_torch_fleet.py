"""The port's replicated serving fleet (roc_tpu_torch/fleet) against
roc_tpu's (roc_tpu/fleet) on the same seeded NumPy batches.

- segments: byte-identical to roc_tpu's for the same records and sealing
  stamp, and a segment sealed by either package replays in the other; the
  taxonomy (torn, bit rot, in-segment gap) and exactly-once replay;
- the three transports (in-process, spool directory, localhost TCP);
- replication at the manager level: lockstep parity (followers' CSR bytes
  equal the primary's), late-follower snapshot catch-up, the ship and
  replay kill windows, the snapshot-install window;
- the router's dispatch, freshness floor, sibling retry, typed shed and
  autoscale (stub replicas, run through both packages' routers);
- a real fleet of port engines on the CPU: every member bitwise equal.

All checks are exact (bytes, sequence numbers, bitwise rows).
"""

import os
import struct
import threading
import time
import warnings
import zlib

import numpy as np
import pytest
import torch

from roc_tpu.fleet import replog as jreplog
from roc_tpu.fleet.router import FleetRouter as JFleetRouter
from roc_tpu.serve.queue import Overloaded as JOverloaded
from roc_tpu_torch.fault import inject, retry
from roc_tpu_torch.fleet import (FileTransport, FleetOverloaded, FleetRouter,
                                 InProcTransport, ReplicationError,
                                 ReplicationLog, SegmentGapError,
                                 SegmentRotError, SocketTransport,
                                 TornSegmentError, decode_segment,
                                 encode_segment, install_snapshot_files,
                                 replay_segment)
from roc_tpu_torch.graph.csr import from_edges
from roc_tpu_torch.obs.watchdog import PerfWatchdog
from roc_tpu_torch.serve.delta import _LEN, _REC, DeltaManager
from roc_tpu_torch.serve.queue import Closed, Overloaded
from roc_tpu_torch.train.graph_data import dense_graph_data

CPU = torch.device("cpu")
N_NODES = 96


def _graph(seed=3, n=N_NODES, e=200):
    rng = np.random.default_rng(seed)
    return from_edges(n, rng.integers(0, 64, e), rng.integers(0, 64, e))


def _manager(csr, journal_path):
    holder = {"gd": dense_graph_data(csr, "kernel", "exact", CPU,
                                     transpose=False)}
    mgr = DeltaManager(lambda: holder["gd"],
                       lambda g: holder.__setitem__("gd", g),
                       threading.RLock(), csr.num_nodes,
                       journal_path=journal_path)
    return holder, mgr


def _csr_bytes(holder):
    c = holder["gd"].csr
    return c.row_ptr.numpy().tobytes() + c.col_idx.numpy().tobytes()


def _quiet_apply(mgr, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return mgr.apply(*a, **kw)


class _StubEngine:
    """The two attributes ReplicationLog reads off a ServeEngine."""

    def __init__(self, mgr):
        self.deltas = mgr

    def delta_seq(self):
        return self.deltas.applied_seq


def _primary(csr, tmp_path, name="primary"):
    holder, mgr = _manager(csr, str(tmp_path / f"{name}.wal"))
    return holder, mgr, ReplicationLog(_StubEngine(mgr))


def _replay_into(fmgr, seg):
    def _apply(seq, add, ret):
        res = _quiet_apply(fmgr, add if len(add) else None,
                           ret if len(ret) else None)
        assert res["seq"] == seq, (res["seq"], seq)
    return replay_segment(seg, fmgr.applied_seq, _apply)


def _records(seqs):
    return [(s, np.asarray([[64 + s, 65 + s]], np.int64),
             np.zeros((0, 2), np.int64)) for s in seqs]


# -- segments across packages -----------------------------------------------

def test_segments_byte_identical_to_roc_tpu():
    rng = np.random.default_rng(2)
    recs = [(s, rng.integers(0, 900, (int(rng.integers(0, 4)), 2)),
             rng.integers(0, 900, (int(rng.integers(0, 3)), 2)))
            for s in range(11, 19)]
    seg = encode_segment(recs, sealed_at=1234.5)
    assert seg == jreplog.encode_segment(recs, sealed_at=1234.5)
    for dec in (decode_segment, jreplog.decode_segment):
        out, sealed = dec(seg)
        assert sealed == 1234.5 and [r[0] for r in out] == list(range(11, 19))
        for (_, a0, r0), (_, a1, r1) in zip(recs, out):
            np.testing.assert_array_equal(a0.reshape(-1, 2), a1)
            np.testing.assert_array_equal(r0.reshape(-1, 2), r1)


@pytest.mark.parametrize("primary_pkg", ["roc_tpu", "port"])
def test_segments_replay_across_packages(tmp_path, primary_pkg):
    """One package's primary seals its journal tail; the other package's
    follower manager replays it to the primary's live edges."""
    from roc_tpu.graph.csr import from_edges as jfrom_edges
    from test_torch_delta import _jax_manager
    csr = _graph()
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(12):
        adds = rng.integers(0, N_NODES, (3, 2))
        rets = np.asarray([[int(csr.col_idx[len(batches)]),
                            int(csr.dst_idx[len(batches)])]])
        batches.append((adds, rets))
    if primary_pkg == "roc_tpu":
        ph, pm = _jax_manager(jfrom_edges(N_NODES, csr.col_idx,
                                          csr.dst_idx),
                              str(tmp_path / "p.wal"))
        log = jreplog.ReplicationLog(_StubEngine(pm))
    else:
        ph, pm = _manager(csr, str(tmp_path / "p.wal"))
        log = ReplicationLog(_StubEngine(pm))
    for a, r in batches:
        _quiet_apply(pm, a, r)
    seg = log.ship()
    if primary_pkg == "roc_tpu":
        fh, fm = _manager(csr, str(tmp_path / "f.wal"))
        applied, skipped, _ = _replay_into(fm, seg)
        want = _placed_bytes(*pm._live_edges())
        assert _csr_bytes(fh) == want
    else:
        fh, fm = _jax_manager(jfrom_edges(N_NODES, csr.col_idx,
                                          csr.dst_idx),
                              str(tmp_path / "f.wal"))

        def _apply(seq, add, ret):
            res = _quiet_apply(fm, add if len(add) else None,
                               ret if len(ret) else None)
            assert res["seq"] == seq
        applied, skipped, _ = jreplog.replay_segment(seg, fm.applied_seq,
                                                     _apply)
        assert _placed_bytes(*fm._live_edges()) == _csr_bytes(ph)
    assert (applied, skipped) == (12, 0)
    assert fm.applied_seq == pm.applied_seq == 12
    pm.close()
    fm.close()


def _placed_bytes(src, dst):
    """The bytes of the placed CSR of these edges."""
    from roc_tpu_torch.ops import DeviceCsr
    c = DeviceCsr.from_csr(from_edges(N_NODES, src, dst), CPU,
                           transpose=False)
    return c.row_ptr.numpy().tobytes() + c.col_idx.numpy().tobytes()


def test_segment_encode_rejects_sparse_seqs():
    with pytest.raises(AssertionError):
        encode_segment(_records([1, 3]))


def test_segment_taxonomy_torn():
    seg = encode_segment(_records([1, 2, 3]))
    with pytest.raises(TornSegmentError):
        decode_segment(seg[:10])
    with pytest.raises(TornSegmentError):
        decode_segment(seg[:-5])


def test_segment_taxonomy_bit_rot():
    seg = encode_segment(_records([1, 2]))
    with pytest.raises(SegmentRotError):
        decode_segment(b"XXX" + seg[3:])
    hdr_flip = bytearray(seg)
    hdr_flip[6] ^= 0x40
    with pytest.raises(SegmentRotError):
        decode_segment(bytes(hdr_flip))
    body_flip = bytearray(seg)
    body_flip[-6] ^= 0x01
    with pytest.raises(SegmentRotError):
        decode_segment(bytes(body_flip))
    with pytest.raises(SegmentRotError):
        decode_segment(seg + b"\x00")


def test_segment_taxonomy_in_segment_gap():
    body = bytearray()
    for seq in (1, 3):
        rec = _REC.pack(seq, 0, 0)
        body += _LEN.pack(len(rec)) + rec \
            + _LEN.pack(zlib.crc32(rec) & 0xFFFFFFFF)
    hdr = b"RSG1" + struct.pack("<QQId", 1, 2, 2, 0.0)
    hdr += _LEN.pack(zlib.crc32(hdr) & 0xFFFFFFFF)
    with pytest.raises(SegmentGapError):
        decode_segment(bytes(hdr + body))


def test_replay_segment_dedup_and_gap():
    seg = encode_segment(_records([1, 2, 3]))
    seen = []
    assert replay_segment(seg, 0, lambda s, a, r: seen.append(s))[:2] == \
        (3, 0)
    assert replay_segment(seg, 3, lambda s, a, r: seen.append(s))[:2] == \
        (0, 3)
    assert replay_segment(seg, 1, lambda s, a, r: seen.append(s))[:2] == \
        (2, 1)
    assert seen == [1, 2, 3, 2, 3]
    with pytest.raises(SegmentGapError):
        replay_segment(encode_segment(_records([5, 6])), 3,
                       lambda s, a, r: seen.append(s))
    assert len(seen) == 5


# -- transports -------------------------------------------------------------

def test_inproc_transport_order_and_backlog():
    tr = InProcTransport(maxlen=2)
    assert tr.recv(0.0) is None and tr.depth() == 0
    tr.send(b"a")
    tr.send(b"b")
    with pytest.raises(ReplicationError):
        tr.send(b"c")
    assert tr.recv(0.0) == b"a" and tr.recv(0.0) == b"b"
    assert tr.recv(0.0) is None


def test_inproc_recv_survives_spurious_wakeup():
    tr = InProcTransport()

    def _spurious():
        time.sleep(0.05)
        with tr._cv:
            tr._cv.notify_all()

    def _sender():
        time.sleep(0.2)
        tr.send(b"real")

    ts = [threading.Thread(target=_spurious),
          threading.Thread(target=_sender)]
    for t in ts:
        t.start()
    assert tr.recv(10.0) == b"real"
    for t in ts:
        t.join()
    assert tr.recv(0.05) is None


def test_file_transport_restart_resume_and_across_packages(tmp_path):
    spool = str(tmp_path / "spool")
    w = FileTransport(spool)
    w.send(b"seg-one")
    w.send(b"seg-two")
    jreplog.FileTransport(spool).send(b"seg-three")   # the other package
    r = FileTransport(spool)
    assert [r.recv(0.0) for _ in range(3)] == [b"seg-one", b"seg-two",
                                               b"seg-three"]
    assert r.recv(0.0) is None
    assert jreplog.FileTransport(spool).recv(0.0) == b"seg-one"


def test_socket_transport_roundtrip():
    follower = SocketTransport.listen()
    primary = SocketTransport.connect(follower.port)
    try:
        seg = encode_segment(_records([1, 2]))
        primary.send(seg)
        primary.send(b"tiny")
        assert follower.recv(5.0) == seg
        assert follower.recv(5.0) == b"tiny"
        assert follower.recv(0.05) is None
    finally:
        primary.close()
        follower.close()


# -- replication at the manager level ---------------------------------------

def test_fleet_lockstep_parity_mixed_stream(tmp_path):
    csr = _graph()
    holder, mgr, replog = _primary(csr, tmp_path)
    fh1, fm1 = _manager(csr, str(tmp_path / "f1.wal"))
    fh2, fm2 = _manager(csr, str(tmp_path / "f2.wal"))
    fresh = iter([(a, b) for a in range(64, 96) for b in range(64, 96)])
    tracked = []
    rng = np.random.default_rng(17)
    for batch in range(30):
        add = [next(fresh) for _ in range(2)]
        tracked.extend(add)
        ret = None
        if len(tracked) >= 16:
            k = int(rng.integers(1, 3))
            ret, tracked = np.asarray(tracked[:k]), tracked[k:]
        _quiet_apply(mgr, np.asarray(add), ret)
        if batch % 3 == 2:
            seg = replog.ship()
            for fm in (fm1, fm2):
                _replay_into(fm, seg)
    seg = replog.ship()
    if seg is not None:
        for fm in (fm1, fm2):
            _replay_into(fm, seg)
    assert replog.ship() is None
    assert fm1.applied_seq == fm2.applied_seq == mgr.applied_seq == 30
    assert _csr_bytes(fh1) == _csr_bytes(fh2) == _csr_bytes(holder)
    assert replog.stats()["records_shipped"] == 30
    for m in (mgr, fm1, fm2):
        m.close()


def test_late_follower_snapshot_catch_up(tmp_path):
    csr = _graph()
    holder, mgr, replog = _primary(csr, tmp_path)
    for k in range(6):
        _quiet_apply(mgr, np.asarray([[64 + k, 80 + k]]), None)
    replog.ship()
    mgr.checkpoint()
    for k in range(3):
        _quiet_apply(mgr, np.asarray([[70 + k, 90 + k]]), None)
    seg = replog.ship()
    fp = str(tmp_path / "late.wal")
    fh, fm = _manager(csr, fp)
    with pytest.raises(SegmentGapError):
        _replay_into(fm, seg)
    assert fm.applied_seq == 0
    fm.close()
    snap, jour, seq = replog.snapshot_blob()
    assert seq == mgr.applied_seq == 9
    install_snapshot_files(snap, jour, fp + ".snapshot.npz", fp)
    fh, fm = _manager(csr, fp)
    assert fm.applied_seq == 9
    _quiet_apply(mgr, np.asarray([[66, 94]]), None)
    _replay_into(fm, replog.ship())
    assert fm.applied_seq == mgr.applied_seq == 10
    assert _csr_bytes(fh) == _csr_bytes(holder)
    for m in (mgr, fm):
        m.close()


def test_replication_log_requires_journal():
    holder, mgr = _manager(_graph(), "")
    with pytest.raises(ReplicationError):
        ReplicationLog(_StubEngine(mgr))
    mgr.close()


def test_ship_kill_pre_nothing_published(tmp_path):
    csr = _graph()
    holder, mgr, replog = _primary(csr, tmp_path)
    tr = replog.attach(InProcTransport())
    _quiet_apply(mgr, np.asarray([[64, 80]]), None)
    inject.configure("seed=2,fleet.ship.kill_pre=1")
    try:
        with pytest.raises(inject.SimulatedCrash):
            replog.ship()
    finally:
        inject.configure("")
    assert tr.depth() == 0 and replog.shipped_seq == 0
    seg = replog.ship()
    assert tr.depth() == 1 and replog.shipped_seq == 1
    fh, fm = _manager(csr, str(tmp_path / "f.wal"))
    _replay_into(fm, seg)
    assert _csr_bytes(fh) == _csr_bytes(holder)
    for m in (mgr, fm):
        m.close()


def test_ship_kill_post_duplicate_deduped(tmp_path):
    csr = _graph()
    holder, mgr, replog = _primary(csr, tmp_path)
    tr = replog.attach(InProcTransport())
    _quiet_apply(mgr, np.asarray([[64, 80]]), None)
    _quiet_apply(mgr, np.asarray([[65, 81]]), None)
    inject.configure("seed=2,fleet.ship.kill_post=1")
    try:
        with pytest.raises(inject.SimulatedCrash):
            replog.ship()
    finally:
        inject.configure("")
    assert tr.depth() == 1 and replog.shipped_seq == 0
    replog.ship()
    assert tr.depth() == 2 and replog.shipped_seq == 2
    fh, fm = _manager(csr, str(tmp_path / "f.wal"))
    applied = skipped = 0
    while (seg := tr.recv(0.0)) is not None:
        a, s, _ = _replay_into(fm, seg)
        applied += a
        skipped += s
    assert (applied, skipped) == (2, 2) and fm.applied_seq == 2
    assert _csr_bytes(fh) == _csr_bytes(holder)
    for m in (mgr, fm):
        m.close()


def test_ship_transient_fault_retried_then_typed(tmp_path):
    csr = _graph()
    holder, mgr, replog = _primary(csr, tmp_path)
    tr = replog.attach(InProcTransport())
    _quiet_apply(mgr, np.asarray([[64, 80]]), None)
    retry.reset_retry_counts()
    inject.configure("seed=2,fleet.ship=2")
    try:
        assert replog.ship() is not None
    finally:
        inject.configure("")
    assert tr.depth() == 1 and replog.shipped_seq == 1
    assert retry.retry_counts().get("fleet.ship", 0) == 2
    _quiet_apply(mgr, np.asarray([[65, 81]]), None)
    inject.configure("seed=2,fleet.ship=3")
    try:
        with pytest.raises(inject.InjectedFault):
            replog.ship()
    finally:
        inject.configure("")
    assert replog.shipped_seq == 1
    assert replog.ship() is not None and replog.shipped_seq == 2
    mgr.close()


def test_replay_kill_mid_segment_restart_converges(tmp_path):
    csr = _graph()
    holder, mgr, replog = _primary(csr, tmp_path)
    for k in range(3):
        _quiet_apply(mgr, np.asarray([[64 + k, 80 + k]]), None)
    seg = replog.ship()
    fp = str(tmp_path / "f.wal")
    fh, fm = _manager(csr, fp)
    inject.configure("seed=2,fleet.replay.kill_mid=1")
    try:
        with pytest.raises(inject.SimulatedCrash):
            _replay_into(fm, seg)
    finally:
        inject.configure("")
    assert fm.applied_seq == 1
    fm.close()
    fh, fm = _manager(csr, fp)
    assert fm.applied_seq == 1
    assert _replay_into(fm, seg)[:2] == (2, 1)
    assert fm.applied_seq == mgr.applied_seq == 3
    assert _csr_bytes(fh) == _csr_bytes(holder)
    for m in (mgr, fm):
        m.close()


def test_snapshot_install_kill_window_idempotent(tmp_path):
    csr = _graph()
    holder, mgr, replog = _primary(csr, tmp_path)
    for k in range(4):
        _quiet_apply(mgr, np.asarray([[64 + k, 80 + k]]), None)
    snap, jour, seq = replog.snapshot_blob()
    fp = str(tmp_path / "f.wal")
    inject.configure("seed=2,fleet.snap.kill_install=1")
    try:
        with pytest.raises(inject.SimulatedCrash):
            install_snapshot_files(snap, jour, fp + ".snapshot.npz", fp)
    finally:
        inject.configure("")
    assert os.path.exists(fp + ".snapshot.npz") and not os.path.exists(fp)
    install_snapshot_files(snap, jour, fp + ".snapshot.npz", fp)
    fh, fm = _manager(csr, fp)
    assert fm.applied_seq == seq == 4
    assert _csr_bytes(fh) == _csr_bytes(holder)
    for m in (mgr, fm):
        m.close()


# -- the router (stub replicas), through both packages' routers ------------

ROUTERS = [pytest.param((FleetRouter, FleetOverloaded, Overloaded, Closed),
                        id="port"),
           pytest.param((JFleetRouter, None, JOverloaded, None),
                        id="roc_tpu")]


@pytest.fixture(params=ROUTERS)
def router_kit(request):
    from roc_tpu.fleet.router import FleetOverloaded as JFleetOverloaded
    from roc_tpu.serve.queue import Closed as JClosed
    cls, shed, over, closed = request.param
    return cls, shed or JFleetOverloaded, over, closed or JClosed


class _StubReplica:
    def __init__(self, name, over, seq=0, load=0, overloaded=False):
        self.name = name
        self.alive = True
        self.applied_seq = seq
        self.load = load
        self.overloaded = overloaded
        self._over = over
        self.submitted = []
        self.transport = None
        self.last_lag_s = 0.0

    def submit(self, node_ids, deadline_s=None):
        if self.overloaded:
            raise self._over(f"{self.name} at depth cap")
        self.submitted.append(node_ids)
        return (self.name, node_ids)

    def close(self):
        self.alive = False


class _StubLog:
    shipped_seq = 0

    def ship(self):
        return None

    def detach(self, transport):
        pass

    def stats(self):
        return {"shipped_seq": 0, "segments_shipped": 0,
                "records_shipped": 0, "transports": 0}


def test_router_least_loaded_dispatch(router_kit):
    cls, shed, over, _ = router_kit
    p = _StubReplica("p", over, seq=5, load=7)
    f1 = _StubReplica("f1", over, seq=5, load=3)
    f2 = _StubReplica("f2", over, seq=5, load=1)
    r = cls(p, [f1, f2], _StubLog())
    assert r.submit([0, 1])[0] == "f2" and f2.submitted == [[0, 1]]
    assert r.routed == 1 and r.shed == 0


def test_router_freshness_floor(router_kit):
    cls, shed, over, _ = router_kit
    p = _StubReplica("p", over, seq=10, load=9)
    stale = _StubReplica("stale", over, seq=7, load=0)
    r = cls(p, [stale], _StubLog(), freshness_floor=0)
    assert r.eligible() == [p] and r.submit([1])[0] == "p"
    r.freshness_floor = 3
    assert r.eligible() == [p, stale]
    r.freshness_floor = None
    assert r.eligible() == [p, stale]
    stale.alive = False
    assert r.eligible() == [p]


def test_router_sibling_retry_then_typed_shed(router_kit):
    cls, shed, over, _ = router_kit
    p = _StubReplica("p", over, load=5, overloaded=True)
    f1 = _StubReplica("f1", over, load=1, overloaded=True)
    f2 = _StubReplica("f2", over, load=2)
    r = cls(p, [f1, f2], _StubLog(), max_retries=2)
    assert r.submit([3])[0] == "f2"
    assert r.sibling_retries == 1 and r.shed == 0
    f2.overloaded = True
    with pytest.raises(shed):
        r.submit([4])
    assert r.shed == 1 and issubclass(shed, over)


def test_router_retry_budget_respected(router_kit):
    cls, shed, over, _ = router_kit
    reps = [_StubReplica(f"r{i}", over, load=i, overloaded=True)
            for i in range(4)]
    ok = _StubReplica("ok", over, load=9)
    r = cls(reps[0], reps[1:] + [ok], _StubLog(), max_retries=1)
    with pytest.raises(shed):
        r.submit([1])
    assert r.sibling_retries == 2 and ok.submitted == []


def test_router_no_eligible_is_typed_shed(router_kit):
    cls, shed, over, _ = router_kit
    p = _StubReplica("p", over, seq=10)
    p.alive = False
    r = cls(p, [], _StubLog(), freshness_floor=0)
    with pytest.raises(shed):
        r.submit([1])
    assert r.shed == 1


def test_router_reroutes_closed_replica_to_sibling(router_kit):
    cls, shed, over, closed = router_kit

    class _ClosedReplica(_StubReplica):
        def submit(self, node_ids, deadline_s=None):
            raise closed(f"{self.name} queue closed")

    p = _StubReplica("p", over, load=5)
    r = cls(p, [_ClosedReplica("dead", over, load=0)], _StubLog())
    assert r.submit([1, 2])[0] == "p"
    assert r.sibling_retries == 1 and r.shed == 0


def test_router_autoscale_spawn_on_shed(router_kit):
    cls, shed, over, _ = router_kit
    p = _StubReplica("p", over, overloaded=True)
    spawned = []

    def spawn():
        rep = _StubReplica(f"auto-{len(spawned)}", over)
        spawned.append(rep)
        return rep

    r = cls(p, [], _StubLog(), spawn_cb=spawn, drain_cb=lambda rep: None,
            up_shed_rate=0.05, scale_cooldown=2)
    with pytest.raises(shed):
        r.submit([1])
    event = r.maybe_scale()
    assert event["action"] == "spawn" and event["reason"] == "shed-rate"
    assert r.followers == spawned and len(spawned) == 1
    p.overloaded = False
    spawned[0].overloaded = True
    r._win_shed, r._win_submits = 5, 5
    assert r.maybe_scale() is None and len(spawned) == 1


def test_router_autoscale_drain_on_quiet(router_kit):
    cls, shed, over, _ = router_kit
    p = _StubReplica("p", over, load=0)
    f = _StubReplica("f", over, load=0)
    drained = []
    r = cls(p, [f], _StubLog(), spawn_cb=None, drain_cb=drained.append,
            scale_cooldown=2, min_replicas=1)
    for _ in range(4):
        r.maybe_scale()
    assert [e["action"] for e in r.scale_events] == ["drain"]
    assert drained == [f] and r.followers == []
    for _ in range(8):
        assert r.maybe_scale() is None
    assert r.replicas == [p]


def test_router_autoscale_spawn_on_watchdog_alert(router_kit):
    cls, shed, over, _ = router_kit
    wd = PerfWatchdog(warmup=1)
    p = _StubReplica("p", over)
    spawned = []
    r = cls(p, [], _StubLog(), watchdog=wd,
            spawn_cb=lambda: spawned.append(_StubReplica("auto", over))
            or spawned[-1], scale_cooldown=1)
    wd.alerts.append({"kind": "fleet-lag", "event": 0, "lag_s": 1.0,
                      "ewma_s": 0.1, "ratio": 10.0, "shed_rate": 0.0})
    event = r.maybe_scale()
    assert event is not None and event["reason"] == "watchdog"
    assert len(spawned) == 1


# -- observe_fleet ----------------------------------------------------------

def test_watchdog_observe_fleet_matches_roc_tpu():
    from roc_tpu.obs.watchdog import PerfWatchdog as JPerfWatchdog
    wd, jwd = PerfWatchdog(), JPerfWatchdog()
    lags = (0.01, 0.01, 0.01, 0.1, 0.012, 0.3, 0.011)
    for i, lag in enumerate(lags):
        a = wd.observe_fleet(i, lag, shed_rate=0.25)
        assert a == jwd.observe_fleet(i, lag, shed_rate=0.25)
    assert wd.alerts and wd.alerts[0]["shed_rate"] == 0.25
    assert wd.fleet_ewma == jwd.fleet_ewma < 0.05     # clamped samples
    assert wd.verdict() == jwd.verdict() == "fleet-lag"
    wd.observe_nonfinite(0, 1)
    assert wd.verdict() == "nonfinite"
    wd2 = PerfWatchdog()
    wd2.load_state(jwd.state_dict())
    assert (wd2.fleet_ewma, wd2.fleet_observed) == \
        (jwd.fleet_ewma, jwd.fleet_observed)
    assert wd2.observe_fleet(9, 1.0) is not None      # armed after resume


# -- a real fleet of port engines --------------------------------------------

def test_real_fleet_lockstep_catch_up_and_bitwise_rows(tmp_path):
    from roc_tpu_torch.fleet import Replica
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.serve import max_ulp_diff
    from roc_tpu_torch.train.config import Config
    ds = datasets.get("roc-audit", seed=1)
    cfg = Config(layers=[ds.in_dim, 8, ds.num_classes], dropout_rate=0.0,
                 serve_batch=4, serve_wait_ms=1.0,
                 aggregate_backend="binned", aggregate_precision="exact")
    model = build_model("gcn", cfg.layers, cfg.dropout_rate, cfg.aggr)

    def mk(name):
        return Replica(name, cfg, ds, model, None,
                       str(tmp_path / f"{name}.wal"), device="cpu")

    primary = mk("primary")
    replog = ReplicationLog(primary.engine)
    followers = [mk("f0"), mk("f1")]
    for f in followers:
        f.transport = replog.attach(InProcTransport())
    wd = PerfWatchdog()
    router = FleetRouter(primary, followers, replog, watchdog=wd)
    try:
        rng = np.random.default_rng(3)
        n = ds.graph.num_nodes
        for k in range(12):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                router.apply_delta(rng.integers(0, n, (2, 2)), None)
            router.query(rng.integers(0, n, 3), timeout=60.0)
        # a late follower: snapshot catch-up, then it replays like any
        late = mk("late")
        late.transport = replog.attach(InProcTransport())
        router.followers.append(late)
        router.pump()
        assert router.catch_ups == 1
        router.apply_delta(np.asarray([[1, 2]]), None)
        heads = {r.applied_seq for r in router.replicas}
        assert heads == {primary.applied_seq}
        ids = np.arange(n, dtype=np.int32)
        want = primary.engine.query(ids, timeout=60.0)
        for rep in router.replicas:
            assert max_ulp_diff(rep.engine.query(ids, timeout=60.0),
                                want) == 0
        st = router.stats()
        assert st["shed"] == 0 and st["replog"]["segments_shipped"] == 13
        assert wd.fleet_observed == 13
    finally:
        router.close()
