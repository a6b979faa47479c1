"""roc-threads for the port: the lock-discipline analyzer
(roc_tpu_torch/analysis/threads.py) and the runtime witness
(roc_tpu_torch/analysis/witness.py), as tests/test_threads.py holds
roc_tpu's:

  * the port's tree is clean against its committed threads.json (no
    findings after reasoned waivers, no drift), and the baseline is
    deterministic;
  * its lock-order edges are roc_tpu's, name for name;
  * seeded mutations (a lock inversion, a dropped guard, a waitless
    condvar wait, an unjoined thread, a lock held across fsync and across
    a subprocess, a mislabeled witness name) are each caught;
  * the witness passes through when disarmed, and when armed records,
    validates (transitively), orders nothing on an RLock re-entry,
    re-records a condition wait's reacquisition and ships one
    ``lock_order`` event a pair through the port's fault telemetry.

The threaded suites (test_torch_delta, test_torch_fleet, test_torch_slice,
test_torch_stream) run every test under the armed witness.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from roc_tpu.analysis import threads as JT
from roc_tpu_torch.analysis import threads as T
from roc_tpu_torch.analysis import witness as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tree_report():
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        yield T.analyze_paths(["roc_tpu_torch"])
    finally:
        os.chdir(cwd)


def test_tree_is_clean_under_waivers(tree_report):
    assert tree_report.findings == [], [str(f) for f in tree_report.findings]
    assert tree_report.waived >= 10


def test_tree_matches_committed_baseline(tree_report):
    drift = T.diff_baseline(tree_report)
    assert drift == [], "\n".join(drift)


def test_baseline_edges_are_roc_tpus():
    base = T.load_baseline()
    ref = JT.load_baseline()
    assert base["edges"] == ref["edges"] == [
        ["DeltaManager._mu", "ServeEngine._plan_lock"],
        ["ServeEngine._plan_lock", "PrefetchRing._lock"]]
    assert base["declared_edges"][0][:2] == ref["declared_edges"][0][:2]
    for a, b, reason in base["declared_edges"]:
        assert reason.strip(), f"declared edge {a}->{b} missing a reason"
    gb = base["guarded_by"]
    assert gb["MicrobatchQueue._pending"] == "MicrobatchQueue._cv"
    assert gb["DeltaManager._seq"] == "DeltaManager._mu"
    assert gb["PrefetchRing.stall_s"] == "PrefetchRing._lock"
    assert gb["InProcTransport._q"] == "InProcTransport._cv"
    wrapped = {lk["name"]: lk["witness"] for lk in base["locks"]
               if lk["witness"] is not None}
    assert wrapped == {n: n for n in (
        "DeltaManager._mu", "InProcTransport._cv", "MicrobatchQueue._cv",
        "PrefetchRing._lock", "ServeEngine._plan_lock")}
    assert all(th["joined"] for th in base["threads"]), base["threads"]
    # module-level locks are named without the package prefix
    names = {lk["name"] for lk in base["locks"]}
    assert {"fault.inject._LOCK", "fault.retry._LOCK", "native._LOCK"} \
        <= names


def test_baseline_json_is_deterministic(tmp_path, tree_report):
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
        T.save_baseline(tree_report, str(p1))
        T.save_baseline(T.analyze_paths(["roc_tpu_torch"]), str(p2))
    finally:
        os.chdir(cwd)
    assert p1.read_bytes() == p2.read_bytes()
    assert json.loads(p1.read_text()) == T.report_dict(tree_report)


@pytest.mark.parametrize("argv", [[], ["--selftest"]])
def test_cli(argv):
    proc = subprocess.run([sys.executable, "-m",
                           "roc_tpu_torch.analysis.threads", *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- seeded mutations (the analyzer bites) ----------------------------------

def _rules(src):
    return {f.rule for f in T.analyze_source(src).findings}


def test_clean_fixture_is_clean():
    rep = T.analyze_source(T._FIX_CLEAN)
    assert rep.findings == []
    assert ("Worker.a", "Worker.b") in rep.edges
    assert rep.guarded_by["Worker.items"] == "Worker.cv"


@pytest.mark.parametrize("fixture,rule", [
    ("_MUT_INVERSION", "lock-cycle"), ("_MUT_UNGUARDED", "unguarded-attr"),
    ("_MUT_WAITLESS", "condvar-wait"), ("_MUT_UNJOINED", "thread-join"),
    ("_MUT_BLOCKING", "lock-blocking"),
    ("_MUT_WITNESS_NAME", "witness-name")])
def test_seeded_mutation_caught(fixture, rule):
    assert rule in _rules(getattr(T, fixture))
    # roc_tpu's analyzer agrees on its own fixture
    assert rule in {f.rule for f in
                    JT.analyze_source(getattr(JT, fixture)).findings}


def test_lock_across_a_subprocess_caught_but_not_os_path_join():
    """The port's blocking calls include a subprocess (a build under a
    lock); ``os.path.join`` is not a thread join."""
    build = T._FIX_CLEAN + '''
    def build(self):
        import subprocess
        with self.a:
            subprocess.run(["g++"])
'''
    assert "lock-blocking" in _rules(build)
    path = T._FIX_CLEAN + '''
    def where(self):
        import os
        with self.a:
            return os.path.join("a", "b")
'''
    assert _rules(path) == set()


def test_waiver_silences_exactly_its_rule():
    waived = T._MUT_BLOCKING.replace(
        "        with self.a:\n            os.fsync(0)",
        "        with self.a:\n"
        "            # roclint: allow(lock-blocking) fixture reason\n"
        "            os.fsync(0)")
    rep = T.analyze_source(waived)
    assert rep.findings == [] and rep.waived == 1
    assert "lock-cycle" in _rules(T._MUT_INVERSION.replace(
        "with self.b:\n            with self.a:",
        "with self.b:\n            # roclint: allow(lock-blocking) wrong "
        "rule\n            with self.a:"))


def test_selftest_matrix_passes():
    assert T.selftest(verbose=False) == 0


# -- runtime witness mechanics ----------------------------------------------

@pytest.fixture
def armed():
    was = W.armed()
    W.reset()
    W.arm(True)
    yield W
    W.arm(was)
    W.reset()


def test_disarmed_is_passthrough_with_zero_records():
    was = W.armed()
    W.arm(False)
    try:
        W.reset()
        raw = threading.Lock()
        assert W.trace("X.raw", raw) is raw
        with W.trace("X.a", threading.Lock()):
            with W.trace("X.b", threading.Lock()):
                pass
        assert W.records() == 0
    finally:
        W.arm(was)


def test_armed_records_and_validates(armed):
    a = armed.trace("X.a", threading.Lock())
    b = armed.trace("X.b", threading.Lock())
    with a:
        with b:
            pass
    assert armed.observed_pairs()[("X.a", "X.b")] == 1
    assert armed.validate(edges=[("X.a", "X.b")]) == []
    viol = armed.validate(edges=[("X.b", "X.a")])
    assert len(viol) == 1 and "X.a -> X.b" in viol[0]
    assert armed.validate(edges=[("X.a", "X.c"), ("X.c", "X.b")]) == []


def test_armed_rlock_reentry_orders_nothing(armed):
    r = armed.trace("X.r", threading.RLock())
    inner = armed.trace("X.i", threading.Lock())
    with r:
        with r:
            with inner:
                pass
    pairs = armed.observed_pairs()
    assert ("X.r", "X.r") not in pairs
    assert pairs[("X.r", "X.i")] == 1


def test_armed_condvar_wait_rerecords_order(armed):
    cv = armed.trace("X.cv", threading.Condition())
    outer = armed.trace("X.outer", threading.Lock())
    with outer:
        with cv:
            cv.wait(timeout=0.01)
    assert armed.observed_pairs()[("X.outer", "X.cv")] == 2


def test_witness_emits_lock_order_telemetry(armed):
    from roc_tpu_torch import fault
    events = []
    fault.attach(lambda kind, **f: events.append((kind, f)))
    try:
        a = armed.trace("X.t1", threading.Lock())
        b = armed.trace("X.t2", threading.Lock())
        for _ in range(3):
            with a:
                with b:
                    pass
    finally:
        fault.detach()
    assert [f for k, f in events if k == "lock_order"] == \
        [{"outer": "X.t1", "inner": "X.t2"}]


def test_validate_defaults_to_the_ports_baseline(armed):
    a = armed.trace("DeltaManager._mu", threading.Lock())
    b = armed.trace("ServeEngine._plan_lock", threading.RLock())
    with a:
        with b:
            pass
    assert armed.validate() == []
    armed.reset()
    with b:
        with a:
            pass
    assert len(armed.validate()) == 1


def test_armed_scope_validates_and_disarms():
    was = W.armed()
    with W.armed_scope() as w:
        assert w is W and W.armed()
        lk = W.trace("PrefetchRing._lock", threading.Lock())
        with W.trace("ServeEngine._plan_lock", threading.RLock()):
            with lk:
                pass
    assert W.armed() == was and W.records() == 0
    with pytest.raises(AssertionError, match="not an edge"):
        with W.armed_scope():
            with W.trace("PrefetchRing._lock", threading.Lock()):
                with W.trace("DeltaManager._mu", threading.Lock()):
                    pass
    assert W.armed() == was


def test_the_five_sanctioned_locks_are_witnessed(armed):
    """Made while armed, each production lock is a recording proxy under
    its baseline name."""
    import numpy as np
    from roc_tpu_torch.fleet.replog import InProcTransport
    from roc_tpu_torch.serve.queue import MicrobatchQueue
    from roc_tpu_torch.stream.ring import PrefetchRing
    q = MicrobatchQueue(lambda ids: np.zeros((len(ids), 1), np.float32),
                        batch=4, wait_ms=1.0)
    ring = PrefetchRing(2, lambda key: key)
    try:
        for obj, attr, name in ((q, "_cv", "MicrobatchQueue._cv"),
                                (InProcTransport(), "_cv",
                                 "InProcTransport._cv"),
                                (ring, "_lock", "PrefetchRing._lock")):
            lock = getattr(obj, attr)
            assert isinstance(lock, W._WitnessLock), name
            assert lock._name == name
    finally:
        ring.close()
        q.close()
