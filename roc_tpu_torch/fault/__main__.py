"""``python -m roc_tpu_torch.fault --selftest [--device cuda|cpu]``: the
fault harness's own gate (roc_tpu/fault/__main__.py).

A broken chaos harness must be caught before anyone trusts a green chaos
run ("the faults didn't fire" and "the faults fired and were survived"
look the same from the outside).  Six stages, deterministic and cheap:

  1. spec      parse and validation, seeded per-call determinism
  2. retry     recovery, exhaustion, and the retries=0 kill switch
  3. durable   fsync_replace's atomic-rename round trip
  4. guard     ``guarded_update`` with Adam: a non-finite gradient keeps
               the params and the Adam state bitwise
  5. chaos     a seeded mini-train with an injected NaN step completes
               with finite params, plus a serve-queue shed and drain
  6. delta     delta-journal chaos on the port's DeltaManager: transient
               append faults retried, a kill before the record is lost,
               a kill after the fsync replays, a torn tail truncates, and
               the restart serves the same CSR bytes as a fault-free run

The guard, the chaos train and the delta manager run on the card unless
``--device cpu`` (or ``-device cpu``) is given.  Exit 0 and print
"fault selftest: OK" on success; a failure exits nonzero with the stage
name in the traceback.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading


def _stage_spec(device):
    from roc_tpu_torch.fault import inject
    seed, retries, slow_s, rules = inject.parse_spec(
        "seed=7,retries=2,slow_ms=1.5,a.read=3,b.kill=perm,c.nan@0.5")
    assert seed == 7 and retries == 2 and abs(slow_s - 0.0015) < 1e-12
    assert set(rules) == {"a.read", "b.kill", "c.nan"}
    for bad in ("nonsense==", "x@1.5", "seed=abc"):
        try:
            inject.parse_spec(bad)
        except ValueError:
            # roclint: allow(silent-swallow) expected-failure fixture: the raise is the check, the else branch fails it
            pass
        else:
            raise AssertionError(f"parse_spec accepted {bad!r}")

    def fire_pattern():
        inject.configure("seed=11,p.nan@0.5")
        return [inject.point("p.nan") for _ in range(64)]
    a, b = fire_pattern(), fire_pattern()
    assert a == b and any(a) and not all(a), "seeded firing not deterministic"
    inject.configure("")


def _stage_retry(device):
    from roc_tpu_torch.fault import inject, retry
    inject.configure("seed=1,r.io=2")
    calls = []

    def flaky():
        inject.point("r.io")
        calls.append(1)
        return "ok"
    assert retry.retrying("r.io", flaky, base_s=0.001) == "ok"
    assert retry.retry_counts().get("r.io") == 2
    inject.configure("seed=1,r.perm=perm")
    try:
        retry.retrying("r.perm", lambda: inject.point("r.perm"),
                       base_s=0.001)
    except inject.InjectedFault:
        # roclint: allow(silent-swallow) expected-failure fixture: the raise is the check, the else branch fails it
        pass
    else:
        raise AssertionError("permanent fault did not exhaust the retry")
    # retries=0 is the chaos kill switch: the first failure propagates
    inject.configure("seed=1,retries=0,r.once=1")
    tries = []

    def once():
        tries.append(1)
        inject.point("r.once")
    try:
        retry.retrying("r.once", once, base_s=0.001)
    except inject.InjectedFault:
        # roclint: allow(silent-swallow) expected-failure fixture: the raise is the check, the else branch fails it
        pass
    else:
        raise AssertionError("retries=0 still retried")
    assert len(tries) == 1
    inject.configure("")
    retry.reset_retry_counts()


def _stage_durable(device):
    from roc_tpu_torch.fault import fsync_replace
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "blob.bin")
        with open(path, "wb") as f:
            f.write(b"old")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(b"new contents")
        fsync_replace(tmp, path)
        assert not os.path.exists(tmp)
        with open(path, "rb") as f:
            assert f.read() == b"new contents"


def _stage_guard(device):
    import torch

    from roc_tpu_torch.fault import guarded_update
    from roc_tpu_torch.optim.adam import Adam
    opt = Adam(alpha=0.1)
    params = {"w": torch.ones(4, device=device)}
    state = opt.init(params)
    p1, _, nf1, _ = guarded_update(opt, params,
                                   {"w": torch.full((4,), 0.5,
                                                    device=device)},
                                   state, 0.1)
    assert not bool(nf1) and not torch.allclose(p1["w"], params["w"])
    p2, s2, nf2, _ = guarded_update(opt, params,
                                    {"w": torch.full((4,), float("nan"),
                                                     device=device)},
                                    state, 0.1)
    assert bool(nf2), "NaN grads not flagged"
    assert torch.equal(p2["w"], params["w"])
    assert torch.equal(s2.m["w"], state.m["w"])
    assert torch.equal(s2.v["w"], state.v["w"])
    assert torch.equal(s2.t, state.t)


def _stage_chaos(device):
    import numpy as np

    from roc_tpu_torch.fault import inject
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.models import build_gcn
    from roc_tpu_torch.serve.queue import MicrobatchQueue, Overloaded
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.driver import Trainer
    ds = datasets.synthetic("selftest", 80, 3.0, 8, 3, n_train=20,
                            n_val=20, n_test=20, seed=13)
    cfg = Config(layers=[8, 4, 3], num_epochs=4, eval_every=1000,
                 dropout_rate=0.0, device=device)
    inject.configure("seed=3,step.nan=1")
    try:
        tr = Trainer(cfg, ds, build_gcn(cfg.layers, 0.0))
        stats = tr.train(print_fn=lambda *_: None)
    finally:
        inject.configure("")
    assert tr.nonfinite_skips >= 1, "injected NaN step was not skipped"
    assert np.isfinite(stats.final_loss), "NaN leaked into the params"
    for p in tr.params.values():
        assert bool(p.isfinite().all())

    # serve-queue overload: shed at the cap, graceful drain
    release, started = threading.Event(), threading.Event()

    def serve_fn(ids):
        started.set()
        release.wait(5.0)
        return np.zeros((len(ids), 3), np.float32)

    q = MicrobatchQueue(serve_fn, batch=4, wait_ms=1.0, queue_max=1)
    f1 = q.submit([1])
    assert started.wait(5.0), "serve worker never picked up the window"
    f2 = q.submit([2])          # fills the single pending slot
    try:
        q.submit([3])
    except Overloaded:
        # roclint: allow(silent-swallow) expected-failure fixture: the raise is the check, the else branch fails it
        pass
    else:
        raise AssertionError("submit past queue_max did not shed")
    release.set()
    q.close()
    assert f1.result(5.0).shape == (1, 3)
    assert f2.result(5.0).shape == (1, 3)
    assert q.shed == 1


def _stage_delta(device):
    """Every kill window either loses nothing (the record never reached
    the WAL) or replays exactly (it did): the dichotomy the write-ahead
    discipline promises."""
    import numpy as np
    import torch

    from roc_tpu_torch.fault import inject
    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.serve.delta import DeltaManager
    from roc_tpu_torch.train.graph_data import dense_graph_data

    rng = np.random.default_rng(5)
    n = 64
    csr = from_edges(n, rng.integers(0, n, 200), rng.integers(0, n, 200))
    dev = torch.device(device)

    def fresh(jpath):
        holder = {"gd": dense_graph_data(csr, "kernel", "exact", dev,
                                         transpose=False)}
        mgr = DeltaManager(lambda: holder["gd"],
                           lambda g: holder.__setitem__("gd", g),
                           threading.RLock(), n, journal_path=jpath)
        return holder, mgr

    def csr_bytes(holder):
        c = holder["gd"].csr
        return c.row_ptr.cpu().numpy().tobytes() + \
            c.col_idx.cpu().numpy().tobytes()

    with tempfile.TemporaryDirectory() as d:
        jpath = os.path.join(d, "deltas.wal")
        holder, mgr = fresh(jpath)
        inject.configure("seed=2,delta.journal.append=1")
        try:
            r = mgr.apply(np.asarray([[1, 2], [3, 4]]), None)
        finally:
            inject.configure("")
        assert r["mode"] == "applied" and r["applied_adds"] == 2
        # kill before any record byte lands: the batch is lost on restart
        inject.configure("seed=2,delta.journal.kill_record=1")
        try:
            mgr.apply(np.asarray([[5, 6]]), None)
            raise AssertionError("kill_record did not crash")
        except inject.SimulatedCrash:
            # roclint: allow(silent-swallow) expected-failure fixture: the crash is the check
            pass
        finally:
            inject.configure("")
        holder2, mgr2 = fresh(jpath)
        assert mgr2.applied_seq == 1, "unwritten record survived the crash"
        assert mgr2.counters["replayed"] == 1
        # kill after the durable write, before the in-memory patch: the
        # restart replays the batch
        inject.configure("seed=2,delta.journal.kill_ack=1")
        try:
            mgr2.apply(np.asarray([[5, 6]]), None)
            raise AssertionError("kill_ack did not crash")
        except inject.SimulatedCrash:
            # roclint: allow(silent-swallow) expected-failure fixture: the crash is the check
            pass
        finally:
            inject.configure("")
        # a torn tail (power cut mid-frame) truncates on open
        with open(jpath, "ab") as f:
            f.write(b"\x40\x00\x00\x00torn")
        holder3, mgr3 = fresh(jpath)
        assert mgr3.applied_seq == 2, "durably-written record not replayed"
        assert mgr3.journal.torn_bytes > 0, "torn tail not truncated"
        oracle_h, oracle_m = fresh(os.path.join(d, "oracle.wal"))
        oracle_m.apply(np.asarray([[1, 2], [3, 4]]), None)
        oracle_m.apply(np.asarray([[5, 6]]), None)
        assert csr_bytes(holder3) == csr_bytes(oracle_h), \
            "replayed CSR differs from the fault-free run"
        for m in (mgr, mgr2, mgr3, oracle_m):
            m.close()


STAGES = (("spec", _stage_spec), ("retry", _stage_retry),
          ("durable", _stage_durable), ("guard", _stage_guard),
          ("chaos", _stage_chaos), ("delta", _stage_delta))


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="python -m roc_tpu_torch.fault")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--device", "-device", dest="device", default="cuda")
    args = p.parse_args(argv)
    if not args.selftest:
        print(__doc__.strip())
        return 0
    from roc_tpu_torch.device import resolve_device
    device = str(resolve_device(args.device))
    for name, fn in STAGES:
        fn(device)
        print(f"# fault selftest: {name} ok")
    print("fault selftest: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
