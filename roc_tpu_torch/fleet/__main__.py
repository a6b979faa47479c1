"""``python -m roc_tpu_torch.fleet --selftest [--device cuda|cpu]``: the
replicated-serving drill (roc_tpu/fleet/__main__.py).

On the tiny audit graph (GCN 8-16-4, kernel backend: the CUDA kernels on
the card, their plain versions on the CPU): train two epochs for a
checkpoint, then stand up a 3-replica fleet (a primary and 2 followers on
in-process transports) behind the router and check in one process that

  1. every replica cold-starts with its two CSR placements (the engine's
     and the delta manager's buffers) and, after the first, no kernel
     build,
  2. a 1000-event mixed query and delta stream keeps all replicas in seq
     lockstep with no CSR rebuild, no kernel build and no replan after
     warmup,
  3. a seeded hard kill (``fleet.replica.kill``) of one follower
     mid-stream never loses an acknowledged delta: the router keeps
     answering on the survivors, and the restarted replica replays its
     local WAL, then catches the missed records up through the snapshot
     protocol (checkpoint, truncated journal, tail segments),
  4. every replica's served logits match a single delta-enabled
     ServeEngine fed the same deltas, bitwise (0 ULPs),
  5. backpressure is typed and visible: deadline-expired requests and
     fleet sheds are counted in ``router.stats()``, never silent.

Exit 0 with a one-line summary per contract; any violation raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import warnings


def selftest(device: str = "cuda") -> int:
    import numpy as np

    from roc_tpu_torch.fault import SimulatedCrash, inject
    from roc_tpu_torch.fleet import (FleetRouter, InProcTransport, Replica,
                                     ReplicationLog)
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.obs.watchdog import PerfWatchdog
    from roc_tpu_torch.ops.aggregate import csr_build_count
    from roc_tpu_torch.ops.kernels.build import build_count
    from roc_tpu_torch.serve import ServeEngine, max_ulp_diff
    from roc_tpu_torch.serve.queue import Overloaded
    from roc_tpu_torch.train import checkpoint
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.driver import make_trainer

    tmp = tempfile.mkdtemp(prefix="roc_torch_fleet_")
    cfg = Config(dataset="roc-audit", layers=[8, 16, 4], num_epochs=2,
                 aggregate_backend="binned", serve_batch=8,
                 serve_wait_ms=1.0, device=device)
    ds = datasets.get(cfg.dataset, seed=cfg.seed)
    model = build_model(cfg.model, cfg.layers, cfg.dropout_rate, cfg.aggr,
                        heads=cfg.heads)

    trainer = make_trainer(cfg, ds, model)
    trainer.train(print_fn=lambda *_: None)
    ckpt = os.path.join(tmp, "fleet.ckpt.npz")
    checkpoint.save(ckpt, trainer.params, trainer.opt_state, trainer.epoch,
                    trainer.optimizer.alpha)
    del trainer

    wd = PerfWatchdog()
    n = ds.graph.num_nodes
    all_ids = np.arange(n, dtype=np.int32)

    def make_replica(name):
        return Replica(name, cfg, ds, model, ckpt,
                       os.path.join(tmp, f"{name}.wal"), watchdog=wd,
                       device=device)

    primary = make_replica("primary")
    followers = [make_replica("follower-1"), make_replica("follower-2")]
    replog = ReplicationLog(primary.engine)
    for rep in followers:
        rep.transport = replog.attach(InProcTransport())
    router = FleetRouter(primary, followers, replog, freshness_floor=0,
                         max_retries=1, watchdog=wd)
    # the oracle: one volatile delta-enabled engine fed every delta
    oracle = ServeEngine(cfg, ds, model, checkpoint_path=ckpt,
                         delta_journal="", device=device)

    for i, rep in enumerate(router.replicas):
        cs = rep.engine.cold_start_stats
        if cs["csr_builds"] != 2 or (i and cs["kernel_builds"]):
            raise AssertionError(
                f"{rep.name} cold start: {cs['csr_builds']} CSR "
                f"placements (want 2) and {cs['kernel_builds']} kernel "
                f"builds")
    print(f"# fleet selftest: 3 replicas cold-started on "
          f"{primary.engine.device}, 2 CSR placements and no kernel build "
          f"each after the first")

    for eng in (primary.engine, followers[0].engine, oracle):
        eng.warmup()
    base = (csr_build_count(), build_count())

    rng = np.random.default_rng(17)
    added: list = []
    deltas = answered = fleet_shed = 0
    kill_at, restart_at = 400, 700
    seq_at_kill = None

    def one_delta():
        nonlocal deltas
        if added and (len(added) >= 12 or rng.random() < 0.4):
            rets = np.stack([added.pop(0), added.pop(0)], 0)
            adds = None
        else:
            adds = rng.integers(0, n, (2, 2))
            added.extend(list(adds))
            rets = None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            router.apply_delta(adds, rets)   # primary + pump to followers
            oracle.apply_delta(adds, rets)   # same batch, single engine
        deltas += 1

    for event in range(1000):
        if event == kill_at:
            inject.configure("fleet.replica.kill=1")
            try:
                followers[1].kill()
                raise AssertionError("armed kill site did not fire")
            except SimulatedCrash:
                pass    # the crash is the drill
            finally:
                inject.configure("")
            seq_at_kill = primary.applied_seq
            replog.detach(followers[1].transport)
            print(f"# fleet selftest: follower-2 hard-killed at event "
                  f"{kill_at} (seq {seq_at_kill}); serving continues on "
                  f"{len(router.eligible())} replicas")
            for _ in range(3):
                one_delta()
        if event == restart_at:
            if (csr_build_count(), build_count()) != base:
                raise AssertionError("the stream rebuilt a CSR or built a "
                                     "kernel before the restart")
            followers[1].restart()
            if followers[1].applied_seq != seq_at_kill:
                raise AssertionError(
                    f"restart should replay the local WAL to the kill-time "
                    f"watermark {seq_at_kill}, got "
                    f"{followers[1].applied_seq}")
            followers[1].transport = replog.attach(InProcTransport())
            head = primary.applied_seq
            applied = router.pump()   # gap -> snapshot catch-up, in-line
            if router.catch_ups < 1 or \
                    followers[1].applied_seq != primary.applied_seq:
                raise AssertionError(
                    f"catch-up left follower-2 at seq "
                    f"{followers[1].applied_seq}, head "
                    f"{primary.applied_seq}")
            print(f"# fleet selftest: follower-2 restarted, replayed its "
                  f"WAL to seq {seq_at_kill}, snapshot catch-up to seq "
                  f"{head} ({applied} records this pump)")
            # the restart and the catch-up placed their CSRs on purpose;
            # from here to the end, none is the contract
            followers[1].engine.warmup()
            base = (csr_build_count(), build_count())
        if rng.random() < 0.05:
            one_delta()
        else:
            k = int(rng.integers(1, 9))
            ids = rng.integers(0, n, k).astype(np.int32)
            try:
                got = router.query(ids, timeout=120.0)
                if got.shape[0] != k:
                    raise AssertionError(f"{got.shape[0]} rows for {k} ids")
                answered += 1
            except Overloaded:
                fleet_shed += 1

    router.pump()
    head = primary.applied_seq
    for rep in router.replicas:
        if rep.applied_seq != head:
            raise AssertionError(f"{rep.name} at seq {rep.applied_seq}, "
                                 f"head {head}: fleet out of lockstep")
    print(f"# fleet selftest: 1000-event stream — {answered} answered, "
          f"{deltas} delta batches to seq {head}, {fleet_shed} shed at "
          f"the router")

    want = oracle.query(all_ids, timeout=120.0)
    if max_ulp_diff(router.query(all_ids, timeout=120.0), want):
        raise AssertionError("routed query diverged from the oracle")
    for rep in router.replicas:
        ulps = max_ulp_diff(rep.engine.query(all_ids, timeout=120.0), want)
        if ulps:
            raise AssertionError(f"{rep.name} diverged from the "
                                 f"single-engine oracle by {ulps} ULPs")
    print("# fleet selftest: parity — all 3 replicas bitwise-identical to "
          "the single-engine oracle (0 ULPs), incl. the restarted one")

    if (csr_build_count(), build_count()) != base:
        raise AssertionError("the drill rebuilt a CSR or built a kernel "
                             "outside the restart window")
    st = primary.engine.delta_stats()
    if st["replans"]:
        raise AssertionError("churn escalated to a replan")
    print("# fleet selftest: no CSR rebuild and no kernel build outside "
          "the restart window, zero replans")

    futs = [router.submit([int(i % n)], deadline_s=0.0) for i in range(16)]
    expired = 0
    for f in futs:
        try:
            f.result(timeout=30.0)
        except Overloaded:
            expired += 1
    rstats = router.stats()
    if not (expired > 0 and rstats["expired"] >= expired
            and wd.fleet_observed > 0):
        raise AssertionError(f"backpressure not counted: expired={expired}"
                             f", stats={rstats['expired']}, fleet feeds="
                             f"{wd.fleet_observed}")
    print(f"# fleet selftest: backpressure typed + counted "
          f"(expired={rstats['expired']}, shed={rstats['shed']}, "
          f"sibling_retries={rstats['sibling_retries']}); replication "
          f"lag EWMA fed {wd.fleet_observed} times, "
          f"{rstats['replog']['segments_shipped']} segments shipped")

    oracle.close()
    router.close()
    print("# fleet selftest: OK")
    return 0


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="python -m roc_tpu_torch.fleet")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--device", "-device", dest="device", default="cuda")
    args = p.parse_args(argv)
    if not args.selftest:
        p.print_usage(sys.stderr)
        return 2
    return selftest(args.device)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
