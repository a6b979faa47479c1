"""``python -m roc_tpu_torch.serve --selftest [--device cuda|cpu]
[--model gcn|gat] [-serve-batch N] [-serve-wait-ms MS] [-serve-queue-max N]
[-bf16] [-stream [-parts N]]``: the serving smoke gate (the contracts of
roc_tpu/serve/__main__.py).  The serving
flags reach the ``ServeEngine`` (window size, wait, queue cap),
``-bf16`` reaches ``load_frozen`` (x placed in bf16), as in the trainer's
CLI, and ``-stream`` serves through the streaming executor's slots (the
graph never placed whole; each forward sweeps the N shards, default 4).

On the tiny audit graph (GCN 8-16-4, or GAT 8-4-4 with 2 heads), or, from
Python, on ``selftest(dataset=...)``'s graph at its widths (hidden 16 for
GCN, 4 for GAT): write a
checkpoint, cold-start a ServeEngine from it, and assert in one process that

  1. cold start loads the checkpoint and serves its first forward,
  2. served logits match the eval forward to <= 32 ULPs,
  3. a 100-request mixed-size stream dispatches only ladder buckets,
     runs no forward (no graph install since warm-up: every dispatch is
     served from the logits slot) and, on CUDA, launches each kernel its
     launches per forward x the forwards actually run,
  4. (GCN in-core) the delta leg: journaled add/retire churn patches the
     CSR with no CSR rebuild, no kernel build and no new device buffer
     (the two col_idx buffers alternate), runs exactly one forward for
     each install a query follows (none for a no-op batch), serves rows
     bitwise equal to a fresh engine on the mutated graph, and a restart
     from the journal serves the same rows bitwise.

Exit 0 with a one-line summary per contract; any violation raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def selftest(device: str = "cuda", model_name: str = "gcn",
             serve_batch: int = 8, serve_wait_ms: float = 1.0,
             serve_queue_max: int = 4096, use_bf16: bool = False,
             stream: bool = False, parts: int = 4,
             dataset: str = "roc-audit") -> int:
    import numpy as np

    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.ops import prng
    from roc_tpu_torch.ops.kernels import KERNELS
    from roc_tpu_torch.serve import ServeEngine, max_ulp_diff, run_load
    from roc_tpu_torch.train import checkpoint
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.graph_data import forward_launches

    ds = datasets.get(dataset, seed=Config().seed)
    cfg = Config(dataset=dataset, model=model_name, heads=2,
                 layers=[ds.in_dim, 16 if model_name == "gcn" else 4,
                         ds.num_classes],
                 aggregate_backend="binned", serve_batch=serve_batch,
                 serve_wait_ms=serve_wait_ms,
                 serve_queue_max=serve_queue_max, use_bf16=use_bf16,
                 stream=stream, num_parts=parts if stream else 1)
    model = build_model(cfg.model, cfg.layers, cfg.dropout_rate, cfg.aggr,
                        heads=cfg.heads)
    per_forward = forward_launches(model, precision=cfg.aggregate_precision)
    if stream:  # each forward runs every layer once per shard
        per_forward = {k: v * parts for k, v in per_forward.items()}

    with tempfile.TemporaryDirectory(prefix="roc_torch_serve_") as tmp:
        ckpt = os.path.join(tmp, "serve.ckpt.npz")
        params = model.init_params(prng.prng_key(cfg.seed))
        checkpoint.save(ckpt, params)
        with ServeEngine(cfg, ds, model, checkpoint_path=ckpt,
                         device=device) as eng:
            cs = eng.cold_start_stats
            print(f"# serve selftest: cold start {cs['cold_start_s']:.3f}s "
                  f"on {eng.device}, buckets={cs['buckets']}, "
                  + (f"streamed through {parts} shards" if stream else
                     f"x {eng.bundle.x.dtype}"))

            # roclint: allow(host-sync) parity oracle fetched once, before serving starts
            oracle = eng.bundle.predict_logits().cpu().numpy()
            ids = np.arange(ds.graph.num_nodes, dtype=np.int32)
            ulps = max_ulp_diff(eng.query(ids, timeout=120.0), oracle[ids])
            if ulps > 32:
                raise AssertionError(f"served vs eval parity: {ulps} ULPs "
                                     f"> 32")
            print(f"# serve selftest: parity vs eval forward = {ulps} ULPs "
                  f"(gate: <=32)")

            eng.warmup()
            fwd0, reuse0 = eng.forwards, eng.logit_reuses
            disp0 = sum(eng.dispatches.values())
            before = {k: KERNELS[k].launches for k in per_forward}
            stats = run_load(eng, n_requests=100, qps=2000.0,
                             sizes=(1, 2, 3, 5, 8, 13))
            bad = set(eng.dispatches) - set(eng.buckets)
            if bad:
                raise AssertionError(f"dispatched off-ladder buckets {bad}")
            fwd = eng.forwards - fwd0
            reuses = eng.logit_reuses - reuse0
            disp = sum(eng.dispatches.values()) - disp0
            if fwd or reuses != disp:
                raise AssertionError(
                    f"{fwd} forwards and {reuses} logit reuses over {disp} "
                    f"dispatches with no graph install; expected 0 and "
                    f"{disp}")
            launches = {k: KERNELS[k].launches - v for k, v in before.items()}
            on_card = eng.device.type == "cuda"
            want = {k: v * fwd if on_card else 0
                    for k, v in per_forward.items()}
            if launches != want:
                raise AssertionError(f"{launches} kernel launches over {fwd} "
                                     f"forwards, expected {want}")
            print(f"# serve selftest: 100-request stream over {fwd} "
                  f"forwards and {reuses} logit reuses, {launches} kernel "
                  f"launches; "
                  f"p50={stats['p50_s'] * 1e3:.2f}ms "
                  f"p99={stats['p99_s'] * 1e3:.2f}ms "
                  f"({stats['qps_achieved']:.0f} qps achieved)")
        if model_name == "gcn" and not stream:
            _delta_leg(cfg, ds, model, ckpt, tmp, device, per_forward)
    print("# serve selftest: OK")
    return 0


def _delta_leg(cfg, ds, model, ckpt, tmp, device, per_forward) -> None:
    """Journaled churn on the patch path with queries between the batches
    (one forward an install, the kernels launched for those forwards),
    parity against a fresh engine on the mutated graph, and a restart
    replaying the journal."""
    import dataclasses
    import warnings

    import numpy as np

    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.ops.aggregate import csr_build_count
    from roc_tpu_torch.ops.kernels import KERNELS
    from roc_tpu_torch.ops.kernels.build import build_count
    from roc_tpu_torch.serve import ServeEngine, max_ulp_diff

    jpath = os.path.join(tmp, "deltas.wal")
    n = ds.graph.num_nodes
    ids = np.arange(n, dtype=np.int32)
    rng = np.random.default_rng(7)
    with ServeEngine(cfg, ds, model, checkpoint_path=ckpt, device=device,
                     delta_journal=jpath) as eng:
        eng.warmup()
        builds0 = (csr_build_count(), build_count())
        ptrs = set()
        installs = 0
        before = {k: KERNELS[k].launches for k in per_forward}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for _ in range(10):
                adds = rng.integers(0, n, (2, 2))
                rets = None
                if rng.random() < 0.3:
                    rets = np.stack([ds.graph.col_idx[:1],
                                     ds.graph.dst_idx[:1]], 1)
                fwd0 = eng.forwards
                mode = eng.apply_delta(adds, rets)["mode"]
                ptrs.update(eng.deltas.buffer_ptrs())
                eng.query(adds[:, 1], timeout=120.0)
                eng.query(adds[:, 1], timeout=120.0)
                want = 1 if mode == "applied" else 0
                if eng.forwards - fwd0 != want:
                    raise AssertionError(
                        f"a {mode!r} batch then two queries ran "
                        f"{eng.forwards - fwd0} forwards, expected {want}")
                installs += want
        launches = {k: KERNELS[k].launches - v for k, v in before.items()}
        want = {k: v * installs if eng.device.type == "cuda" else 0
                for k, v in per_forward.items()}
        if launches != want:
            raise AssertionError(f"{launches} kernel launches over "
                                 f"{installs} forwards, expected {want}")
        served_mut = eng.query(ids, timeout=120.0)
        if (csr_build_count(), build_count()) != builds0 or len(ptrs) != 2:
            raise AssertionError("the delta patch path rebuilt a CSR, "
                                 "built a kernel or allocated a buffer")
        st = eng.delta_stats()
        if st["replans"] or not st["applied_adds"]:
            raise AssertionError(f"delta churn left the patch path: {st}")
        live = eng.deltas._live_edges()
        fresh_ds = dataclasses.replace(ds, graph=from_edges(n, *live))
        with ServeEngine(cfg, fresh_ds, model, checkpoint_path=ckpt,
                         device=device, start_queue=False) as fresh:
            want = fresh.bundle.predict_logits()
        ulps = max_ulp_diff(served_mut, want)
        if ulps:
            raise AssertionError(f"patched vs fresh engine: {ulps} ULPs")
    with ServeEngine(cfg, ds, model, checkpoint_path=ckpt, device=device,
                     delta_journal=jpath) as eng:
        served_replay = eng.query(ids, timeout=120.0)
    ulps = max_ulp_diff(served_replay, served_mut)
    if ulps:
        raise AssertionError(f"journal restart-replay parity: {ulps} ULPs")
    print(f"# serve selftest: delta leg — {st['batches']} batches "
          f"({st['applied_adds']} adds, {st['applied_retires']} retires, "
          f"{st['noop_adds'] + st['noop_retires']} no-ops, "
          f"{st['cells_patched']} rows patched), zero CSR rebuilds, zero "
          f"kernel builds, two buffers, one forward for each of "
          f"{installs} installs a query followed; fresh-engine and "
          f"restart-replay parity = 0 ULPs")


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="python -m roc_tpu_torch.serve")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", default="gcn", choices=["gcn", "gat"])
    p.add_argument("-serve-batch", dest="serve_batch", type=int, default=8)
    p.add_argument("-serve-wait-ms", dest="serve_wait_ms", type=float,
                   default=1.0)
    p.add_argument("-serve-queue-max", dest="serve_queue_max", type=int,
                   default=4096)
    p.add_argument("-bf16", dest="use_bf16", action="store_true")
    p.add_argument("-stream", action="store_true")
    p.add_argument("-parts", type=int, default=4)
    args = p.parse_args(argv)
    if not args.selftest:
        p.print_usage(sys.stderr)
        return 2
    return selftest(args.device, args.model, args.serve_batch,
                    args.serve_wait_ms, args.serve_queue_max, args.use_bf16,
                    args.stream, args.parts)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
