"""The ``serve`` traffic: open-loop node queries through
``ServeEngine.submit()`` at the mix's fixed rate, and, where the mix has
``deltas``, a second open-loop stream of edge-delta batches through
``ServeEngine.apply_delta()`` on its own thread, with the engine's
write-ahead journal under ``TMPDIR``.

A warm phase of ``warm_s`` runs the same mix first (every bucket, the
patch path and the queue's thread); it is set-up.  The window then offers
``--seconds`` of queries and batches, and waits for every answer.  Once
it has closed, ``probe_queries`` queries on nodes the window's batches
touched go through the same engine, untimed, for the check alone.

What set-up made is frozen out of the garbage collector's full passes
for the window (``Collector``), as a long-running server's heap is once
it is warm: a full pass over it stops every thread for about a quarter
of a second, three times in a 20 s window, which put the p95 at the edge
of the stalled queries' share and swung it from run to run.  What the
window itself makes is collected as usual, and each pause is reported
(``gc_pause_ms.serve``).  The p95 still swings with the host's speed
(PERF.md section 2), so the median is the end-to-end latency and the p95
a per-layer reading (``p95_ms.serve``)."""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from perfbench import inputs, loadgen, port, reference
from perfbench.trace import DeviceTrace, label
from perfbench.train_run import free

STREAM_WARM, STREAM_WINDOW = 21, 22


def build_engine(cfg, traffic, seed: int, device, journal: str = None,
                 use_bf16: bool = False):
    """The port's engine on the seed's inputs and weights, every bucket
    served once; (engine, its dataset).  ``use_bf16`` switches on the
    port's ``-bf16`` path (the control).  Stops where the drawn leaves
    are not the engine's parameters."""
    from roc_tpu_torch.serve import ServeEngine
    conf, model = port.build(cfg, seed, device, use_bf16,
                             serve_batch=int(traffic["serve_batch"]),
                             serve_wait_ms=float(traffic["serve_wait_ms"]))
    ds, weights = inputs.for_port(cfg, seed, device)
    eng = ServeEngine(conf, ds, model, device=device, delta_journal=journal)
    eng.bundle.params = port.leaves_for(eng.bundle.params, weights,
                                        eng.device)
    eng.warmup()
    return eng, ds


def probe_schedule(traffic, seed, batches):
    """``probe_queries`` queries of the mix's largest size, drawn from the
    seed among the nodes whose in-edges the batches change (all offered
    at once, after the window)."""
    nodes = np.unique(np.concatenate(
        [np.concatenate([add[:, 1], ret[:, 1]]) for add, ret in batches]))
    rng = np.random.default_rng([int(seed), 29])
    k = max(int(v) for v in traffic["sizes"])
    return [(0.0, rng.choice(nodes, min(k, nodes.size),
                             replace=False).astype(np.int32))
            for _ in range(int(traffic.get("probe_queries", 0)))]


class Collector:
    """``with Collector(watch):`` collects what set-up made and freezes it
    (``gc.freeze``) for the block, then unfreezes it.  Collections of what
    the block makes still run; with ``watch`` their pauses go to
    ``pauses_ms``."""

    def __init__(self, watch: bool):
        self.watch = watch
        self.pauses_ms = []
        self._start = 0.0

    def _note(self, stage, info):
        now = time.perf_counter()
        if stage == "start":
            self._start = now
        else:
            self.pauses_ms.append((now - self._start) * 1e3)

    def __enter__(self):
        gc.collect()
        gc.freeze()
        if self.watch:
            gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        if self.watch:
            gc.callbacks.remove(self._note)
        gc.unfreeze()
        return False


def phase(eng, queries, dbatches, patch_s):
    """Offer ``queries`` on this thread and ``dbatches`` on another from
    one start, then wait for every answer; (t0, query offers, batch
    offers).  Each applied batch's ``last_patch`` seconds go to
    ``patch_s``."""
    def apply(batch):
        r = eng.apply_delta(*batch)
        lp = eng.deltas.last_patch
        patch_s.append(sum(lp.get(k, 0.0) for k in
                           ("classify_s", "journal_s", "rewrite_s",
                            "install_s")))
        return r

    t0 = time.perf_counter() + 0.05
    got = {}
    th = None
    if dbatches:
        th = threading.Thread(target=lambda: got.update(
            d=loadgen.offer(dbatches, apply, t0,
                            label=lambda: label("delta"))))
        th.start()
    sent = loadgen.offer(queries, eng.submit, t0,
                         label=lambda: label("submit"))
    if th is not None:
        th.join()
    loadgen.settle(sent, 60.0)
    return t0, sent, got.get("d", [])


def run(ctx) -> dict:
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    deltas = traffic.get("deltas")
    jdir = tempfile.mkdtemp(prefix="perfbench_") if deltas else None
    try:
        return _run(ctx, cfg, traffic, dev, deltas, jdir)
    finally:
        if jdir:
            shutil.rmtree(jdir, ignore_errors=True)


def _run(ctx, cfg, traffic, dev, deltas, jdir):
    from roc_tpu_torch import obs
    eng, ds = build_engine(cfg, traffic, ctx.seed, dev,
                           journal=(jdir + "/deltas.wal") if jdir else None,
                           use_bf16=getattr(ctx, "use_bf16", False))
    n, e = ds.graph.num_nodes, ds.graph.num_edges
    warm_s = float(traffic["warm_s"])
    warm = inputs.query_schedule(traffic, ctx.seed, STREAM_WARM, warm_s, n)
    window = inputs.query_schedule(traffic, ctx.seed, STREAM_WINDOW,
                                   ctx.seconds, n)
    batches, every = [], 0.0
    if deltas:
        every = float(deltas["every_s"])
        n_warm = int(math.ceil(warm_s / every))
        n_win = int(math.ceil(ctx.seconds / every))
        batches = inputs.delta_batches(traffic, ctx.seed, n_warm + n_win,
                                       ds.graph.row_ptr, ds.graph.col_idx)
        warm_b = [(i * every, b) for i, b in enumerate(batches[:n_warm])]
        win_b = [(i * every, b) for i, b in enumerate(batches[n_warm:])]

    patch_s = []
    phase(eng, warm, warm_b if deltas else [], patch_s)
    ctx.sync()
    with Collector(ctx.trace) as coll:
        obs.get_tracer().clear()
        obs.enable(ctx.trace)
        fwd0, served0 = eng.forwards, eng.queue.served
        patch_s.clear()
        ctx.reset_peak()
        with DeviceTrace(ctx.trace) as trace:
            t0, sent, dsent = phase(eng, window, win_b if deltas else [],
                                     patch_s)
            ctx.sync()
            t1 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    peak = ctx.peak()
    spans = [s.dur_ns / 1e6 for s in obs.get_tracer().spans()
             if s.name == "serve_window"]
    obs.enable(False)
    forwards = eng.forwards - fwd0
    answered = eng.queue.served - served0
    lat = [loadgen.latency_s(o, "t_done") for o in sent]
    dlat = [loadgen.latency_s(o) for o in dsent]
    failed = sum(1 for o in sent if o.error is not None) + \
        sum(1 for o in dsent if o.error is not None)
    # the order of applied batches and when each was acknowledged
    acks = [(o.sent, o.returned) for o in dsent]
    n_warm_b = len(batches) - len(dsent) if deltas else 0
    probes = []
    if deltas:
        probes = loadgen.offer(
            probe_schedule(traffic, ctx.seed, batches[n_warm_b:]),
            eng.submit, time.perf_counter())
        loadgen.settle(probes, 60.0)
    eng.close()
    del eng
    free()
    numbers = check_served(cfg, traffic, ctx.seed, dev, sent, batches,
                           n_warm_b, acks, probes,
                           getattr(ctx, "control_tf32", False))
    late = [o.late_s for o in sent]
    p95 = loadgen.percentile(lat, 0.95) * 1e3
    notes = {"queries": len(sent), "batches": len(dsent),
             "offer_late_p95_ms": loadgen.percentile(late, 0.95) * 1e3,
             "achieved_qps": len(sent) / max(t1 - t0, 1e-9),
             "p95_ms": p95, "p99_ms": loadgen.percentile(lat, 0.99) * 1e3}
    if deltas:
        # too noisy from run to run to hold a bound (PERF.md, Open
        # questions): reported beside the result, not as a metric
        notes["delta_p95_ms"] = loadgen.percentile(dlat, 0.95) * 1e3
    return {
        "attempted": len(sent) + len(dsent), "failed": failed,
        "end_to_end": {"serve_p50_ms": loadgen.percentile(lat, 0.5) * 1e3,
                       "peak_mem_mib": peak / 2 ** 20, "setup_s": setup_s},
        "memory_peak_bytes": peak, "numbers": numbers, "notes": notes,
        "layer": {"kind": "serve", "cfg": cfg, "nodes": n, "edges": e,
                  "answered": answered, "forwards": forwards,
                  "window_spans_ms": spans, "patch_s": list(patch_s),
                  "gc_pauses_ms": coll.pauses_ms, "p95_ms": p95,
                  "trace": trace.summary},
    }


# -- the check ----------------------------------------------------------------

def _base_count(rp, col, s: int, d: int) -> int:
    return int(np.count_nonzero(col[rp[d]:rp[d + 1]] == s))


def signed_ops(batches, rp, col):
    """Each batch's effective signed edge instances as the port's contract
    defines them (adds before retires; re-adding a live pair or retiring
    a dead one is a no-op), worked out from the base CSR."""
    live: dict = {}
    out = []
    for add, ret in batches:
        ops = []
        for sign, pairs in ((1, add), (-1, ret)):
            for s, d in pairs.tolist():
                c = live.get((s, d))
                if c is None:
                    c = _base_count(rp, col, s, d)
                if (sign > 0 and c > 0) or (sign < 0 and c <= 0):
                    live[(s, d)] = c
                    continue
                live[(s, d)] = c + sign
                ops.append((s, d, sign))
        out.append(ops)
    return out


def check_served(cfg, traffic, seed, device, sent, batches, n_warm_b,
                 acks, probes=(), control_tf32: bool = False) -> dict:
    """The widest gap between a served logit and the reference's, over a
    sample (drawn from the seed) of ``check_queries`` answered queries
    with the longest among them, and over the ``probes`` offered after the
    window.  A query answered while a batch was in flight may rightly
    read the graph before or after it: it is held to the closer of the
    states its window could have read; a probe to the state after every
    batch.  With ``control_tf32`` the reference with TF32 GEMMs stands in
    the program's place: its rows at the same queries and states are
    judged instead of the served ones."""
    ok = [o for o in sent if o.error is None]
    if len(ok) < len(sent) or not ok or \
            any(o.error is not None for o in probes):
        return {"logit_gap": math.inf}
    rng = np.random.default_rng([int(seed), 23])
    k = int(traffic["check_queries"])
    longest = max(len(o.payload) for o in ok)
    pick = [i for i, o in enumerate(ok) if len(o.payload) == longest][:4]
    chosen = set(pick)
    rest = [i for i in range(len(ok)) if i not in chosen]
    pick += rng.choice(rest, min(k, len(rest)), replace=False).tolist()
    # states: b = batches applied; the window's batches start at n_warm_b
    items = []
    for i in pick:
        o = ok[i]
        lo = n_warm_b + sum(1 for _, ret in acks if ret < o.sent)
        hi = n_warm_b + sum(1 for call, _ in acks
                            if call < o.result.t_done)
        items.append((o, range(lo, hi + 1)))
    last = n_warm_b + len(acks)
    items += [(o, range(last, last + 1)) for o in probes]
    inp = inputs.make(cfg, seed, device)
    rp = inp.row_ptr.cpu().numpy()
    col = inp.col_idx.cpu().numpy()
    base = reference.graph_for(cfg, inp.row_ptr, inp.col_idx, train=False)
    ops = signed_ops(batches, rp, col) if batches else []
    best = [math.inf] * len(items)
    scales = []
    for b in sorted({b for _, r in items for b in r}):
        g = base
        if b:
            flat = [op for batch in ops[:b] for op in batch]
            t = torch.tensor(flat, dtype=torch.int64, device=device)
            g = base.with_extra(t[:, 0], t[:, 1], t[:, 2].float())
        ref = reference.logits(cfg, inp.weights, inp, g)
        ctl = reference.logits(cfg, inp.weights, inp, g, tf32=True) \
            if control_tf32 else None
        for j, (o, states) in enumerate(items):
            if b not in states:
                continue
            ids = torch.as_tensor(o.payload, dtype=torch.int64,
                                  device=device)
            want = ref[ids].double().cpu().numpy()
            got = np.asarray(o.result.result(0), np.float64) \
                if ctl is None else ctl[ids].double().cpu().numpy()
            best[j] = min(best[j], float(np.abs(got - want).max()))
            scales.extend(np.abs(want).max(axis=1).tolist())
        del ref, ctl
    del inp, base
    free()
    scale = float(np.median(scales))
    worst = max(best)
    return {"logit_gap": worst / scale if scale > 0 else math.inf,
            "rows": sum(len(o.payload) for o, _ in items)}
