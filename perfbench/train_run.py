"""The ``train`` traffic: back-to-back ``Trainer.run_epoch()`` steps on
the full graph, dispatched ahead; the host syncs only at the window's end.

Set-up builds one trainer, hands it the seed's weights, drives it through
``checked_steps`` steps (the steps the reference follows), then
``warm_steps`` more, and hands that same trainer to the window."""

from __future__ import annotations

import gc
import math
import time

import torch

from perfbench import inputs, port, reference
from perfbench.check import train_numbers
from perfbench.trace import DeviceTrace, label


def build_trainer(cfg, seed: int, device, use_bf16: bool = False):
    """The port's trainer on the seed's inputs, with the seed's weights
    and a fresh Adam state; ``use_bf16`` switches on the port's ``-bf16``
    path (the control).  Stops where the drawn leaves are not the
    trainer's parameters."""
    from roc_tpu_torch.train.driver import Trainer
    conf, model = port.build(cfg, seed, device, use_bf16,
                             learning_rate=float(cfg["learning_rate"]),
                             weight_decay=float(cfg["weight_decay"]),
                             eval_every=1 << 30)
    ds, weights = inputs.for_port(cfg, seed, device)
    tr = Trainer(conf, ds, model)
    tr.params = port.leaves_for(tr.params, weights, tr.device)
    tr.opt_state = tr.optimizer.init(tr.params)
    return tr, (ds.graph.num_nodes, ds.graph.num_edges)


def _norms(leaves) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def checked_steps(tr, steps: int) -> dict:
    """Run ``steps`` steps through ``run_epoch``; the losses, each leaf's
    first gradient as Adam got it (from its first moment after one step,
    m / (1 - beta1)) and each leaf's change after ``steps``."""
    w0 = {k: v.clone() for k, v in tr.params.items()}
    losses, grad1 = [], None
    for _ in range(steps):
        losses.append(tr.run_epoch())
        if grad1 is None:
            b1 = tr.optimizer.beta1
            grad1 = _norms({k: m / (1.0 - b1)
                            for k, m in tr.opt_state.m.items()})
    change = _norms({k: tr.params[k] - w0[k] for k in w0})
    return {"losses": [float(v) for v in losses], "grad1": grad1,
            "change": change}


def free():
    """Collect what the caller dropped and give the cached device memory
    back."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_numbers(cfg, seed: int, device, prog: dict, steps: int,
                      detail: dict = None):
    inp = inputs.make(cfg, seed, device)
    ref = reference.train_steps(cfg, inp, steps, seed)
    del inp
    free()
    if detail is not None:
        detail.update(prog=prog, ref=ref)
    return train_numbers(prog, ref)


def run(ctx) -> dict:
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    tr, (n, e) = build_trainer(cfg, ctx.seed, dev)
    steps = int(traffic["checked_steps"])
    prog = checked_steps(tr, steps)
    for _ in range(int(traffic["warm_steps"])):
        tr.run_epoch()
    ctx.sync()
    ctx.reset_peak()
    losses, dispatch = [], []
    with DeviceTrace(ctx.trace) as trace:
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        while time.perf_counter() - t0 < ctx.seconds:
            with label("step"):
                ts = time.perf_counter()
                losses.append(tr.run_epoch())
                dispatch.append(time.perf_counter() - ts)
        ctx.sync()
        t1 = time.perf_counter()
    peak = ctx.peak()
    bad = int((~torch.isfinite(torch.stack(losses))).sum())
    del tr, losses
    free()
    numbers = reference_numbers(cfg, ctx.seed, dev, prog, steps)
    window_s = t1 - t0
    return {
        "attempted": len(dispatch), "failed": bad,
        "end_to_end": {"step_ms": window_s / len(dispatch) * 1e3,
                       "peak_mem_mib": peak / 2 ** 20,
                       "setup_s": setup_s},
        "memory_peak_bytes": peak, "numbers": numbers,
        "layer": {"kind": "train", "cfg": cfg, "nodes": n, "edges": e,
                  "steps": len(dispatch), "dispatch_s": dispatch,
                  "trace": trace.summary},
    }


def readings(cfg, traffic, seed: int, device, mode: str = "program",
             detail: dict = None):
    """The compared numbers of one seed with no window, against the
    reference: of the program (``program``), or of a control, a step
    below the float32 GEMMs with TF32 off that the configuration states:
    the program with its own ``-bf16`` path on (``bf16``: bfloat16
    features and tensor-core GEMMs), or the reference in the program's
    place with TF32 GEMMs (``tf32``)."""
    steps = int(traffic["checked_steps"])
    if mode == "tf32":
        inp = inputs.make(cfg, seed, device)
        prog = reference.train_steps(cfg, inp, steps, seed, tf32=True)
        del inp
    else:
        tr, _ = build_trainer(cfg, seed, device, use_bf16=mode == "bf16")
        prog = checked_steps(tr, steps)
        del tr
    free()
    out = reference_numbers(cfg, seed, device, prog, steps, detail)
    return {k: (v if math.isfinite(v) else float("inf"))
            for k, v in out.items()}
