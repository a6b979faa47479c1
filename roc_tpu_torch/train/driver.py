"""Training driver (roc_tpu/train/driver.py): the single-device trainer.

Per epoch, as the reference's loop (gnn.cc:99-111) and the JAX driver
(driver.py:913-1040):
  * every ``decay_steps`` epochs (not epoch 0) the learning rate is
    multiplied by ``decay_rate``;
  * one train step: forward, backward (autograd; every aggregation,
    megakernel and attention layer has its own backward kernels) and the
    guarded Adam update, the loss first multiplied by the ``step.nan``
    scale when the fault harness fires it (``fault.nan_scale``: NaN
    then, else 1.0 and no multiply);
  * the epoch ends with a device sync, and ``epoch_times`` are the synced
    times (the ``epoch`` span's durations);
  * every ``eval_every`` epochs an inference forward prints the reference's
    metric line.

The parameters and the dropout masks are roc_tpu's bits (ops/prng.py):
the run's key is ``PRNGKey(seed)``, the Glorot init draws from it, and
epoch e's masks from ``fold_in(key, e)`` (driver.py:917), on any device.
A checkpoint carries the key (``extra["rng_key"]``, driver.py:1050), and a
resumed run takes it back, so it draws the masks the unbroken run would
have, whatever ``-seed`` it was started with.

Run controls (driver.py:475-1027):
  * non-finite steps are skipped by the guard; after
    ``NONFINITE_ESCALATE_AFTER`` in a row the ladder's rung 1 turns
    ``-megafuse`` off and rebuilds the graph context (params, Adam state
    and epoch kept), rung 2 restores the checkpoint or, without one,
    carries on with skipped updates;
  * SIGTERM and SIGINT only set a flag: the loop finishes the epoch in
    flight, stops, writes the final checkpoint and restores the previous
    handlers (installed on the main thread only);
  * ``-profile DIR`` traces ``-profile-epochs`` START:COUNT epochs with
    torch.profiler into DIR/trace.json (Chrome trace), closed in a
    ``finally``;
  * ``-obs`` records the spans ``train``, ``epoch``, ``step_dispatch``,
    ``device_sync``, ``metrics_fetch``, ``eval`` and ``checkpoint``, one
    ``metrics`` record an epoch (fetched after the timed window; on CUDA
    with ``mfu`` and ``roofline_frac`` from ``obs/roofline.py``, whose
    peaks are the card's), the watchdog's alerts and a closing ``train``
    record, into ``obs_dir``'s trace.json, metrics.jsonl and
    metrics.prom.  The calibration ledger rides the same stream
    (driver.py:560-625, 728-745): the estimator's ``step_time`` and the
    plan's ``peak_memory`` are predicted at setup and measured each epoch
    (``peak_memory`` only where ``_peak_hbm`` measured it), and the
    joined ratios feed the watchdog's calibration EWMAs.

The memory planner (driver.py:713-795): ``-mem-plan``/``-mem-budget``
choose a plan at setup (``_resolve_mem_plan``; its summary under ``-v``),
and the step's loss runs under it (``_loss_fn``: the model's own loss for
an all-KEEP plan, ``memory/policy.py``'s checkpointed forward otherwise).
``TrainStats.peak_hbm_bytes`` is the card's measured peak, or the plan's
prediction on the CPU (``peak_hbm_source``).

``-autotune`` / ``ROC_AUTOTUNE=1`` (driver.py:217-253): before
``dense_graph_data`` places the CSR, ``maybe_autotune`` sweeps the launch
configurations of the kernels the step runs over it (``tune/``: timed on
the card, the seeded surrogate on the CPU) and merges the winners into the
tuned store, which that placement then reads, so the run that tunes is the
run that consumes.  A tuner failure warns and the run goes on at the
kernels' own launch rule; no launch changes a bit.  The streaming and
SPMD trainers' per-part CSRs have their own content and keep the rule.

``make_trainer`` picks the trainer (driver.py:1170-1196): the streaming
executor under ``-stream`` (``stream/executor.py``), else the
``-stream-budget`` gate, else the SPMD trainer for ``-parts > 1``
(``parallel/spmd.py``), else this single-device trainer.

``-multihost`` (driver.py:1066-1073): the trainer joins the process group
of ``parallel/collectives.py`` before it builds anything, on
``cuda:{LOCAL_RANK}`` unless ``-device`` names another; process 0 alone
writes a checkpoint, and every process then waits at a barrier.  The
single-device trainer under ``-multihost`` trains the whole graph on each
process, as roc_tpu's does on a one-part mesh.

The online balancer (driver.py:505-530, 969-1000; ``balance/``): with
``-balance-every N`` a trainer that can reshard (the SPMD trainer's vertex
modes at k = 1) runs a balance round every N epochs, never after the last;
any other trainer ignores the flag with a note under ``-v``.  Each epoch's
time goes into the balancer's telemetry; the rounds' decisions come back
in ``TrainStats.rebalance_events``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
from typing import Optional

import torch

from roc_tpu_torch import obs
from roc_tpu_torch.device import resolve_device
from roc_tpu_torch.fault import inject
from roc_tpu_torch.fault.guard import guarded_update, nan_scale
from roc_tpu_torch.graph.datasets import Dataset
from roc_tpu_torch.models.model import Model
from roc_tpu_torch.obs import roofline
from roc_tpu_torch.obs.channel import global_norm
from roc_tpu_torch.obs.ledger import content_key, get_ledger
from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.softmax import PerfMetrics, format_metrics, \
    perf_metrics
from roc_tpu_torch.optim.adam import Adam
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.graph_data import (dense_graph_data,
                                            effective_backend,
                                            host_to_device, make_gctx,
                                            model_has_gat, tune_targets)

# Consecutive skipped steps before the escalation ladder engages
# (driver.py:475): one bad batch skips silently; K in a row means the run
# is not recovering on its own.
NONFINITE_ESCALATE_AFTER = 3

# The cost models whose ratio the watchdog judges off the card: exact by
# construction, so a drift is a bug wherever it runs (roc_tpu's
# plan_steps and staging_rows have no producer in the port).
_EXACT_MODELS = ("wire_bytes",)


@dataclasses.dataclass
class TrainStats:
    """What one ``train()`` call measured (driver.py:453-468).
    ``epoch_times`` are the synced per-epoch times and exclude eval and
    checkpointing; ``total_s`` includes them.  ``peak_hbm_bytes`` is each
    epoch's peak device memory: ``torch.cuda.max_memory_allocated`` over
    the train step on the card, the memory plan's prediction on the CPU;
    ``peak_hbm_source`` says which ("measured" | "estimated")."""
    epoch_times: list
    total_s: float
    epochs: int
    final_loss: float
    peak_hbm_bytes: list = dataclasses.field(default_factory=list)
    peak_hbm_source: str = ""
    rebalance_events: list = dataclasses.field(default_factory=list)


def maybe_autotune(cfg: Config, graph, model: Model, device: torch.device,
                   watchdog=None, log=None):
    """-autotune / ROC_AUTOTUNE: sweep the launch configurations of the
    kernels ``model``'s step runs over ``graph``'s CSR and its transpose
    (``tune.autotune_graph``: CUDA-event trials on the card, the seeded
    surrogate on the CPU) and persist the winners in the tuned store
    before the CSR is placed.  Failure-isolated as roc_tpu's
    (driver.py:217-238): a tuner error warns and returns None, and the
    kernels keep their own launch rule."""
    import warnings
    try:
        from roc_tpu_torch.tune import autotune_graph
        from roc_tpu_torch.tune.store import storage_of
        widths, gats = tune_targets(model, cfg.megafuse)
        with obs.span("autotune", edges=int(graph.num_edges)):
            return autotune_graph(
                graph.col_idx, graph.dst_idx, graph.num_nodes,
                graph.num_nodes,
                storage_dtype=storage_of(cfg.aggregate_precision),
                fuse_linear=cfg.megafuse, seed=0,
                device=device.type == "cuda", sum_widths=widths,
                gat_shapes=gats, watchdog=watchdog, log=log,
                cuda_device=device)
    except Exception as e:      # a tuning artifact never stops a run
        warnings.warn(f"autotune failed ({e}); continuing untuned")
        return None


def device_sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dropout_key(seed: int, epoch: int) -> prng.Key:
    """The key an epoch's dropout masks draw from in a run started with
    ``seed`` and never resumed."""
    return prng.fold_in(prng.prng_key(seed), epoch)


class Trainer:
    """Single-device full-graph trainer, on CUDA unless
    ``config.device`` asks for the CPU."""

    def __init__(self, config: Config, dataset: Dataset, model: Model):
        self.config = config
        self.dataset = dataset
        self.model = model
        self.comm = None
        if config.multihost:
            from roc_tpu_torch.parallel import collectives
            self.device = resolve_device(
                collectives.process_device(config.device))
            self.comm = collectives.init_process_group(self.device)
        else:
            self.device = resolve_device(config.device)
        self.optimizer = Adam(alpha=config.learning_rate,
                              weight_decay=config.weight_decay)
        self.key = prng.prng_key(config.seed)
        self.dtype = torch.bfloat16 if config.use_bf16 else torch.float32
        self.epoch = 0
        self.epoch_times: list = []
        # the fault harness arms -fault specs that came by the flag (the
        # ROC_FAULT path armed at import); the host side of the guard
        if config.fault and config.fault != inject.spec():
            inject.configure(config.fault)
        self.nonfinite_skips = 0
        self._nf_streak = 0
        self._nf_stage = 0
        self._last_nonfinite = None
        self._last_gnorm = None
        self._stop_signal = None
        self._obs_init()
        self._setup()
        self.balancer = None
        if config.balance_every:
            if self._balance_supported():
                self._balancer_init()
            elif config.verbose:
                print("# -balance-every: online balancing needs the SPMD "
                      "vertex-sharded path (parts > 1, k = 1, no "
                      "-perhost/-edge-shard/ring); disabled for this run")
        if config.resume and config.checkpoint_path and \
                os.path.exists(config.checkpoint_path):
            self.restore(config.checkpoint_path)

    def _balance_supported(self) -> bool:
        """Can this trainer apply a repartition mid-run?  The SPMD trainer
        overrides this for the modes its ``reshard`` handles."""
        return False

    def _balancer_init(self):
        """The balancer, its warm-start prior priced at the run's halo
        bytes (the dataset's width, 2-byte rows under bf16 storage or
        bf16 features); under -obs its telemetry joins the metrics stream
        unless -balance-trace names a file of its own."""
        from roc_tpu_torch.balance import BalanceManager, TelemetryBuffer
        cfg = self.config
        wire2 = cfg.bf16_storage or cfg.use_bf16
        shared = None
        if self._metrics is not None and not cfg.balance_trace:
            shared = TelemetryBuffer(trace_path=self._metrics.jsonl_path)
        self.balancer = BalanceManager.from_config(
            cfg, halo_width=self.dataset.in_dim,
            halo_itemsize=2 if wire2 else 4, telemetry=shared)
        self.balancer.watchdog = self.watchdog

    def _setup(self):
        """Place the graph data, features, labels and mask, build the graph
        context and init the params and Adam state (the ladder's rung 1
        calls it again and puts back what it keeps)."""
        cfg, ds, dev = self.config, self.dataset, self.device
        backend = effective_backend(cfg, self.model, dev)
        # the ladder's rung 1 calls _setup again: the graph is tuned once
        if cfg.autotune and not getattr(self, "_autotuned", False):
            self._autotuned = True
            maybe_autotune(cfg, ds.graph, self.model, dev,
                           watchdog=self.watchdog,
                           log=print if cfg.verbose else None)
        self.gdata = dense_graph_data(
            ds.graph, backend, cfg.aggregate_precision, dev,
            edge_map=backend == "kernel" and model_has_gat(self.model),
            megafuse=cfg.megafuse)
        self.gctx = make_gctx(self.gdata, cfg.megafuse, cfg.fusion_depth)
        self.x = host_to_device(ds.features, dev, self.dtype)
        self.labels = torch.as_tensor(ds.onehot_labels(),
                                      dtype=torch.float32, device=dev)
        self.mask = torch.as_tensor(ds.mask, dtype=torch.int32, device=dev)
        self.params = self.model.init_params(self.key, device=dev)
        self.opt_state = self.optimizer.init(self.params)
        self._resolve_mem_plan()
        self._loss = self._loss_fn()

    # -- the memory planner (driver.py:713-799) ---------------------------
    def _resolve_mem_plan(self):
        """Choose this run's activation-memory plan from -mem-plan and
        -mem-budget (``auto`` without a budget plans for the card's
        memory, and keeps everything on the CPU).  Keeps the estimate,
        the plan, and the tensors the port's checkpoints keep beyond the
        plan's saved set (``mem_crossing_bytes``)."""
        from roc_tpu_torch import memory
        from roc_tpu_torch.memory import policy
        cfg = self.config
        self.mem_estimate = memory.estimate_for_trainer(self)
        budget = cfg.mem_budget_bytes()
        if cfg.mem_plan == "auto" and budget == 0:
            budget = memory.device_budget_bytes(self.device)
        self.mem_plan = memory.plan_memory(
            self.mem_estimate, mode=cfg.mem_plan, budget_bytes=budget,
            offload_executed=cfg.stream,
            offload_spills=bool(cfg.stream_spill))
        self.mem_crossing_bytes = 0
        gctx = getattr(self, "gctx", None)
        if self.mem_plan.any_remat() and gctx is not None:
            from roc_tpu_torch.memory.estimator import _op_out_dims
            dims = _op_out_dims(self.model)
            itemsize = torch.finfo(self.dtype).bits // 8
            self.mem_crossing_bytes = sum(
                self.mem_estimate.rows * dims[t] * itemsize
                for t in policy.crossing_tids(
                    self.model, self.mem_plan,
                    self.model.gctx_units(gctx, True)))
        if cfg.verbose and (cfg.mem_plan != "keep" or budget):
            print(f"# {self.mem_plan.summary()}")
        # the ledger's predictions, made once before the first epoch and
        # paired every epoch in _obs_epoch under one content key
        led = get_ledger()
        if led.attached:
            self._calib_key = content_key(rows=self.mem_estimate.rows,
                                          edges=self.mem_estimate.edges)
            led.predict("step_time", self._calib_key,
                        self.mem_estimate.base_step_s, "s")
            led.predict("peak_memory", self._calib_key,
                        self.mem_plan.predicted_peak_bytes, "bytes")

    def _loss_fn(self):
        """``model.loss`` under the memory plan (the model's own loss when
        the plan keeps everything)."""
        from roc_tpu_torch.memory import policy
        return policy.loss_fn(self.model, getattr(self, "mem_plan", None),
                              offload_to_host=self.config.stream)

    def _peak_hbm(self):
        """(bytes, source) of this epoch's peak device memory: measured on
        the card, the plan's prediction elsewhere."""
        from roc_tpu_torch import memory
        measured = memory.measured_peak_bytes(self.device)
        if measured is not None:
            return measured, "measured"
        plan = getattr(self, "mem_plan", None)
        if plan is not None:
            return plan.predicted_peak_bytes, "estimated"
        return 0, ""

    # -- observability ----------------------------------------------------
    def _obs_init(self):
        """Arm the obs layer before _setup (driver.py:534-577)."""
        cfg = self.config
        self._metrics = None
        self.watchdog = None
        if not cfg.obs:
            return
        obs.enable(True)
        jsonl = os.path.join(cfg.obs_dir, "metrics.jsonl") \
            if cfg.obs_dir else ""
        if jsonl:
            try:
                os.makedirs(cfg.obs_dir, exist_ok=True)
            except OSError:
                jsonl = ""  # keep the in-memory registry; skip the file
        self._metrics = obs.MetricsRegistry(jsonl_path=jsonl)
        # retry and injection events and the calibration ledger's records
        # land in the same stream (detached in _obs_finish)
        inject.attach(self._metrics.emit)
        get_ledger().attach(self._metrics.emit)
        # the per-epoch roofline standings, stamped only where the peaks
        # describe the device: the card's, never the CPU's
        g = self.dataset.graph
        self._roofline_fb = roofline.model_flops_bytes(
            self.model, g.num_nodes, g.num_edges,
            precision=cfg.aggregate_precision)
        self._roofline_on = self.device.type == "cuda"
        # what roc_tpu's single-device step reports: no wire, and the sum
        # of the in-degrees (the edge count) as the one shard's edges
        self._obs_edges = [int(g.num_edges)]
        self.watchdog = obs.PerfWatchdog()

    def _obs_epoch(self, epoch: int, wall_s: float, loss, print_fn):
        """The per-epoch record, read after the timed window
        (driver.py:579-607), and the watchdog's verdict on the epoch."""
        if self._metrics is None:
            return
        with obs.span("metrics_fetch"):
            loss_v, gnorm, pnorm = torch.stack(
                [loss.to(torch.float32), self._last_gnorm,
                 global_norm(self.params)]).tolist()
        extra = self._obs_epoch_extra(epoch) or {}
        wire = int(extra.pop("wire_bytes", extra.get("stream_bytes", 0)))
        if self._roofline_on:
            flops, nbytes = self._roofline_fb
            m = roofline.mfu(flops, wall_s)
            if m is not None:
                extra["mfu"] = round(m, 4)
                extra["roofline_frac"] = round(roofline.roofline_frac(
                    flops, nbytes, wall_s), 4)
        self._metrics.emit(
            "metrics", epoch=int(epoch), wall_s=round(float(wall_s), 6),
            loss=loss_v, grad_norm=gnorm, param_norm=pnorm,
            wire_bytes=wire, edges_per_shard=self._obs_edges, **extra)
        led = get_ledger()
        key = getattr(self, "_calib_key", None)
        if led.attached and key is not None:
            led.measure("step_time", key, wall_s, "s", epoch=int(epoch))
            wk = getattr(self, "_wire_key", None)
            if wk is not None and wire:
                led.measure("wire_bytes", wk, wire, "bytes",
                            epoch=int(epoch))
            hbm, src = self._peak_hbm()
            if src == "measured":
                led.measure("peak_memory", key, hbm, "bytes",
                            epoch=int(epoch))
        alert = self.watchdog.observe_epoch(epoch, wall_s)
        if alert is not None:
            self._metrics.emit("watchdog", **alert)
            if self.config.verbose:
                print_fn(f"# watchdog: epoch {epoch} took "
                         f"{alert['ratio']:.2f}x the EWMA "
                         f"({alert['wall_s'] * 1e3:.1f} ms vs "
                         f"{alert['ewma_s'] * 1e3:.1f} ms)")
        # the stream executor's stall feeds (driver.py:638-659)
        for field, feed, what in (
                ("stream_stall_frac", self.watchdog.observe_stream,
                 "stream"),
                ("stream_spill_stall_frac", self.watchdog.observe_spill,
                 "spill")):
            if field not in extra:
                continue
            alert = feed(epoch, extra[field])
            if alert is not None:
                self._metrics.emit("watchdog", **alert)
                if self.config.verbose:
                    print_fn(f"# watchdog: epoch {epoch} {what} stall "
                             f"fraction {alert['stall_frac']:.3f} is "
                             f"{alert['ratio']:.2f}x its EWMA "
                             f"({alert['ewma']:.3f})")
        # calibration drift: this epoch's joined pairs feed the per-model
        # EWMAs; off the card only the structurally exact models are
        # judged (a CPU's step time says nothing of the card's constants)
        for mname, ratio in led.drain_ratios():
            if not self._roofline_on and mname not in _EXACT_MODELS:
                continue
            alert = self.watchdog.observe_calibration(mname, ratio, epoch)
            if alert is not None:
                self._metrics.emit("watchdog", **alert)
                if self.config.verbose:
                    print_fn(f"# watchdog: cost model {mname} ratio EWMA "
                             f"{alert['ewma_ratio']:.3g} left the band "
                             f"[{alert['band_lo']:.2g}, "
                             f"{alert['band_hi']:.2g}]")

    def _obs_epoch_extra(self, epoch):
        """Executor-specific fields of the epoch's record (the stream
        executor's stall, overlap and bytes)."""
        del epoch
        return None

    def _obs_finish(self, stats: "TrainStats", print_fn):
        """The closing ``train`` record and the artifacts under obs_dir."""
        if self._metrics is None:
            return
        cfg = self.config
        # the ledger outlives the run (one a process): stop routing its
        # records into this run's stream
        get_ledger().detach()
        inject.detach()
        verdict = self.watchdog.verdict()
        self._metrics.emit(
            "train", epochs=stats.epochs, total_s=round(stats.total_s, 6),
            final_loss=stats.final_loss, watchdog_verdict=verdict,
            watchdog_alerts=len(self.watchdog.alerts))
        if cfg.obs_dir:
            trace_path = os.path.join(cfg.obs_dir, "trace.json")
            ok = obs.get_tracer().write_chrome_trace(trace_path)
            self._metrics.write_prometheus(
                os.path.join(cfg.obs_dir, "metrics.prom"))
            if cfg.verbose and ok:
                print_fn(f"# obs: trace -> {trace_path} "
                         f"({len(obs.get_tracer().span_types())} span "
                         f"types); watchdog verdict: {verdict}")

    # -- one step ---------------------------------------------------------
    def _train_step(self, key: prng.Key, alpha: float, scale: float):
        params = {k: p.detach().requires_grad_(True)
                  for k, p in self.params.items()}
        with obs.span("forward"):
            loss = self._loss(params, self.x, self.labels, self.mask,
                              self.gctx, key=key, train=True)
        # 1.0 on every healthy step, which adds no multiply (nor its
        # launch); NaN when the fault harness fires step.nan, which the
        # guard skips
        if scale != 1.0:
            loss = loss * scale
        keys = sorted(params)
        with obs.span("backward"):
            grads = dict(zip(keys, torch.autograd.grad(
                loss, [params[k] for k in keys])))
        loss = loss.detach()
        with obs.span("update"):
            (self.params, self.opt_state, self._last_nonfinite,
             self._last_gnorm) = guarded_update(
                self.optimizer, self.params, grads, self.opt_state, alpha,
                loss=loss)
        return loss

    def run_epoch(self) -> torch.Tensor:
        """One train step; returns its loss (a device scalar, not
        synced).  The step is the ``train_step`` span (its launches, not
        the device's work)."""
        cfg = self.config
        if self.epoch != 0 and self.epoch % cfg.decay_steps == 0:
            self.optimizer.alpha *= cfg.decay_rate  # gnn.cc:100-101
        with obs.span("train_step"):
            loss = self._train_step(prng.fold_in(self.key, self.epoch),
                                    self.optimizer.alpha, nan_scale())
        self.epoch += 1
        return loss

    # -- the non-finite guard's host side (driver.py:848-903) -------------
    def _check_nonfinite(self, epoch: int, print_fn) -> None:
        """Read the step's skip flag (the epoch's sync has landed, so the
        read costs no stall), track the streak of skipped steps, and walk
        the escalation ladder when the guard alone stops recovering."""
        if self._last_nonfinite is None:
            return
        if not bool(self._last_nonfinite):
            self._nf_streak = 0
            return
        self._nf_streak += 1
        self.nonfinite_skips += 1
        if self.watchdog is not None:
            alert = self.watchdog.observe_nonfinite(epoch, self._nf_streak)
            self._metrics.emit("watchdog", **alert)
        if self.config.verbose:
            print_fn(f"# fault: non-finite loss/grads at epoch {epoch}; "
                     f"update skipped (streak {self._nf_streak})")
        if self._nf_streak >= NONFINITE_ESCALATE_AFTER:
            self._escalate_nonfinite(epoch, print_fn)
            self._nf_streak = 0

    def _escalate_nonfinite(self, epoch: int, print_fn) -> None:
        """Rung 1: a -megafuse run drops to the unfused program, rebuilding
        the graph context with params, Adam state and epoch kept.  Rung 2:
        restore the last checkpoint, or carry on with skipped updates."""
        cfg = self.config
        if self._nf_stage == 0 and cfg.megafuse:
            self._nf_stage = 1
            inject.emit_event("nonfinite_escalation", stage="unfuse",
                              epoch=int(epoch), streak=self._nf_streak)
            print_fn(f"# fault: {self._nf_streak} consecutive non-finite "
                     f"steps — disabling -megafuse (two-pass fallback) and "
                     f"rebuilding the train step")
            cfg.megafuse = False
            keep = self.params, self.opt_state, self.epoch
            self._setup()
            self.params, self.opt_state, self.epoch = keep
            return
        self._nf_stage = 2
        path = cfg.checkpoint_path
        if path and os.path.exists(path):
            inject.emit_event("nonfinite_escalation", stage="restore",
                              epoch=int(epoch), streak=self._nf_streak)
            print_fn(f"# fault: non-finite streak persists — restoring "
                     f"from checkpoint {path}")
            self.restore(path)
        else:
            inject.emit_event("nonfinite_escalation", stage="no_checkpoint",
                              epoch=int(epoch), streak=self._nf_streak)
            print_fn("# fault: non-finite streak persists and no "
                     "checkpoint is available; continuing with skipped "
                     "updates")

    # -- inference --------------------------------------------------------
    def predict_logits(self) -> torch.Tensor:
        """Inference logits [N, C] for every node, on the device."""
        with torch.no_grad():
            return self.model.apply(self.params, self.x, self.gctx,
                                    train=False)

    def evaluate(self) -> PerfMetrics:
        with torch.no_grad():
            return perf_metrics(self.predict_logits(), self.labels,
                                self.mask)

    # -- the loop ---------------------------------------------------------
    def _install_stop_handlers(self) -> dict:
        """SIGTERM/SIGINT set a flag the loop reads at the epoch's end;
        returns the previous handlers (none off the main thread, where
        Python cannot install any)."""
        self._stop_signal = None
        if threading.current_thread() is not threading.main_thread():
            return {}

        def _on_stop(signum, frame):
            del frame
            self._stop_signal = signum

        installed = {}
        for s in (signal.SIGTERM, signal.SIGINT):
            installed[s] = signal.signal(s, _on_stop)
        return installed

    def _start_profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profiler(self, prof) -> str:
        """Close the profiler session and write its Chrome trace."""
        device_sync(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(self.config.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        return path

    def train(self, print_fn=print) -> TrainStats:
        cfg, dev = self.config, self.device
        on_cuda = dev.type == "cuda"
        self.epoch_times = []
        peaks = []
        peak_src = ""
        rebalance_events = []
        loss: Optional[torch.Tensor] = None
        start = self.epoch
        # the profiler window, clamped into the run (driver.py:928-931)
        p_off, p_cnt = cfg.profile_window()
        prof_start = start + min(p_off, max(cfg.num_epochs - 1, 0))
        prof_stop = min(prof_start + p_cnt, start + cfg.num_epochs)
        prof = None
        installed = self._install_stop_handlers()
        with obs.span("train", epochs=cfg.num_epochs) as sp_train:
            try:
                for epoch in range(start, start + cfg.num_epochs):
                    if cfg.profile_dir and epoch == prof_start:
                        prof = self._start_profiler()
                    if on_cuda:
                        torch.cuda.reset_peak_memory_stats(dev)
                    # the sync is the measurement: an epoch ends when its
                    # work on the device does, not when its launches return
                    with obs.span("epoch", epoch=epoch) as sp_epoch:
                        with obs.span("step_dispatch"):
                            loss = self.run_epoch()
                        with obs.span("device_sync"):
                            device_sync(dev)
                    self.epoch_times.append(sp_epoch.dur_s)
                    hbm, peak_src = self._peak_hbm()
                    peaks.append(hbm)
                    if self.balancer is not None:
                        self.balancer.telemetry.record_epoch(
                            epoch, self.epoch_times[-1], peak_hbm=hbm,
                            peak_hbm_source=peak_src)
                    self._obs_epoch(epoch, sp_epoch.dur_s, loss, print_fn)
                    self._check_nonfinite(epoch, print_fn)
                    if prof is not None and epoch + 1 == prof_stop:
                        path = self._stop_profiler(prof)
                        prof = None
                        print_fn(f"# profiler trace written to {path}")
                    if epoch % cfg.eval_every == 0:
                        with obs.span("eval", epoch=epoch):
                            print_fn(format_metrics(epoch, self.evaluate()))
                    if (cfg.checkpoint_path and cfg.checkpoint_every and
                            (epoch + 1) % cfg.checkpoint_every == 0):
                        with obs.span("checkpoint", epoch=epoch):
                            self.save_checkpoint(cfg.checkpoint_path)
                    # a balance round at the epoch boundary, never after
                    # the last epoch (nothing left to speed up)
                    done = epoch + 1 - start
                    if (self.balancer is not None and done < cfg.num_epochs
                            and done % cfg.balance_every == 0):
                        ev = self.balancer.step(self, epoch + 1,
                                                cfg.num_epochs - done)
                        if ev is not None:
                            rebalance_events.append(ev)
                            if cfg.verbose:
                                print_fn(f"# balance@{epoch + 1}: "
                                         f"{ev['action']} (pred gain "
                                         f"{ev['rel_gain'] * 100:.1f}%, "
                                         f"r2 {ev['r2']:.3f})")
                    if self._stop_signal is not None:
                        name = signal.Signals(self._stop_signal).name
                        print_fn(f"# fault: {name} received — epoch "
                                 f"{epoch} finished; checkpointing and "
                                 f"exiting cleanly")
                        break
            finally:
                # a failure inside the window still closes the session
                if prof is not None:
                    prof.__exit__(None, None, None)
                for s, h in installed.items():
                    signal.signal(s, h)
            device_sync(dev)
        dt = sp_train.dur_s
        if cfg.checkpoint_path:
            with obs.span("checkpoint"):
                self.save_checkpoint(cfg.checkpoint_path)
        if cfg.verbose and self.epoch_times:
            steady = sorted(self.epoch_times[2:] or self.epoch_times)
            med = steady[len(steady) // 2]
            print_fn(f"# {cfg.num_epochs} epochs in {dt:.2f}s "
                     f"(median {med * 1e3:.1f} ms/epoch post-warmup, "
                     f"{self.dataset.graph.num_edges / med / 1e6:.1f}M "
                     f"edges/s)")
        stats = TrainStats(
            epoch_times=list(self.epoch_times), total_s=dt,
            epochs=cfg.num_epochs,
            final_loss=float("nan") if loss is None else float(loss),
            peak_hbm_bytes=peaks, peak_hbm_source=peak_src,
            rebalance_events=rebalance_events)
        self._obs_finish(stats, print_fn)
        return stats

    # -- checkpoint / resume (the JAX package's npz layout) ---------------
    def _resume_extra(self) -> dict:
        """The host state a resume needs beyond the arrays
        (driver.py:1040-1056): the base PRNG key, the skip count and the
        watchdog's EWMA."""
        extra = {"rng_key": [int(self.key[0]), int(self.key[1])],
                 "nonfinite_skips": int(self.nonfinite_skips)}
        if self.watchdog is not None:
            extra["watchdog"] = self.watchdog.state_dict()
        return extra

    def save_checkpoint(self, path: str) -> None:
        """Process 0 writes (every process holds the same params); under
        -multihost every process then waits for the file at a barrier."""
        if self.comm is None or self.comm.rank == 0:
            checkpoint.save(path, self.params, self.opt_state, self.epoch,
                            self.optimizer.alpha,
                            extra=self._resume_extra())
        if self.comm is not None:
            from roc_tpu_torch.parallel import collectives
            collectives.barrier()

    def restore(self, path: str) -> None:
        """Params, Adam state, epoch, learning rate, PRNG key, skip count
        and watchdog state from a checkpoint written by either package."""
        (self.params, self.opt_state, self.epoch, self.optimizer.alpha,
         extra) = checkpoint.load(path, self.params, self.opt_state)
        if "rng_key" in extra:
            k0, k1 = (int(v) for v in extra["rng_key"])
            self.key = (k0, k1)
        if self.watchdog is not None and "watchdog" in extra:
            self.watchdog.load_state(extra["watchdog"])
        self.nonfinite_skips = int(extra.get("nonfinite_skips", 0))
        self._restore_extra(extra)

    def _restore_extra(self, extra: dict) -> None:
        """Trainer-specific state of a checkpoint's ``extra`` record (the
        SPMD trainer's cut)."""
        del extra


def _fmt_bytes(b: int) -> str:
    return f"{b / 2**20:.0f} MiB" if b >= 2**20 else f"{b / 2**10:.0f} KiB"


def make_trainer(config: Config, dataset: Dataset, model: Model) -> Trainer:
    """The one place that builds a trainer (driver.py:1170-1196): the
    streaming executor under -stream; otherwise the -stream-budget gate,
    then the SPMD trainer for -parts > 1 (its parts on the run's device,
    k = -parts), else the single-device trainer.  A graph stub (-perhost
    loading) trains only through the SPMD trainer's -perhost path or the
    streaming executor, both of which read the .lux byte ranges."""
    from roc_tpu_torch.graph.datasets import GraphStub
    stub = isinstance(dataset.graph, GraphStub)
    if stub and not (config.num_parts > 1
                     and (config.perhost_load or config.stream)):
        raise SystemExit(
            "error: a graph stub (load_roc_dataset(graph_stub=True)) holds "
            "no topology: only -perhost or -stream with -parts > 1 reads "
            "the parts from the .lux byte ranges")
    if config.stream:
        from roc_tpu_torch.stream.executor import StreamTrainer
        return StreamTrainer(config, dataset, model)
    budget = config.stream_budget_bytes()
    if budget:
        from roc_tpu_torch.stream import incore_resident_bytes
        need = incore_resident_bytes(dataset)
        if need > budget:
            raise SystemExit(
                f"error: graph needs ~{_fmt_bytes(need)} device-resident "
                f"but -stream-budget is {_fmt_bytes(budget)}; rerun "
                f"with -stream to rotate shards through host memory "
                f"(add -stream-spill DIR when even host memory cannot "
                f"hold the boundary stores, and -bf16-storage to halve "
                f"the streamed bytes)")
    if config.num_parts > 1:
        from roc_tpu_torch.parallel.spmd import SpmdTrainer
        return SpmdTrainer(config, dataset, model)
    return Trainer(config, dataset, model)
