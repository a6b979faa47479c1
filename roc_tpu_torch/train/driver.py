"""Training driver (roc_tpu/train/driver.py): the single-device trainer.

Per epoch, as the reference's loop (gnn.cc:99-111) and the JAX driver
(driver.py:913-1040):
  * every ``decay_steps`` epochs (not epoch 0) the learning rate is
    multiplied by ``decay_rate``;
  * one train step: forward, backward (autograd; every aggregation,
    megakernel and attention layer has its own backward kernels) and the
    guarded Adam update;
  * the epoch ends with a device sync, and ``epoch_times`` are the synced
    times;
  * every ``eval_every`` epochs an inference forward prints the reference's
    metric line.

The parameters and the dropout masks are roc_tpu's bits (ops/prng.py):
the run's key is ``PRNGKey(seed)``, the Glorot init draws from it, and
epoch e's masks from ``fold_in(key, e)`` (driver.py:917), on any device.
So the port starts and steps as the JAX package does, and a resumed run
draws the masks the unbroken run would have.

Not ported yet (ROADMAP queue A): obs spans and metrics, the profiler
window, the online balancer, signal handling, the memory planner, the
non-finite escalation ladder (skips are counted and reported), and the
SPMD and streaming trainers.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch

from roc_tpu_torch.device import resolve_device
from roc_tpu_torch.fault.guard import guarded_update
from roc_tpu_torch.graph.datasets import Dataset
from roc_tpu_torch.models.model import Model
from roc_tpu_torch.ops import prng
from roc_tpu_torch.ops.softmax import PerfMetrics, format_metrics, \
    perf_metrics
from roc_tpu_torch.optim.adam import Adam
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.graph_data import (dense_graph_data,
                                            effective_backend,
                                            host_to_device, make_gctx,
                                            model_has_gat)


@dataclasses.dataclass
class TrainStats:
    """What one ``train()`` call measured.  ``epoch_times`` are the synced
    per-epoch times and exclude eval and checkpointing; ``total_s``
    includes them.  ``peak_mem_bytes`` is each epoch's train-step peak of
    ``torch.cuda.max_memory_allocated`` (empty off CUDA)."""
    epoch_times: list
    total_s: float
    epochs: int
    final_loss: float
    peak_mem_bytes: list = dataclasses.field(default_factory=list)


def device_sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dropout_key(seed: int, epoch: int) -> prng.Key:
    """The key an epoch's dropout masks draw from."""
    return prng.fold_in(prng.prng_key(seed), epoch)


class Trainer:
    """Single-device full-graph trainer, on CUDA unless
    ``config.device`` asks for the CPU."""

    def __init__(self, config: Config, dataset: Dataset, model: Model):
        self.config = config
        self.dataset = dataset
        self.model = model
        self.device = resolve_device(config.device)
        self.optimizer = Adam(alpha=config.learning_rate,
                              weight_decay=config.weight_decay)
        self.epoch = 0
        self.epoch_times: list = []
        self.nonfinite_skips = 0
        self._last_nonfinite = None
        self._setup()
        if config.resume and config.checkpoint_path and \
                os.path.exists(config.checkpoint_path):
            self.restore(config.checkpoint_path)

    def _setup(self):
        cfg, ds, dev = self.config, self.dataset, self.device
        backend = effective_backend(cfg, self.model, dev)
        self.gdata = dense_graph_data(
            ds.graph, backend, cfg.aggregate_precision, dev,
            edge_map=backend == "kernel" and model_has_gat(self.model))
        self.gctx = make_gctx(self.gdata, cfg.megafuse, cfg.fusion_depth)
        self.x = host_to_device(ds.features, dev)
        self.labels = torch.as_tensor(ds.onehot_labels(),
                                      dtype=torch.float32, device=dev)
        self.mask = torch.as_tensor(ds.mask, dtype=torch.int32, device=dev)
        self.params = self.model.init_params(prng.prng_key(cfg.seed),
                                             device=dev)
        self.opt_state = self.optimizer.init(self.params)

    # -- one step ---------------------------------------------------------
    def _train_step(self, key: prng.Key, alpha: float):
        params = {k: p.detach().requires_grad_(True)
                  for k, p in self.params.items()}
        loss = self.model.loss(params, self.x, self.labels, self.mask,
                               self.gctx, key=key, train=True)
        keys = sorted(params)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [params[k] for k in keys])))
        loss = loss.detach()
        self.params, self.opt_state, self._last_nonfinite, _ = \
            guarded_update(self.optimizer, self.params, grads,
                           self.opt_state, alpha, loss=loss)
        return loss

    def run_epoch(self) -> torch.Tensor:
        """One train step; returns its loss (a device scalar, not
        synced)."""
        cfg = self.config
        if self.epoch != 0 and self.epoch % cfg.decay_steps == 0:
            self.optimizer.alpha *= cfg.decay_rate  # gnn.cc:100-101
        loss = self._train_step(dropout_key(cfg.seed, self.epoch),
                                self.optimizer.alpha)
        self.epoch += 1
        return loss

    def _check_nonfinite(self, epoch: int, print_fn) -> None:
        """Count a skipped step (the flag is already on the host side of
        the epoch's sync, so reading it costs no stall)."""
        if self._last_nonfinite is None or \
                not bool(self._last_nonfinite):
            return
        self.nonfinite_skips += 1
        if self.config.verbose:
            print_fn(f"# fault: non-finite loss/grads at epoch {epoch}; "
                     f"update skipped ({self.nonfinite_skips} so far)")

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
    def train(self, print_fn=print) -> TrainStats:
        cfg, dev = self.config, self.device
        on_cuda = dev.type == "cuda"
        self.epoch_times = []
        peaks = []
        loss: Optional[torch.Tensor] = None
        start = self.epoch
        t0 = time.perf_counter()
        for epoch in range(start, start + cfg.num_epochs):
            if on_cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            # the sync is the measurement: an epoch ends when its work
            # on the device does, not when its launches return
            e0 = time.perf_counter()
            loss = self.run_epoch()
            device_sync(dev)
            self.epoch_times.append(time.perf_counter() - e0)
            if on_cuda:
                peaks.append(torch.cuda.max_memory_allocated(dev))
            self._check_nonfinite(epoch, print_fn)
            if epoch % cfg.eval_every == 0:
                print_fn(format_metrics(epoch, self.evaluate()))
            if (cfg.checkpoint_path and cfg.checkpoint_every and
                    (epoch + 1) % cfg.checkpoint_every == 0):
                self.save_checkpoint(cfg.checkpoint_path)
        device_sync(dev)
        dt = time.perf_counter() - t0
        if cfg.checkpoint_path:
            self.save_checkpoint(cfg.checkpoint_path)
        if cfg.verbose and self.epoch_times:
            steady = sorted(self.epoch_times[2:] or self.epoch_times)
            med = steady[len(steady) // 2]
            print_fn(f"# {cfg.num_epochs} epochs in {dt:.2f}s "
                     f"(median {med * 1e3:.1f} ms/epoch post-warmup, "
                     f"{self.dataset.graph.num_edges / med / 1e6:.1f}M "
                     f"edges/s)")
        return TrainStats(
            epoch_times=list(self.epoch_times), total_s=dt,
            epochs=cfg.num_epochs,
            final_loss=float("nan") if loss is None else float(loss),
            peak_mem_bytes=peaks)

    # -- checkpoint / resume (the JAX package's npz layout) ---------------
    def save_checkpoint(self, path: str) -> None:
        checkpoint.save(path, self.params, self.opt_state, self.epoch,
                        self.optimizer.alpha,
                        extra={"nonfinite_skips": self.nonfinite_skips})

    def restore(self, path: str) -> None:
        """Params, Adam state, epoch and learning rate from a checkpoint
        written by either package."""
        (self.params, self.opt_state, self.epoch, self.optimizer.alpha,
         extra) = checkpoint.load(path, self.params, self.opt_state)
        self.nonfinite_skips = int(extra.get("nonfinite_skips", 0))


def make_trainer(config: Config, dataset: Dataset, model: Model) -> Trainer:
    """The one place that builds a trainer; the port has the
    single-device one so far."""
    return Trainer(config, dataset, model)
