"""Shard-consistency checker (roc_tpu/parallel/check.py).

What can go wrong when the parts split the graph is a plan bug: wrong halo
maps, a bad edge remap, pad rows leaking into live math.  This checker
makes that class of bug observable on demand: it evaluates the same model
with the same parameters on the single-device trainer and on the sharded
one, and requires the metrics to agree (distribution is unobservable up
to float reassociation).

A library call (``check_shard_consistency``) or the CLI's
``-check-sharding``, which runs it before training.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def check_shard_consistency(config, dataset, model, rtol: float = 1e-3,
                            sharded_trainer=None, count_tol: int = 1):
    """Compare sharded and single-device evaluation of ``model`` at init.

    Pass an existing ``sharded_trainer`` to reuse its partition, halo maps
    and CSRs (the CLI does).  The single-device side holds the whole graph
    on one device: run the check where it fits.

    ``count_tol``: the allowed absolute difference of each correct-count
    metric.  The two paths' logits differ by float reassociation, so a
    near-tie argmax can flip a node's prediction; 1 tolerates that without
    masking plan bugs (which flip many).  0 for bit-exact workloads.

    Returns the pair of PerfMetrics (single, sharded); raises
    AssertionError with a field-by-field report on mismatch.
    """
    from roc_tpu_torch.parallel.spmd import SpmdTrainer
    from roc_tpu_torch.train.driver import Trainer

    cfg1 = dataclasses.replace(config, num_parts=1)
    m1 = Trainer(cfg1, dataset, model).evaluate()
    if sharded_trainer is None:
        sharded_trainer = SpmdTrainer(config, dataset, model)
    mp = sharded_trainer.evaluate()

    errors = []
    for field in m1._fields:
        a, b = float(getattr(m1, field)), float(getattr(mp, field))
        # loss up to reassociation; counts up to count_tol argmax flips
        tol = rtol * max(abs(a), 1.0) if field == "train_loss" \
            else float(count_tol)
        if abs(a - b) > tol:
            errors.append(f"  {field}: single={a} sharded={b}")
    if errors:
        raise AssertionError(
            "shard-consistency check FAILED (plan/halo/padding bug):\n"
            + "\n".join(errors))
    return m1, mp


def predict_classes(trainer) -> np.ndarray:
    """Per-node predicted class ids in the original vertex order, from
    either trainer (sharded logits are unpadded)."""
    ids = trainer.predict_logits().argmax(dim=-1).cpu().numpy()
    part = getattr(trainer, "part", None)
    if part is not None:
        ids = part.unpad_nodes(ids)
    return ids
