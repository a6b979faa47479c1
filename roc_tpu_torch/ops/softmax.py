"""Masked softmax cross-entropy and the training metrics
(roc_tpu/ops/softmax.py, the reference's SoftmaxCrossEntropy op).

  * The loss is the *unreduced sum* of cross-entropy over MASK_TRAIN rows:
    its gradient is ``softmax(logits) - onehot`` on train rows and zero
    elsewhere, with no division by the train count (softmax_kernel.cu:
    19-33).
  * The reported ``train_loss`` is ``Σ_train (1 - p_true)``, a margin-style
    sum and not the CE above (softmax_kernel.cu:65).
  * Accuracy is the argmax of the probabilities against the one-hot label,
    tallied per TRAIN/VAL/TEST mask; NONE rows count nowhere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from roc_tpu_torch.graph.lux import MASK_TEST, MASK_TRAIN, MASK_VAL


class PerfMetrics(NamedTuple):
    """The reference's PerfMetrics struct (softmax_kernel.cu:35-40)."""
    train_loss: torch.Tensor   # Σ_train (1 - p_true)
    train_all: torch.Tensor
    train_correct: torch.Tensor
    val_all: torch.Tensor
    val_correct: torch.Tensor
    test_all: torch.Tensor
    test_correct: torch.Tensor


def masked_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Sum of CE over MASK_TRAIN rows.  logits [N, C]; labels [N, C]
    one-hot float; mask [N] int32."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.sum(labels * logp, dim=-1)
    train = (mask == MASK_TRAIN).to(logits.dtype)
    return torch.sum(ce * train)


def perf_metrics(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> PerfMetrics:
    """The reference's evaluation pass (calc_loss, softmax_kernel.cu:
    41-79)."""
    probs = torch.softmax(logits, dim=-1)
    p_true = torch.sum(probs * labels, dim=-1)
    correct = torch.argmax(probs, dim=-1) == torch.argmax(labels, dim=-1)

    def tally(m):
        sel = mask == m
        return torch.sum(sel), torch.sum(sel & correct)

    train_all, train_correct = tally(MASK_TRAIN)
    val_all, val_correct = tally(MASK_VAL)
    test_all, test_correct = tally(MASK_TEST)
    train_loss = torch.sum(torch.where(mask == MASK_TRAIN, 1.0 - p_true,
                                       torch.zeros_like(p_true)))
    return PerfMetrics(train_loss, train_all, train_correct,
                       val_all, val_correct, test_all, test_correct)


def format_metrics(epoch: int, m: PerfMetrics, infer: bool = True) -> str:
    """The reference's printed report line (softmax_kernel.cu:141-152)."""
    mode = "\t[INFER]" if infer else "[TRAIN]"

    def pct(c, a):
        return 100.0 * float(c) / max(float(a), 1.0)
    return (f"{mode}[{epoch}] train_loss: {float(m.train_loss):.4f}  "
            f"train_accuracy: {pct(m.train_correct, m.train_all):.2f}%"
            f"({int(m.train_correct)}/{int(m.train_all)})  "
            f"val_accuracy: {pct(m.val_correct, m.val_all):.2f}%"
            f"({int(m.val_correct)}/{int(m.val_all)})  "
            f"test_accuracy: {pct(m.test_correct, m.test_all):.2f}%"
            f"({int(m.test_correct)}/{int(m.test_all)})")
