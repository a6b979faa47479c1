"""The plain reference: fp32 PyTorch with TF32 off, in the precision each
configuration states, importing nothing of the program.  It takes the inputs the benchmark made (the CSR, features,
labels, split and initial weights) and works out everything else again:
the transpose, the in-degree norms, the dropout masks, the patched graph.

``train_steps`` follows roc_tpu's training step (the masked softmax
cross-entropy summed over train rows, reverse mode, Adam with L2 folded
into the gradient and the bias correction folded into the step size);
``logits`` is the eval forward.  Each configuration names its model
module under ``reference`` (``perfbench/reference/<reference>.py``): its
``forward``, its ``leaves`` (what :mod:`perfbench.inputs` draws) and its
``counts`` (what :mod:`perfbench.counts` reckons a step)."""

from __future__ import annotations

import importlib
import math
from typing import Dict, List

import torch

from perfbench.inputs import MASK_TRAIN
from perfbench.reference import prng

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def set_fp32(tf32: bool = False):
    """Float32 GEMMs with TF32 off; ``tf32`` turns it on (a control's
    step below)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def model_module(cfg):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def graph_for(cfg, row_ptr, col_idx, train: bool):
    """The structure the configuration's model reads."""
    from perfbench.reference.graph import Graph
    return Graph(row_ptr, col_idx, transpose=train)


def ce_loss(logits, label_ids, mask) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(1, label_ids[:, None]).squeeze(1)
    return -(picked * (mask == MASK_TRAIN).to(logits.dtype)).sum()


def adam(params, grads, m, v, t: int, alpha: float, wd: float):
    """One step of roc_tpu's Adam; returns (params, m, v, gt)."""
    a_t = alpha * math.sqrt(1.0 - BETA2 ** t) / (1.0 - BETA1 ** t)
    out_p, out_m, out_v, out_g = {}, {}, {}, {}
    for k, w in params.items():
        gt = grads[k] + wd * w
        mk = BETA1 * m[k] + (1.0 - BETA1) * gt
        vk = BETA2 * v[k] + (1.0 - BETA2) * gt * gt
        out_p[k] = w - a_t * mk / (torch.sqrt(vk) + EPS)
        out_m[k], out_v[k], out_g[k] = mk, vk, gt
    return out_p, out_m, out_v, out_g


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def train_steps(cfg, inp, steps: int, seed: int,
                loss_scale: float = 1.0, tf32: bool = False) -> dict:
    """``steps`` training steps from the initial weights: each step's
    loss, each leaf's norm of the first step's gradient as Adam takes it
    (with L2 folded in), and each leaf's norm of the change after
    ``steps``.  ``loss_scale`` multiplies each step's loss (a planted
    fault's); ``tf32`` computes the GEMMs in TF32 (the control's)."""
    set_fp32(tf32)
    mod = model_module(cfg)
    graph = graph_for(cfg, inp.row_ptr, inp.col_idx, train=True)
    w0 = {k: v.detach().clone() for k, v in inp.weights.items()}
    params = {k: v.clone() for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    base = prng.key(seed)
    losses: List[float] = []
    grad1 = None
    for step in range(steps):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        logits = mod.forward(leaves, inp.features, graph, cfg,
                             key=prng.fold_in(base, step))
        loss = ce_loss(logits, inp.label_ids, inp.mask) * loss_scale
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        del logits, loss, leaves
        with torch.no_grad():
            params, m, v, gt = adam(params, grads, m, v, step + 1,
                                    float(cfg["learning_rate"]),
                                    float(cfg["weight_decay"]))
        if grad1 is None:
            grad1 = norms(gt)
    change = norms({k: params[k] - w0[k] for k in params})
    return {"losses": losses, "grad1": grad1, "change": change}


def logits(cfg, params, inp, graph=None, tf32: bool = False):
    """The eval forward over ``graph`` (the input CSR when None);
    ``tf32`` as in :func:`train_steps`."""
    set_fp32(tf32)
    mod = model_module(cfg)
    if graph is None:
        graph = graph_for(cfg, inp.row_ptr, inp.col_idx, train=False)
    with torch.no_grad():
        return mod.forward(params, inp.features, graph, cfg)
