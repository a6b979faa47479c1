"""Adam with the reference's exact update (roc_tpu/optim/adam.py;
optimizer_kernel.cu:44-63, optimizer.cc:79-85):

    gt = g + weight_decay * W            (L2 folded into the gradient, not
                                          decoupled AdamW)
    mt = beta1 * M + (1 - beta1) * gt
    vt = beta2 * V + (1 - beta2) * gt * gt
    W -= alpha_t * mt / (sqrt(vt) + epsilon)

with the bias correction folded into the step size once per step:
``alpha_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t)``.  LR decay changes
``alpha`` in the driver.  ``torch.optim.Adam`` computes another function
(it corrects m and v separately and adds epsilon after the correction), so
the update is written out as tensor ops, in the JAX package's order of
operations, and returns new tensors: the non-finite guard selects between
the old and the new state.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    """Field order m, v, t: the checkpoint's ``o_leaf_*`` order follows
    it, as it follows the JAX package's AdamState."""
    m: Params
    v: Params
    t: torch.Tensor   # int32 scalar: the number of steps taken


class Adam:
    def __init__(self, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8):
        self.alpha = alpha  # changed by the driver's LR decay
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon

    def init(self, params: Params) -> AdamState:
        some = next(iter(params.values()))
        return AdamState(m={k: torch.zeros_like(p) for k, p in params.items()},
                         v={k: torch.zeros_like(p) for k, p in params.items()},
                         t=torch.zeros((), dtype=torch.int32,
                                       device=some.device))

    @torch.no_grad()
    def update(self, params: Params, grads: Params, state: AdamState,
               alpha: float):
        """One step; returns ``(new_params, new_state)``.  ``alpha`` is the
        (decayed) base learning rate."""
        t = state.t + 1
        tf = t.to(torch.float32)
        alpha_t = (alpha * torch.sqrt(1.0 - self.beta2 ** tf)
                   / (1.0 - self.beta1 ** tf))
        b1, b2 = self.beta1, self.beta2
        wd, eps = self.weight_decay, self.epsilon
        new_p, new_m, new_v = {}, {}, {}
        for k, w in params.items():
            gt = grads[k] + wd * w
            m = b1 * state.m[k] + (1.0 - b1) * gt
            v = b2 * state.v[k] + (1.0 - b2) * gt * gt
            new_p[k] = w - alpha_t * m / (torch.sqrt(v) + eps)
            new_m[k], new_v[k] = m, v
        return new_p, AdamState(new_m, new_v, t)
