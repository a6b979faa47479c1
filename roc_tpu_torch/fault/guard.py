"""The non-finite step guard (roc_tpu/fault/guard.py).

A NaN or Inf loss or gradient must not poison the parameters, and finding
it on the host would cost a device-to-host sync every step.  So the update
is computed unconditionally and ``torch.where`` selects between the new and
the old params and optimizer state on one finiteness flag that stays on the
device.  ``nan_scale`` is the host side of the ``step.nan`` injection site:
the step multiplies its loss by it before the backward.
"""

from __future__ import annotations

import torch

from roc_tpu_torch.obs.channel import global_norm


def guarded_update(optimizer, params, grads, opt_state, alpha, loss=None):
    """Apply ``optimizer.update`` only if loss and grads are finite.

    Returns ``(params, opt_state, nonfinite, grad_norm)``; ``nonfinite`` is
    a bool tensor on the device (True: the step was skipped, and the params
    and the whole Adam state, m, v and t, kept their old values).
    ``grad_norm`` is the fp32 global grad norm."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        finite = torch.isfinite(gnorm)
        if loss is not None:
            finite = finite & torch.isfinite(loss)
        new_params, new_opt = optimizer.update(params, grads, opt_state,
                                               alpha)

        def sel(new, old):
            return {k: torch.where(finite, new[k], old[k]) for k in new}

        out_opt = type(opt_state)(sel(new_opt.m, opt_state.m),
                                  sel(new_opt.v, opt_state.v),
                                  torch.where(finite, new_opt.t, opt_state.t))
        return sel(new_params, params), out_opt, ~finite, gnorm


def nan_scale(site: str = "step.nan") -> float:
    """The loss scale of this step: 1.0, or NaN when the fault harness
    fires ``site`` (roc_tpu/fault/guard.py:50-59).  A Python float, so an
    unarmed step does no host tensor work for it, and the step skips the
    multiply at 1.0: an unarmed run keeps its bits and its launches."""
    from roc_tpu_torch.fault import inject
    return float("nan") if inject.point(site) else 1.0
