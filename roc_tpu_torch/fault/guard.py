"""The non-finite step guard (roc_tpu/fault/guard.py).

A NaN or Inf loss or gradient must not poison the parameters, and finding
it on the host would cost a device-to-host sync every step.  So the update
is computed unconditionally and ``torch.where`` selects between the new and
the old params and optimizer state on one finiteness flag that stays on the
device.  The JAX package's NaN injection into a step (``nan_scale``) is
not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over every tensor of a dict (fp32 accumulation), as
    roc_tpu/obs/channel.py:global_norm."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros(())
    total = sum(torch.sum(torch.square(t.to(torch.float32))) for t in leaves)
    return torch.sqrt(total)


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
