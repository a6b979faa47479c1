"""The JAX package's runtime kill switches, read at the port's dispatch
sites (roc_tpu/ops/pallas/binned.py:2472-2490, 2556-2575, 2846-2865;
roc_tpu/ops/pallas/gat.py:95-122).  Each is a user's setting, checked where
its path is chosen and warned once a process with roc_tpu's text; with no
variable set every kernel runs as it would without this module.

  ROC_NO_MEGAFUSE=1  ``models.model.mega_matches`` and ``mega_regions``
                     find nothing: each layer runs ``aggregate_sum`` and
                     ``ops/linear.py``
  ROC_MEGA_BWD=0     the megakernel's autograd Function replays the
                     composed backward (``ops/aggregate.py``); as in
                     roc_tpu, whose region kernels need the fused backward,
                     ``mega_regions`` finds nothing either
  ROC_XLAYER=0       ``mega_regions`` finds nothing: the per-layer
                     megakernels run
  ROC_NO_GATFUSE=1   ``ops.edge.gat_attend_kernel`` runs the plain
                     attention (``ops.edge.gat_attend``)
  ROC_GAT_BWD=0      the GAT Function's backward runs the kernels' plain
                     twins (``gat_bwd_src_dq_plain``, ``gat_dadl_plain``)
"""

from __future__ import annotations

import os
import warnings

_MEGA_KILL_WARNED = [False]
_MEGA_BWD_KILL_WARNED = [False]
_XLAYER_KILL_WARNED = [False]
_GAT_KILL_WARNED = [False]
_GAT_BWD_KILL_WARNED = [False]


def _warn_once(flag: list, msg: str) -> None:
    if not flag[0]:
        flag[0] = True
        warnings.warn(msg, stacklevel=3)


def megafuse_killed() -> bool:
    """True when ROC_NO_MEGAFUSE=1 disables aggregate->linear megakernel
    fusion at runtime (checked at every dispatch site; warn-once)."""
    if not os.environ.get("ROC_NO_MEGAFUSE"):
        return False
    _warn_once(_MEGA_KILL_WARNED,
               "ROC_NO_MEGAFUSE=1: aggregate->linear megakernel fusion "
               "disabled; eligible layers run the two-pass aggregation plus "
               "the XLA linear instead.")
    return True


def mega_bwd_killed() -> bool:
    """True when ROC_MEGA_BWD=0 disables the fused megakernel backward at
    runtime (checked at every VJP dispatch; warn-once)."""
    if os.environ.get("ROC_MEGA_BWD", "") != "0":
        return False
    _warn_once(_MEGA_BWD_KILL_WARNED,
               "ROC_MEGA_BWD=0: fused megakernel backward disabled; "
               "eligible layers' gradients replay the two-pass "
               "aggregate+linear composition instead.")
    return True


def xlayer_killed() -> bool:
    """True when ROC_XLAYER=0 disables cross-layer fusion-region kernels
    at runtime (checked at every region dispatch; warn-once).  Per-layer
    megakernel fusion is unaffected."""
    if os.environ.get("ROC_XLAYER", "") != "0":
        return False
    _warn_once(_XLAYER_KILL_WARNED,
               "ROC_XLAYER=0: cross-layer fusion regions disabled; eligible "
               "regions run the per-layer megakernel chain instead.")
    return True


def gat_fuse_killed() -> bool:
    """True when ROC_NO_GATFUSE=1 disables fused GAT attention at
    runtime (checked at every dispatch site; warn-once)."""
    if not os.environ.get("ROC_NO_GATFUSE"):
        return False
    _warn_once(_GAT_KILL_WARNED,
               "ROC_NO_GATFUSE=1: fused GAT attention disabled; eligible "
               "layers run the unfused plan composition instead.")
    return True


def gat_bwd_killed() -> bool:
    """True when ROC_GAT_BWD=0 disables only the fused GAT backward
    grids (forward fusion unaffected; warn-once)."""
    if os.environ.get("ROC_GAT_BWD", "") != "0":
        return False
    _warn_once(_GAT_BWD_KILL_WARNED,
               "ROC_GAT_BWD=0: fused GAT backward disabled; gradients "
               "recompute the oracle VJP from the saved max plane instead.")
    return True
