"""The activation-memory planner (roc_tpu/memory, ROC's memory manager).

  estimator.py  per-layer activation bytes (roc_tpu's accounting) and
                recompute seconds priced for the card, and the port's own
                device residents beside them
  planner.py    the exact DP over KEEP / REMAT / OFFLOAD per layer under a
                byte budget (greedy past 16 layers); deterministic JSON
  policy.py     a plan as torch.utils.checkpoint segments over the model's
                saved tensors

Driven by ``-mem-plan {keep,auto,remat}`` and ``-mem-budget`` (the
``ROC_MEM_*`` mirrors); ``python -m roc_tpu_torch.memory`` dumps a plan.
"""

from roc_tpu_torch.memory.estimator import (LayerEstimate, ModelEstimate,
                                            estimate_for_trainer,
                                            estimate_model, fixed_bytes_for,
                                            port_resident_bytes,
                                            step_arg_bytes)
from roc_tpu_torch.memory.planner import (KEEP, OFFLOAD, REMAT, MemPlan,
                                          device_budget_bytes, feasible,
                                          measured_peak_bytes, plan_memory,
                                          predict_peak, predict_time)
from roc_tpu_torch.memory.policy import loss_fn

__all__ = [
    "KEEP", "REMAT", "OFFLOAD", "LayerEstimate", "ModelEstimate", "MemPlan",
    "estimate_for_trainer", "estimate_model", "fixed_bytes_for",
    "port_resident_bytes", "step_arg_bytes", "device_budget_bytes",
    "measured_peak_bytes", "plan_memory", "predict_peak", "predict_time",
    "feasible", "loss_fn",
]
