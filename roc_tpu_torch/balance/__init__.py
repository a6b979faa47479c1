"""Online cost-model load balancer (roc_tpu/balance/): ROC's online
partitioner loop.

  telemetry.py   per-part work counters + probe timings (ring, JSONL)
  cost_model.py  least-squares fit t_p ~ w . [nodes, edges, halo_in,
                 halo_out, 1], its warm-start prior priced for the card
  search.py      min-max repartition search over contiguous cuts
  manager.py     BalanceManager: collect -> fit -> propose -> apply

The trainer drives it at epoch boundaries (``-balance-every``,
train/driver.py) and applies proposals through ``SpmdTrainer.reshard``
(parallel/spmd.py).
"""

from roc_tpu_torch.balance.cost_model import OnlineCostModel
from roc_tpu_torch.balance.manager import BalanceManager
from roc_tpu_torch.balance.telemetry import ShardSample, TelemetryBuffer

__all__ = ["BalanceManager", "OnlineCostModel", "ShardSample",
           "TelemetryBuffer"]
