"""Launch autotuner (roc_tpu/tune retargeted at the Hopper kernels): search
the kernels' launch parameters per graph, direction and width, keep the
winners in a content-keyed store, refit the launch model's rates.

roc_tpu's tuner searches binned-plan Geometries and Pallas knobs.  The
port's kernels have no plan; what they fix in code is how a CSR row is
spread over lanes: the sum's lanes a row and edges in flight, the GAT
forward's lane group.  This package searches those:

  lattice.py    the candidate space: every launch the libraries build that
                covers a row in no more passes than the default rule.
  surrogate.py  trial pricing: the analytic launch model (bytes over lane
                use, lane-group rows), the seeded CI surrogate (roc_tpu's
                noise, byte for byte), and CUDA-event timing on the card.
  search.py     successive halving (screen -> trial -> confirm), every
                trial paired through the calibration ledger, the refit
                probes, ``autotune_graph`` over both directions.
  store.py      the content-keyed ``tuned_cuda.json`` that
                ``ops.DeviceCsr`` placements read (roc_tpu's keys).
  refit.py      re-solve the model's two rates; on the card, the port's
                measured table (name and power limit beside it).

Entry points: ``python -m roc_tpu_torch.tune`` (``__main__.py``) and the
trainer's ``-autotune`` / ``ROC_AUTOTUNE=1``.  No launch changes a bit,
so a tuned run's losses are the untuned run's.  Determinism: the
surrogate sweep is bit-reproducible (seeded hashlib noise, sorted
candidates, no clocks), so two sweeps write byte-identical stores; card
timings are never recorded off the card.
"""

from roc_tpu_torch.tune.lattice import (  # noqa: F401
    LaunchConfig, candidate_lattice)
from roc_tpu_torch.tune.search import autotune_graph, sweep  # noqa: F401
from roc_tpu_torch.tune.store import (  # noqa: F401
    graph_key, launch_table, load_store, lookup, save_store,
    tuned_store_path, validate_store, variant_key)
