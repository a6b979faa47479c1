"""roc_tpu_torch: the PyTorch/CUDA port of roc_tpu, for one NVIDIA H100.

The JAX package ``roc_tpu`` stays the reference; this package never imports
it (nor jax).  Each module mirrors its counterpart's path:

  graph/     in-edge CSR, the dataset registry (synthetic and the vendored
             real graphs), the reference's on-disk format (lux), the
             converters (python -m roc_tpu_torch.graph), the RCM reorder,
             the edge-balanced partition
  fault/     the non-finite step guard and its step.nan scale, fault
             injection, retries, durable file replacement
  obs/       span tracer (Chrome trace), metrics registry (JSONL,
             Prometheus textfile), the perf watchdog, the card's roofline
  ops/       norm, activation, element, dropout, init, linear, aggregate,
             edge attention; prng (jax.random's threefry streams);
             ops/kernels/ holds the hand-written CUDA kernels' loaders
  csrc/      CUDA C++ sources, built with nvcc for sm_90a at first use
  models/    op-IR builder, GCN, gcn-chain, SAGE, GIN, GAT; the
             region-plan dump (python -m roc_tpu_torch.models)
  train/     config, npz checkpoints shared with roc_tpu, graph data,
             frozen-parameter loading, the single-device trainer and its
             run controls (-bf16, -fault, signals, -profile, -obs)
  serve/     ServeEngine, microbatch queue, load generator, parity metric
  memory/    the activation-memory planner (-mem-plan, -mem-budget;
             python -m roc_tpu_torch.memory)
  stream/    the out-of-core streaming executor (-stream, -parts)
  native/    the host graph builders in C++ (.lux reads, the feature CSV,
             the cut, halo maps, the CSR transpose and RCM), built with g++
             at first use; ROC_TPU_NO_NATIVE=1 selects their NumPy twins
  analysis/  roclint, the lock-discipline analyzer (threads.json) and the
             runtime lock-order witness

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from roc_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
