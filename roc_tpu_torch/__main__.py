"""CLI entry: ``python -m roc_tpu_torch (-file PREFIX [-lazy] | -dataset
NAME) -layers 602-256-41 -e 10 [-reorder [on|auto]] [-model
gcn|gcn-chain|sage|gin|gat] [-heads K] [-aggr A] [-megafuse [-fusion-depth
N]] [-bf16] [-bf16-storage [-bf16-rounding stochastic] [-bf16-exchange
compensated]] [-parts N [-no-halo | -exchange halo|allgather]
[-no-halo-overlap] [-exchange ring] [-edge-shard [on|off|auto]]
[-check-sharding] [-balance-every N] [-perhost] [-multihost]] [-fault
SPEC] [-ckpt PATH [-ckpt-every N] [-resume]] [-profile DIR [-profile-epochs
START:COUNT]] [-obs [-obs-dir DIR]] [-device cpu]`` (roc_tpu/__main__.py).

``-parts N`` trains N parts through the SPMD trainer on the one device
(``parallel/spmd.py``; k = N parts per mesh position), or with
``-stream`` through the streaming executor.  ``-check-sharding`` first
checks the sharded evaluation against the single-device one.

``-multihost`` runs one process per device: start it under ``torchrun
--nproc-per-node N`` (or set ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` yourself); each process joins the
process group before it builds anything (``parallel/collectives.py``:
nccl on ``cuda:{LOCAL_RANK}``, gloo with ``-device cpu``) and holds
``-parts / W`` mesh positions.  Under ``-obs`` with more than one process
each rank writes its artifacts to ``obs_dir/rank{r}``.

``-file`` reads the reference's on-disk format (``PREFIX.add_self_edge.lux``
and its sidecars; ``python -m roc_tpu_torch.graph`` writes it), as
``./gnn ... -file dataset/reddit-dgl`` does (test.sh:8).  Trains on one
NVIDIA GPU; ``-device cpu`` runs on the CPU instead, and without a GPU and
without that flag the command exits non-zero.  ``-profile DIR`` prints
where the trace went; SIGTERM or SIGINT ends the run after the epoch in
flight, with its final checkpoint, and exit code 0.
"""

from __future__ import annotations

import os
import sys

from roc_tpu_torch import obs
from roc_tpu_torch.device import resolve_device
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.graph.reorder import maybe_reorder_dataset
from roc_tpu_torch.models import build_model
from roc_tpu_torch.train.config import parse_args
from roc_tpu_torch.train.driver import make_trainer


def _refusal(cfg) -> str:
    """roc_tpu's CLI refusals (roc_tpu/__main__.py:29-70), with its
    reasons; "" when the flags compose."""
    if cfg.perhost_load and (cfg.num_parts < 2 or not cfg.filename):
        return "error: -perhost requires -file and -parts > 1"
    edge_on = cfg.edge_shard in (True, "on")
    if cfg.exchange == "ring" and edge_on:
        return ("error: -exchange ring and -edge-shard are mutually "
                "exclusive distribution strategies")
    if edge_on and (cfg.num_parts < 2 or cfg.aggr in ("max", "min")):
        return ("error: -edge-shard supports sum/avg aggregation and needs "
                "-parts > 1 (it composes with -perhost given the .t.lux "
                "transposed sidecar)")
    if cfg.perhost_load and cfg.check_sharding:
        # the checker's single-device reference needs the whole graph
        return ("error: -check-sharding needs the full graph on one host; "
                "run it without -perhost")
    if not cfg.stream:
        return ""
    if cfg.num_parts < 2:
        return ("error: -stream needs -parts >= 2 (shards rotate through "
                "the device slots; one shard streams nothing)")
    if edge_on or cfg.exchange == "ring":
        return ("error: -stream schedules its own shard rotation; "
                "-edge-shard / -exchange ring do not compose with it")
    if cfg.multihost:
        return ("error: -stream is single-process — it trades host memory "
                "for device memory instead of scaling out; drop -multihost")
    if cfg.check_sharding:
        return ("error: -check-sharding/-analyze audit the in-core SPMD "
                "step; run them without -stream")
    if cfg.use_bf16:
        return ("error: -stream computes in fp32; the streamed storage cut "
                "is -bf16-storage (bf16 slots, fp32 accumulation)")
    return ""


# roc_tpu's -analyze (roc_tpu/analysis/) audits the steps XLA lowered: their
# collectives, f64 ops and budgets, and retraces.  The port runs eager
# PyTorch: there is no lowered step to audit.
ANALYZE_REFUSAL = ("error: -analyze audits the lowered XLA steps of "
                   "roc_tpu (collectives, f64 ops, budgets, retraces); the "
                   "PyTorch port runs eager and has no lowered step to "
                   "audit")


def main(argv=None) -> int:
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    if cfg.analyze:
        print(ANALYZE_REFUSAL, file=sys.stderr)
        return 1
    refusal = _refusal(cfg)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    if cfg.multihost:
        from roc_tpu_torch.parallel import collectives
        try:
            dev = resolve_device(collectives.process_device(cfg.device))
        except RuntimeError as e:
            print(f"error: {e} (-device cpu)", file=sys.stderr)
            return 1
        cfg.device = str(dev)
        comm = collectives.init_process_group(dev)
        if cfg.obs and cfg.obs_dir and comm.world > 1:
            cfg.obs_dir = os.path.join(cfg.obs_dir, f"rank{comm.rank}")
        try:
            return _main(cfg)
        finally:
            collectives.destroy_process_group()
    return _main(cfg)


def _main(cfg) -> int:
    if not cfg.layers:
        print("error: -layers is required (e.g. -layers 602-256-41)",
              file=sys.stderr)
        return 2
    try:
        resolve_device(cfg.device)
    except RuntimeError as e:
        print(f"error: {e} (-device cpu)", file=sys.stderr)
        return 1
    # Config banner, as gnn.cc:48-60 prints it.
    print("        ===== GNN settings =====", file=sys.stderr)
    print(f"        dataset = {cfg.filename or cfg.dataset} seed = {cfg.seed}\n"
          f"        num_epochs = {cfg.num_epochs} learning_rate = {cfg.learning_rate:.4f}\n"
          f"        weight_decay = {cfg.weight_decay:.4f} dropout_rate = {cfg.dropout_rate:.4f}\n"
          f"        decay_rate = {cfg.decay_rate:.4f} decay_steps = {cfg.decay_steps}",
          file=sys.stderr)
    print(f"        Layers: {' '.join(map(str, cfg.layers))}", file=sys.stderr)
    if cfg.filename:
        ds = datasets.load_roc_dataset(cfg.filename, cfg.layers[0],
                                       cfg.layers[-1], lazy=cfg.lazy_load,
                                       graph_stub=cfg.perhost_load)
    elif cfg.dataset:
        ds = datasets.get(cfg.dataset, seed=cfg.seed)
        if ds.in_dim != cfg.layers[0]:
            print(f"error: -layers head {cfg.layers[0]} != dataset in_dim "
                  f"{ds.in_dim}", file=sys.stderr)
            return 2
        if ds.num_classes != cfg.layers[-1]:
            print(f"error: -layers tail {cfg.layers[-1]} != dataset classes "
                  f"{ds.num_classes}", file=sys.stderr)
            return 2
    else:
        print("error: one of -file or -dataset is required", file=sys.stderr)
        return 2
    if cfg.reorder != "off":
        if cfg.perhost_load:
            print("error: -reorder needs the whole graph in memory; "
                  "incompatible with -perhost (preprocess the dataset "
                  "offline instead)", file=sys.stderr)
            return 2
        with obs.span("reorder") as sp:
            ds, _, note = maybe_reorder_dataset(ds, cfg.reorder)
        print(f"# {note} ({ds.graph.num_nodes} nodes, "
              f"{sp.dur_s:.1f}s)", file=sys.stderr)
    model = build_model(cfg.model, cfg.layers, cfg.dropout_rate, cfg.aggr,
                        heads=cfg.heads)
    # one trainer build: -check-sharding and the run share its parts
    trainer = make_trainer(cfg, ds, model)
    if cfg.check_sharding and cfg.num_parts > 1:
        from roc_tpu_torch.parallel.check import check_shard_consistency
        check_shard_consistency(cfg, ds, model, sharded_trainer=trainer)
        print("# shard-consistency check passed "
              f"({cfg.num_parts} parts, halo={cfg.halo})", file=sys.stderr)
    trainer.train()
    if cfg.multihost and cfg.verbose:
        from roc_tpu_torch.parallel import collectives
        g = collectives.group()
        print(f"# -multihost: rank {g.rank} of {g.world} ({g.backend} on "
              f"{g.device}), collectives {collectives.launches()}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
