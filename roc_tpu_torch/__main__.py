"""CLI entry: ``python -m roc_tpu_torch (-file PREFIX [-lazy] | -dataset
NAME) -layers 602-256-41 -e 10 [-reorder [on|auto]] [-model
gcn|gcn-chain|sage|gin|gat] [-heads K] [-aggr A] [-megafuse [-fusion-depth
N]] [-bf16] [-bf16-storage [-bf16-rounding stochastic] [-bf16-exchange
compensated]] [-parts N [-no-halo | -exchange halo|allgather]
[-no-halo-overlap] [-check-sharding] [-balance-every N] [-perhost]] [-fault
SPEC] [-ckpt PATH [-ckpt-every N] [-resume]] [-profile DIR [-profile-epochs
START:COUNT]] [-obs [-obs-dir DIR]] [-device cpu]`` (roc_tpu/__main__.py).

``-parts N`` trains N parts through the SPMD trainer on the one device
(``parallel/spmd.py``; k = N parts per mesh position), or with
``-stream`` through the streaming executor.  ``-check-sharding`` first
checks the sharded evaluation against the single-device one.

``-file`` reads the reference's on-disk format (``PREFIX.add_self_edge.lux``
and its sidecars; ``python -m roc_tpu_torch.graph`` writes it), as
``./gnn ... -file dataset/reddit-dgl`` does (test.sh:8).  Trains on one
NVIDIA GPU; ``-device cpu`` runs on the CPU instead, and without a GPU and
without that flag the command exits non-zero.  ``-profile DIR`` prints
where the trace went; SIGTERM or SIGINT ends the run after the epoch in
flight, with its final checkpoint, and exit code 0.
"""

from __future__ import annotations

import sys
import time

from roc_tpu_torch.device import resolve_device
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.graph.reorder import maybe_reorder_dataset
from roc_tpu_torch.models import build_model
from roc_tpu_torch.train.config import parse_args
from roc_tpu_torch.train.driver import make_trainer


def main(argv=None) -> int:
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    if not cfg.layers:
        print("error: -layers is required (e.g. -layers 602-256-41)",
              file=sys.stderr)
        return 2
    if cfg.perhost_load and (cfg.num_parts < 2 or not cfg.filename):
        print("error: -perhost requires -file and -parts > 1",
              file=sys.stderr)
        return 2
    if cfg.perhost_load and cfg.check_sharding:
        # the checker's single-device reference needs the whole graph
        print("error: -check-sharding needs the full graph on one host; "
              "run it without -perhost", file=sys.stderr)
        return 2
    if cfg.stream and (cfg.check_sharding or cfg.exchange == "ring"
                       or cfg.edge_shard in (True, "on")):
        print("error: -stream schedules its own shard rotation; "
              "-check-sharding / -exchange ring / -edge-shard do not "
              "compose with it", file=sys.stderr)
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
        t0 = time.perf_counter()
        ds, _, note = maybe_reorder_dataset(ds, cfg.reorder)
        print(f"# {note} ({ds.graph.num_nodes} nodes, "
              f"{time.perf_counter() - t0:.1f}s)", file=sys.stderr)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
