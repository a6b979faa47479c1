"""CLI entry: ``python -m roc_tpu_torch -dataset reddit -layers 602-256-41
-e 10 [-model gcn|gcn-chain|sage|gin|gat] [-heads K] [-aggr A] [-megafuse
[-fusion-depth N]] [-device cpu]`` (roc_tpu/__main__.py).

Trains on one NVIDIA GPU; ``-device cpu`` runs on the CPU instead, and
without a GPU and without that flag the command exits non-zero.  Reading
ROC-format files (``-file``) is not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import sys

from roc_tpu_torch.device import resolve_device
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.models import build_model
from roc_tpu_torch.train.config import parse_args
from roc_tpu_torch.train.driver import make_trainer


def main(argv=None) -> int:
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    if not cfg.layers:
        print("error: -layers is required (e.g. -layers 602-256-41)",
              file=sys.stderr)
        return 2
    if not cfg.dataset:
        print("error: -dataset is required (-file is not ported yet)",
              file=sys.stderr)
        return 2
    try:
        resolve_device(cfg.device)
    except RuntimeError as e:
        print(f"error: {e} (-device cpu)", file=sys.stderr)
        return 1
    # Config banner, as gnn.cc:48-60 prints it.
    print("        ===== GNN settings =====", file=sys.stderr)
    print(f"        dataset = {cfg.dataset} seed = {cfg.seed}\n"
          f"        num_epochs = {cfg.num_epochs} learning_rate = {cfg.learning_rate:.4f}\n"
          f"        weight_decay = {cfg.weight_decay:.4f} dropout_rate = {cfg.dropout_rate:.4f}\n"
          f"        decay_rate = {cfg.decay_rate:.4f} decay_steps = {cfg.decay_steps}",
          file=sys.stderr)
    print(f"        Layers: {' '.join(map(str, cfg.layers))}", file=sys.stderr)
    ds = datasets.get(cfg.dataset, seed=cfg.seed)
    if ds.in_dim != cfg.layers[0]:
        print(f"error: -layers head {cfg.layers[0]} != dataset in_dim "
              f"{ds.in_dim}", file=sys.stderr)
        return 2
    if ds.num_classes != cfg.layers[-1]:
        print(f"error: -layers tail {cfg.layers[-1]} != dataset classes "
              f"{ds.num_classes}", file=sys.stderr)
        return 2
    model = build_model(cfg.model, cfg.layers, cfg.dropout_rate, cfg.aggr,
                        heads=cfg.heads)
    make_trainer(cfg, ds, model).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
