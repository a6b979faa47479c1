"""Run configuration and CLI (roc_tpu/train/config.py), holding the fields
the ported serving, training and graph-input paths read.  Defaults, flag
names and dests match the JAX package's (config.py:398-466); ``-device``
is the port's own."""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

BACKENDS = ("auto", "xla", "matmul", "pallas", "binned")


@dataclasses.dataclass
class Config:
    filename: str = ""            # ROC-format dataset prefix (-file)
    dataset: str = ""             # registry name (synthetic or vendored)
    layers: List[int] = dataclasses.field(default_factory=list)
    num_epochs: int = 1
    learning_rate: float = 0.01
    weight_decay: float = 0.05
    dropout_rate: float = 0.5
    decay_rate: float = 1.0
    decay_steps: int = 100
    model: str = "gcn"            # gcn | gcn-chain | sage | gin | gat
    heads: int = 8                # attention heads (gat only)
    aggr: str = ""                # "" = the model's default
    seed: int = 1
    aggregate_backend: str = "auto"  # auto | xla | matmul | pallas | binned
    aggregate_precision: str = "fast"  # fast: one bf16 rounding of features
                                  # at aggregation input, fp32 accumulation;
                                  # exact: fp32 end to end
    verbose: bool = False
    eval_every: int = 5           # the reference evaluates every 5 epochs
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0     # 0 = disabled
    resume: bool = False
    megafuse: bool = False        # whole-layer megakernel: each eligible
                                  # aggregate->linear(->relu) layer runs as
                                  # one kernel forward and one backward
    fusion_depth: int = 1         # cross-layer fusion-region cap (needs
                                  # megafuse): 1 off, N chains of at most
                                  # N layers, 0 unlimited
    lazy_load: bool = False       # memmap features / defer one-hot labels
    reorder: str = "off"          # RCM vertex order before training:
                                  # off | on | auto (kept on a >=10% cut
                                  # of graph/reorder.py:padded_rows)
    device: str = "cuda"          # cuda, or cpu when asked for
    serve_batch: int = 64         # microbatch cap and top of the bucket ladder
    serve_wait_ms: float = 2.0    # max ms a serving window stays open
    serve_queue_max: int = 4096   # pending requests before submit() sheds;
                                  # 0 = unbounded

    def __post_init__(self):
        if self.aggregate_backend not in BACKENDS:
            raise ValueError(f"aggregate_backend={self.aggregate_backend!r}:"
                             f" one of {'|'.join(BACKENDS)}")
        if self.aggregate_precision not in ("fast", "exact"):
            raise ValueError(f"aggregate_precision="
                             f"{self.aggregate_precision!r}: fast|exact")
        if self.serve_batch < 1:
            raise ValueError(f"serve_batch={self.serve_batch}: the serving "
                             "window must admit at least one query")
        if self.serve_wait_ms < 0:
            raise ValueError(f"serve_wait_ms={self.serve_wait_ms} must be "
                             ">= 0 (0 drains after every request)")
        if self.serve_queue_max < 0:
            raise ValueError(f"serve_queue_max={self.serve_queue_max} must "
                             "be >= 0 (0 disables the depth cap)")
        if self.fusion_depth < 0:
            raise SystemExit(f"bad fusion_depth {self.fusion_depth} "
                             "(0 = full, 1 = off, >=2 = cap)")
        if self.eval_every < 1 or self.decay_steps < 1:
            raise ValueError(f"eval_every={self.eval_every} and decay_steps="
                             f"{self.decay_steps} must be >= 1")


def parse_args(argv: List[str]) -> Config:
    p = argparse.ArgumentParser(
        prog="roc_tpu_torch",
        description="full-graph GNN training on one NVIDIA GPU")
    p.add_argument("-file", dest="filename", default="")
    p.add_argument("-dataset", default="")
    p.add_argument("-layers", default="",
                   help="dash-separated widths, e.g. 602-256-41")
    p.add_argument("-e", "-epoch", dest="num_epochs", type=int, default=1)
    p.add_argument("-lr", dest="learning_rate", type=float, default=0.01)
    p.add_argument("-dropout", dest="dropout_rate", type=float, default=0.5)
    p.add_argument("-decay", "-wd", dest="weight_decay", type=float,
                   default=0.05)
    p.add_argument("-decay-rate", dest="decay_rate", type=float, default=1.0)
    p.add_argument("-decay-step", "-ds", dest="decay_steps", type=int,
                   default=100)
    p.add_argument("-seed", type=int, default=1)
    p.add_argument("-model", default="gcn",
                   choices=["gcn", "gcn-chain", "sage", "gin", "gat"])
    p.add_argument("-heads", type=int, default=8)
    p.add_argument("-aggr", default="",
                   choices=["", "sum", "avg", "max", "min"])
    p.add_argument("-aggr-precision", dest="aggregate_precision",
                   default="fast", choices=["exact", "fast"])
    p.add_argument("-aggr-backend", dest="aggregate_backend", default="auto",
                   choices=list(BACKENDS))
    p.add_argument("-v", dest="verbose", action="store_true")
    p.add_argument("-eval-every", dest="eval_every", type=int, default=5)
    p.add_argument("-ckpt", dest="checkpoint_path", default=None)
    p.add_argument("-ckpt-every", dest="checkpoint_every", type=int,
                   default=0)
    p.add_argument("-resume", action="store_true")
    p.add_argument("-megafuse", dest="megafuse", action="store_true",
                   help="run each aggregate->linear(->relu) layer as one "
                        "megakernel, forward and backward")
    p.add_argument("-fusion-depth", dest="fusion_depth", type=int,
                   default=1,
                   help="cross-layer fusion-region cap (needs -megafuse): "
                        "1 per-layer only (default), 2 chain two layers, "
                        "0 full chain")
    p.add_argument("-lazy", dest="lazy_load", action="store_true")
    p.add_argument("-reorder", nargs="?", const="on", default="off",
                   choices=["on", "off", "auto"])
    p.add_argument("-device", default="cuda",
                   help="cuda (default) or cpu")
    ns = p.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name)
                    for f in dataclasses.fields(Config)
                    if f.name != "layers" and hasattr(ns, f.name)})
    if ns.layers:
        cfg.layers = [int(x) for x in ns.layers.split("-")]
    return cfg
