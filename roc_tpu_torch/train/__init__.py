from roc_tpu_torch.train.config import Config, parse_args
from roc_tpu_torch.train.driver import TrainStats, Trainer, make_trainer
from roc_tpu_torch.train.frozen import FrozenBundle, load_frozen

__all__ = ["Config", "FrozenBundle", "TrainStats", "Trainer", "load_frozen",
           "make_trainer", "parse_args"]
