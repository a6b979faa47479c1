from roc_tpu_torch.models.gat import build_gat
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.models.gin import build_gin
from roc_tpu_torch.models.model import (GraphCtx, Model, mega_matches,
                                        mega_regions)
from roc_tpu_torch.models.sage import build_sage


def build_model(name: str, layers, dropout_rate: float = 0.5,
                aggr: str = "", heads: int = 8) -> Model:
    """Model registry keyed by the CLI's -model flag
    (roc_tpu/models/__init__.py).  ``aggr=""`` is the model's own default
    (gcn and gcn-chain: sum; sage: avg; gin: sum, the only aggregation its
    update is defined on).  ``heads`` applies to gat only."""
    if name == "gcn":
        return build_gcn(layers, dropout_rate, aggr or "sum")
    if name == "gcn-chain":
        return build_gcn(layers, dropout_rate, aggr or "sum", residual=False)
    if name == "sage":
        return build_sage(layers, dropout_rate, aggr or "avg")
    if name == "gin":
        if aggr not in ("", "sum"):
            raise ValueError("gin is defined on sum aggregation")
        return build_gin(layers, dropout_rate)
    if name == "gat":
        return build_gat(layers, dropout_rate, heads=heads)
    raise ValueError(f"unknown model {name!r} (gcn|gcn-chain|sage|gin|gat)")


__all__ = ["Model", "GraphCtx", "build_gat", "build_gcn", "build_gin",
           "build_model", "build_sage", "mega_matches", "mega_regions"]
