from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.models.model import GraphCtx, Model, mega_matches


def build_model(name: str, layers, dropout_rate: float = 0.5,
                aggr: str = "") -> Model:
    """Model registry keyed by the CLI's -model flag; the port has GCN so
    far.  ``aggr=""`` is GCN's default, sum."""
    if name == "gcn":
        return build_gcn(layers, dropout_rate, aggr or "sum")
    if name in ("gcn-chain", "sage", "gin", "gat"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP queue A, model zoo)")
    raise ValueError(f"unknown model {name!r}")


__all__ = ["Model", "GraphCtx", "build_gcn", "build_model", "mega_matches"]
