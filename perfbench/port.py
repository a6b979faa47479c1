"""What the harness hands the port for a configuration, the same for every
kind of run: the port's ``Config`` and ``Model`` (the model's name,
widths, heads, dropout and precision), and the seed's leaves in place of
the port's own, once they are the port's by name and shape."""

from __future__ import annotations


def build(cfg, seed: int, device, use_bf16: bool = False, **run):
    """(Config, Model) of the port for ``cfg``; ``run`` holds the kind's
    own fields (the learning rate and decay; the serving window).
    ``use_bf16`` switches on the port's ``-bf16`` path (the control)."""
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.train.config import Config
    conf = Config(model=cfg["model"], layers=list(cfg["layers"]),
                  heads=int(cfg.get("heads", 1)),
                  dropout_rate=float(cfg["dropout"]),
                  aggregate_precision=cfg["precision"],
                  aggregate_backend="binned", seed=int(seed),
                  device=device.type, use_bf16=use_bf16, **run)
    model = build_model(conf.model, conf.layers, conf.dropout_rate,
                        heads=conf.heads)
    return conf, model


def leaves_for(port_params: dict, drawn: dict, device) -> dict:
    """``drawn`` on ``device``, in its order, where its leaves are the
    port's ``port_params`` by name and shape; SystemExit naming the
    missing, extra and misshapen leaves otherwise."""
    shape = {k: tuple(v.shape) for k, v in port_params.items()}
    faults = [f"missing {k} {shape[k]}" for k in shape if k not in drawn]
    for k, v in drawn.items():
        if k not in shape:
            faults.append(f"extra {k} {tuple(v.shape)}")
        elif tuple(v.shape) != shape[k]:
            faults.append(f"misshapen {k} {tuple(v.shape)}, the port's "
                          f"{shape[k]}")
    if faults:
        raise SystemExit("the drawn leaves are not the port's parameters: "
                         + "; ".join(faults))
    return {k: w.to(device) for k, w in drawn.items()}
