"""Frozen-parameter loading for forward-only consumers
(roc_tpu/train/frozen.py): checkpoint in, a :class:`FrozenBundle` out, with
the params (weights only, no optimizer arrays), the features and the graph
data resident on one device.  The graph data is built through the same
backend resolution as training (``graph_data.effective_backend``), with
the CSR alone: a forward-only consumer runs only forward kernels.  Under
``megafuse`` the forward runs each eligible layer through the megakernel,
as the trainer's eval does; serving stays at fusion depth 1, as the JAX
package's frozen path does.  ``-bf16`` places the features in bf16.

Under ``config.stream`` the bundle wraps the streaming executor's slots
instead (frozen.py:15-18, 54-107): no graph data and no features are
placed, and ``predict_logits`` sweeps the shards through the slots as the
streamed eval does, so a graph that never fits the card is served."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from roc_tpu_torch.device import resolve_device
from roc_tpu_torch.graph.datasets import Dataset
from roc_tpu_torch.models.model import Model
from roc_tpu_torch.ops import prng
from roc_tpu_torch.train import checkpoint
from roc_tpu_torch.train.config import Config
from roc_tpu_torch.train.graph_data import (DenseGraphData, dense_graph_data,
                                            effective_backend,
                                            host_to_device, make_gctx)


@dataclasses.dataclass
class FrozenBundle:
    """Everything a forward-only consumer needs, loaded once.  ``params``
    are never updated.  ``x`` and ``gdata`` are None under streaming,
    where ``stream_trainer`` holds the slots instead."""

    config: Config
    dataset: Dataset
    model: Model
    params: Dict[str, torch.Tensor]
    x: Optional[torch.Tensor]
    gdata: Optional[DenseGraphData]
    num_nodes: int
    device: torch.device
    megafuse: bool = False
    stream_trainer: object = None

    def predict_logits(self) -> torch.Tensor:
        """One full-graph eval forward: logits [N, C] in node order, on the
        device.  The parity oracle served queries are held against."""
        if self.stream_trainer is not None:
            with torch.no_grad():
                return self.stream_trainer.predict_logits()
        with torch.inference_mode():
            return self.model.apply(self.params, self.x,
                                    make_gctx(self.gdata, self.megafuse),
                                    train=False)


def load_frozen(config: Config, dataset: Dataset, model: Model,
                checkpoint_path: Optional[str] = None,
                device=None, params=None) -> FrozenBundle:
    """Load a checkpoint into a forward-only bundle on ``device`` (CUDA
    unless the caller asks for the CPU).

    Weights come from ``params`` (a dict of tensors), else from
    ``checkpoint_path`` or ``config.checkpoint_path``, else roc_tpu's Glorot
    init from ``PRNGKey(config.seed)``."""
    dev = resolve_device(device)
    path = checkpoint_path or config.checkpoint_path
    if config.stream:
        from roc_tpu_torch.stream.executor import StreamTrainer
        tr = StreamTrainer(dataclasses.replace(config, device=str(dev)),
                           dataset, model)
        if params is not None:
            tr.params = {k: v.to(dev) for k, v in params.items()}
        elif path:
            tr.params = checkpoint.load_params(path, tr.params)
        return FrozenBundle(config=config, dataset=dataset, model=model,
                            params=tr.params, x=None, gdata=None,
                            num_nodes=dataset.graph.num_nodes, device=dev,
                            megafuse=config.megafuse, stream_trainer=tr)
    backend = effective_backend(config, model, dev)
    gdata = dense_graph_data(dataset.graph, backend,
                             config.aggregate_precision, dev,
                             transpose=False, megafuse=config.megafuse)
    # -bf16 places x in bf16, as roc_tpu/train/frozen.py:120 does
    x = host_to_device(dataset.features, dev,
                       torch.bfloat16 if config.use_bf16 else torch.float32)
    if params is None:
        params = model.init_params(prng.prng_key(config.seed), device=dev)
        if path:
            params = checkpoint.load_params(path, params)
    params = {k: v.to(dev) for k, v in params.items()}
    return FrozenBundle(config=config, dataset=dataset, model=model,
                        params=params, x=x, gdata=gdata,
                        num_nodes=dataset.graph.num_nodes, device=dev,
                        megafuse=config.megafuse)
