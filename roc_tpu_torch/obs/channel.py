"""Per-step metrics (roc_tpu/obs/channel.py): the norms the trainer reports
once per epoch, and the wire bytes of the SPMD trainer's exchanges.
roc_tpu computes the norms inside its jitted step; here they are tensors
on the device, read after the epoch's timed window.  The wire bytes are a
constant of the exchange geometry (send rows, feature widths, wire dtype),
computed once on the host.  Edge sharding counts as the allgather: each
position contributes its S rows to the [P*S, H] table (spmd.py:1796)."""

from __future__ import annotations

from typing import Dict, Iterable

import torch


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over every tensor of a dict (fp32 accumulation)."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros(())
    total = sum(torch.sum(torch.square(t.to(torch.float32))) for t in leaves)
    return torch.sqrt(total)


def wire_itemsize(xch_dtype: str, xch_comp: str = "plain") -> int:
    """Bytes per exchanged fp32-equivalent element: bf16 plain halves the
    wire, compensated (a hi, lo bf16 pair) is fp32's width again."""
    item = 2 if xch_dtype == "bf16" else 4
    if xch_comp == "compensated":
        item *= 2
    return item


def exchange_rows(exchange: str, num_parts: int, rows_per_shard: int,
                  send_cols: int = 0) -> int:
    """Feature rows one mesh position puts on the wire per exchange.

    halo: the send map ships ``send_cols`` rows to each of ``num_parts``
    destinations (send_idx is [P, P, K]); allgather: the part contributes
    its padded ``rows_per_shard`` once; ring: the part's rows forwarded on
    each of P-1 hops."""
    if exchange == "halo":
        return num_parts * send_cols
    if exchange == "ring":
        return max(num_parts - 1, 0) * rows_per_shard
    return rows_per_shard


def wire_bytes_per_step(exchange: str, num_parts: int, rows_per_shard: int,
                        widths: Iterable[int], send_cols: int = 0,
                        xch_dtype: str = "fp32",
                        xch_comp: str = "plain") -> int:
    """Wire bytes of one train step, one exchange per aggregation at each
    feature width in ``widths`` (the forward's; the caller decides which
    passes to count), as roc_tpu counts them."""
    rows = exchange_rows(exchange, num_parts, rows_per_shard, send_cols)
    item = wire_itemsize(xch_dtype, xch_comp)
    return int(rows * item * sum(int(w) for w in widths))
