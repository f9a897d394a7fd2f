"""Edge partitioning for the multi-process sparse (COO) path, the
counterpart of ``egnn_tpu/parallel/sparse_partition.py``.

The layout that ``EGNNSparse(shard_axis=group)`` reads:

- nodes are block-sharded over the group: rank s owns the global nodes
  [s*nl, (s+1)*nl), nl = n // shards;
- every edge lives on the rank that owns its receiver, the receiver id made
  local (global - s*nl), the sender id kept global: it is resolved against
  one all-gather of the node rows a layer;
- each rank's edges are padded to one capacity and masked, so that every
  rank holds the same shapes.

``partition_edges`` repacks any global COO list into that layout; the pack
is stable, so the receiver-major order of the ``ops/graph.py`` builders
survives. ``partition_uniform_edges`` cuts a uniform-degree layout, which
needs no repacking. Plain tensor functions, on any device; ids come out as
int64, torch's index type (the JAX package's are int32, of the same
values).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PartitionedEdges(NamedTuple):
    """The ranks' edge arrays, concatenated: rank s owns rows
    [s*capacity, (s+1)*capacity) (``sparse_node_block`` cuts them)."""

    senders: torch.Tensor                # (shards*capacity,) int64, global ids
    receivers: torch.Tensor              # (shards*capacity,) int64, local ids
    mask: torch.Tensor                   # (shards*capacity,) bool
    edge_attr: Optional[torch.Tensor]    # (shards*capacity, e) or None
    capacity: int


def partition_edges(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    n: int,
    shards: int,
    edge_attr: Optional[torch.Tensor] = None,
    edge_mask: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
) -> PartitionedEdges:
    """Repack a global COO edge list into the receiver-owned layout.

    ``capacity`` is each rank's edge budget (default: the global edge count,
    always enough); past it a rank's edges are dropped from the end, as the
    JAX package drops them."""
    if n % shards:
        raise ValueError(f"n={n} must divide evenly over {shards} shards")
    nl = n // shards
    e = senders.shape[0]
    cap = capacity if capacity is not None else e
    valid = torch.ones(e, dtype=torch.bool, device=senders.device) if edge_mask is None \
        else edge_mask.bool()
    shard_of = receivers // nl
    snd, rcv, msk, attr = [], [], [], []
    for s in range(shards):
        sel = valid & (shard_of == s)
        # stable pack: the selected edges first, in their (receiver-major) order
        order = torch.argsort((~sel).to(torch.uint8), stable=True)[:cap]
        m = sel[order]
        snd.append(torch.where(m, senders[order], 0).long())
        rcv.append(torch.where(m, receivers[order] - s * nl, 0).long())
        msk.append(m)
        if edge_attr is not None:
            attr.append(torch.where(m[:, None], edge_attr[order],
                                    torch.zeros((), dtype=edge_attr.dtype,
                                                device=edge_attr.device)))
    return PartitionedEdges(senders=torch.cat(snd), receivers=torch.cat(rcv),
                            mask=torch.cat(msk),
                            edge_attr=torch.cat(attr) if edge_attr is not None else None,
                            capacity=cap)


def partition_uniform_edges(
    senders: torch.Tensor,
    n: int,
    shards: int,
    degree: int,
    edge_attr: Optional[torch.Tensor] = None,
    edge_mask: Optional[torch.Tensor] = None,
) -> PartitionedEdges:
    """Shard a receiver-major uniform-degree layout (edge rows
    [i*degree, (i+1)*degree) belong to receiver i, what every kNN builder
    emits). With nodes block-sharded, rank s's edges are the rows
    [s*nl*degree, (s+1)*nl*degree): a slice, no repacking, and the positional
    layout survives, so ``EGNNSparse(shard_axis=..., uniform_degree=degree)``
    keeps its scatter-free aggregation on every rank. Receiver ids are the
    local positions; senders stay global."""
    if n % shards:
        raise ValueError(f"n={n} must divide evenly over {shards} shards")
    e = senders.shape[0]
    if e != n * degree:
        raise ValueError(f"the uniform layout needs n*degree={n * degree} edge rows, got {e}")
    nl = n // shards
    receivers = torch.arange(nl, device=senders.device).repeat_interleave(degree).repeat(shards)
    mask = torch.ones(e, dtype=torch.bool, device=senders.device) if edge_mask is None \
        else edge_mask.bool()
    return PartitionedEdges(senders=senders.long(), receivers=receivers, mask=mask,
                            edge_attr=edge_attr, capacity=nl * degree)
