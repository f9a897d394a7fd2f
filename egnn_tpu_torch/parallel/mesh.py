"""The device mesh and each rank's block of a global batch.

The counterpart of ``egnn_tpu/parallel/mesh.py``. Axes:

- ``data``: the batch (data parallelism); gradients are summed over it;
- ``graph``: the node dimension (the dense path's node sharding, and the
  edge-partitioned sparse path's node blocks).

``data`` is outermost, as in the JAX package. torch has no sharded array,
so where the JAX package gives a ``NamedSharding`` for each input
(``dense_batch_sharding``, ``sparse_node_sharding``), the port cuts each
rank's block of the global tensor: ``dense_batch_block`` (batch on
``data``, nodes on ``graph``) and ``sparse_node_block`` (packed nodes or
edge slots on the flattened (data, graph) axes).

``shard_nodes`` sets a dense network up for the ``graph`` axis, where the
JAX package lets GSPMD split its kNN: each rank ranks its own rows against
the gathered cloud (``models/egnn.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device
from .collectives import check_group


def make_mesh(data: int = 1, graph: int = 1, device=None) -> DeviceMesh:
    """A (data, graph) mesh over the processes of the default group, which
    must number ``data * graph`` (``initialize()`` first); ``device`` says
    where the ranks compute (the card unless ``"cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call parallel.initialize() first")
    size = dist.get_world_size()
    if data * graph != size:
        raise ValueError(f"mesh size data*graph={data * graph} != process count {size}")
    return init_device_mesh(resolve_device(device).type, (data, graph),
                            mesh_dim_names=("data", "graph"))


def _block(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % count:
        raise ValueError(f"dimension {dim} of size {size} does not split into {count} blocks")
    step = size // count
    return t.narrow(dim, index * step, step)


def dense_batch_block(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a dense input (tokens or mask (b, n), coordinates
    or features (b, n, ...)): the batch split over ``data``, the nodes over
    ``graph`` (a ``model`` axis, tensor parallelism's, splits nothing)."""
    d, g = mesh.get_coordinate()
    t = _block(t, 0, d, mesh.size(0))
    nodes = mesh.mesh_dim_names[1] == "graph" and mesh.size(1) > 1
    return _block(t, 1, g, mesh.size(1)) if nodes else t


def rank_block_index(mesh_or_group) -> tuple[int, int]:
    """(this rank's index, the count of ranks) over a mesh's flattened
    (data, graph) axes, or within a process group."""
    if isinstance(mesh_or_group, DeviceMesh):
        d, g = mesh_or_group.get_coordinate()
        return d * mesh_or_group.size(1) + g, mesh_or_group.size()
    return dist.get_rank(mesh_or_group), dist.get_world_size(mesh_or_group)


def sparse_node_block(mesh_or_group, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a packed sparse input along its leading
    dimension (nodes, or the edge slots of ``partition_edges``), split over
    the mesh's flattened (data, graph) axes or a process group's ranks."""
    index, count = rank_block_index(mesh_or_group)
    return _block(t, 0, index, count)


def shard_nodes(module: torch.nn.Module, group) -> torch.nn.Module:
    """Set up a dense ``EGNNNetwork`` or ``EGNN`` (in place) to run with its
    nodes block-sharded over ``group``, a process group (the mesh's
    ``graph`` axis): every layer, attention block and the network take this
    rank's block of nodes (``dense_batch_block``) and the whole adjacency.
    A kNN layer gathers the ranks' node rows once and selects its own rows
    against them (the row-block selection); an all-pairs layer takes the
    ring over ``group``, or with dense edges (this rank's rows of them) its
    rows against the gathered nodes; global attention attends over the
    gathered nodes. Dropout in training mode draws the whole tensor's masks
    on every rank and keeps this rank's rows (``models/egnn.py``).
    ``group=None`` undoes it. Returns ``module``."""
    check_group(group, "group")
    if not hasattr(module, "node_group"):
        raise ValueError(f"{type(module).__name__} is not a dense EGNN network or layer: the "
                         "graph axis shards their nodes")
    for sub in module.modules():
        if hasattr(sub, "node_group"):
            sub.node_group = group
    return module
