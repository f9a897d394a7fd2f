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
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device


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
