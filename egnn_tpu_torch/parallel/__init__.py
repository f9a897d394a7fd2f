"""Multi-process training: the counterpart of ``egnn_tpu.parallel``.

The process runtime (``distributed.py``: ``initialize``, ``is_coordinator``,
``log0``, ``sync_global_devices``, ``MetricLogger``), the (data, graph) mesh
and each rank's block of a batch (``mesh.py``), the edge-partitioned sparse
layout (``sparse_partition.py``) and the differentiable collectives the
sharded modules call (``collectives.py``). The data-parallel and the
edge-partitioned train steps are in ``egnn_tpu_torch.training``. Where the
JAX package takes a mesh axis name (``shard_axis="graph"``), the port takes
that axis's process group (``mesh.get_group("graph")``).
"""
from .distributed import MetricLogger, initialize, is_coordinator, log0, sync_global_devices
from .mesh import dense_batch_block, make_mesh, sparse_node_block
from .sparse_partition import PartitionedEdges, partition_edges, partition_uniform_edges

__all__ = [
    "MetricLogger",
    "initialize",
    "is_coordinator",
    "log0",
    "sync_global_devices",
    "dense_batch_block",
    "make_mesh",
    "sparse_node_block",
    "PartitionedEdges",
    "partition_edges",
    "partition_uniform_edges",
]
