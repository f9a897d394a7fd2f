"""Multi-process training: the counterpart of ``egnn_tpu.parallel``.

The process runtime (``distributed.py``: ``initialize``, ``is_coordinator``,
``log0``, ``sync_global_devices``, ``MetricLogger``), the (data, graph) mesh
and each rank's block of a batch (``mesh.py``), the edge-partitioned sparse
layout (``sparse_partition.py``), the differentiable collectives the
sharded modules call (``collectives.py``), and model parallelism: the ring
of node blocks for the all-pairs layer (``ring.py``, ``EGNN(ring_axis=)``),
tensor parallelism of the dense MLPs (``tp.py``) and pipeline parallelism
of a depth stack (``pipeline.py``). The data-parallel, ring and
edge-partitioned train steps are in ``egnn_tpu_torch.training``. Where the
JAX package takes a mesh axis name (``shard_axis="graph"``), the port takes
that axis's process group (``mesh.get_group("graph")``).
"""
from .distributed import MetricLogger, initialize, is_coordinator, log0, sync_global_devices
from .mesh import dense_batch_block, make_mesh, shard_nodes, sparse_node_block
from .pipeline import (make_pipelined_apply, make_pipelined_loss, pipeline_apply, pipeline_loss,
                       stack_layer_params, stage_block, to_stages)
from .ring import ring_pairwise
from .sparse_partition import PartitionedEdges, partition_edges, partition_uniform_edges
from .tp import make_tp_mesh, tp_param_sharding, tp_param_spec, tp_shard_module

__all__ = [
    "MetricLogger",
    "initialize",
    "is_coordinator",
    "log0",
    "sync_global_devices",
    "dense_batch_block",
    "make_mesh",
    "shard_nodes",
    "sparse_node_block",
    "ring_pairwise",
    "make_pipelined_apply",
    "make_pipelined_loss",
    "pipeline_apply",
    "pipeline_loss",
    "stack_layer_params",
    "stage_block",
    "to_stages",
    "PartitionedEdges",
    "partition_edges",
    "partition_uniform_edges",
    "make_tp_mesh",
    "tp_param_sharding",
    "tp_param_spec",
    "tp_shard_module",
]
