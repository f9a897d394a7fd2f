"""egnn_tpu_torch — the PyTorch/CUDA port of egnn_tpu, for NVIDIA Hopper.

The same E(n)-equivariant graph networks as the JAX package ``egnn_tpu``
(the reference egnn-pytorch's dense path, Satorras, Hoogeboom, Welling 2021,
arXiv:2102.09844), written in PyTorch, with the TPU's Pallas kernels
replaced by kernels written by hand for the H100 (``csrc/``). Entry points
run on CUDA unless given ``device="cpu"``; on the CPU every kernel is
replaced by its plain PyTorch version.

Ported so far: the dense family, ``EGNN`` and ``EGNNNetwork``, serving and
training with kNN neighbourhoods at any n (the exact full-band selection up
to 16384 nodes, the j-tiled exact selection, the packed-key candidates and
the spatial grid beyond), also through the fused pair pipeline
(``fused_pairs``, ``fused_knn``), and over all pairs, materialised or
streamed in j-chunks (``egnn_tpu_torch.ops.pairwise_stream``), with dropout
in training mode, ``compute_dtype`` mixed precision and global linear
attention (``Attention``, ``GlobalLinearAttention``); the sparse family,
``EGNNSparse`` and
``EGNNSparseNetwork`` (with ``AttentionSparse`` and
``GlobalLinearAttentionSparse``; aliases ``EGNN_Sparse`` and
``EGNN_Sparse_Network``) over COO edges from the graph builders of
``egnn_tpu_torch.ops.graph`` (``knn_graph``, ``radius_graph_capped``, ...)
and the segment reductions, also through the fused pair pipeline
(``fused_uniform``); and the denoising train step
(``egnn_tpu_torch.training``: ``masked_mse``, ``make_fused_adam``,
``make_adam``, ``TrainState``, ``make_denoise_train_step``, as in
``egnn_tpu.training``); the host runtime and the trainers: the native C++
graph builder (``egnn_tpu_torch.native``, compiled at first use with the
host's ``g++``), protein featurization (``ops.featurize``), k-hop lists
(``ops.khop_neighbor_lists``), dataset files, ``PrefetchLoader`` and
checkpoints (``training.datasets``, ``training.data``,
``training.checkpoint``), rotations, sanitizers, timers and the H100
roofline (``utils``), weights carried from egnn-pytorch
(``utils.*_params_from_torch``), and the examples, run as modules:
``python -m egnn_tpu_torch.examples.denoise``, ``molecule_regression``,
``export_serving`` and ``migrate_from_torch`` (``--device cpu`` for the
plain PyTorch path); multi-process training (``egnn_tpu_torch.parallel``:
the process runtime, the (data, graph) mesh, the edge-partitioned sparse
layout, and in ``training`` the data-parallel dense and edge-partitioned
sparse steps, the dense step also sharded over nodes,
``parallel.shard_nodes``) and model parallelism (the ring of node blocks,
``EGNN(ring_axis=group)`` and ``training.make_ring_denoise_train_step``;
tensor parallelism of the dense and sparse MLPs, ``parallel.tp_shard_module``;
the pipeline, ``parallel.make_pipelined_apply`` / ``make_pipelined_loss``),
run by gloo ranks on the CPU and on the card. A network sharded over nodes
or by tensor parallelism runs every option of the unsharded one, dense
edges and dropout in training mode included (its masks are the
one-process call's); ``ring_axis`` refuses kNN, dense edges and dropout,
as the JAX layer does. See ROADMAP.md for what the trainers leave out.
"""

from .models.attention import Attention, GlobalLinearAttention
from .models.egnn import EGNN, EGNN_Network, EGNNNetwork
from .models.egnn_sparse import (
    EGNN_Sparse,
    EGNN_Sparse_Network,
    AttentionSparse,
    EGNNSparse,
    EGNNSparseNetwork,
    GlobalLinearAttentionSparse,
)

__version__ = "0.1.0"

__all__ = [
    "Attention",
    "GlobalLinearAttention",
    "EGNN",
    "EGNNNetwork",
    "EGNN_Network",
    "AttentionSparse",
    "EGNNSparse",
    "EGNN_Sparse",
    "EGNNSparseNetwork",
    "EGNN_Sparse_Network",
    "GlobalLinearAttentionSparse",
]
