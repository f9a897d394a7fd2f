"""The port's ops, re-exported under the names of ``egnn_tpu.ops`` that the
port has, so that ``from egnn_tpu_torch.ops import ...`` reads as
``from egnn_tpu.ops import ...``."""
from .core import (
    batched_index_select,
    coors_norm,
    embed_tokens,
    exists,
    fourier_encode_dist,
    gather_bool,
    gather_nodes,
    gather_rows,
    layer_norm,
    safe_div,
)
from .neighbors import (
    Neighborhood,
    expand_adjacency_degrees,
    khop_neighbor_lists,
    knn_ranking,
    knn_select,
    max_degree,
    pairwise_geometry,
    select_neighborhood,
)
from .graph import (
    EdgeSet,
    backbone_covalent_bonds,
    chain_adjacency,
    edges_from_dense_adj,
    knn_graph,
    radius_graph,
)
from .segment import (
    graph_layer_norm,
    segment_aggregate,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
    uniform_aggregate,
)
from .pairwise_stream import PairwiseParams, pairwise_block, streamed_pairwise
from .spatial import grid_knn_select

__all__ = [
    "batched_index_select",
    "exists",
    "embed_tokens",
    "gather_bool",
    "gather_nodes",
    "gather_rows",
    "coors_norm",
    "fourier_encode_dist",
    "layer_norm",
    "safe_div",
    "Neighborhood",
    "expand_adjacency_degrees",
    "khop_neighbor_lists",
    "knn_ranking",
    "max_degree",
    "pairwise_geometry",
    "select_neighborhood",
    "knn_select",
    "grid_knn_select",
    "PairwiseParams",
    "pairwise_block",
    "streamed_pairwise",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_aggregate",
    "segment_softmax",
    "graph_layer_norm",
    "uniform_aggregate",
    "EdgeSet",
    "knn_graph",
    "radius_graph",
    "backbone_covalent_bonds",
    "chain_adjacency",
    "edges_from_dense_adj",
]
