"""The port's ops, re-exported under the names of ``egnn_tpu.ops`` that the
port has, so that ``from egnn_tpu_torch.ops import ...`` reads as
``from egnn_tpu.ops import ...``."""
from .core import (
    batched_index_select,
    coors_norm,
    fourier_encode_dist,
    gather_bool,
    gather_nodes,
    layer_norm,
    safe_div,
)
from .neighbors import (
    Neighborhood,
    expand_adjacency_degrees,
    knn_ranking,
    knn_select,
    max_degree,
    pairwise_geometry,
    select_neighborhood,
)
from .segment import segment_sum
from .spatial import grid_knn_select

__all__ = [
    "batched_index_select",
    "gather_bool",
    "gather_nodes",
    "coors_norm",
    "fourier_encode_dist",
    "layer_norm",
    "safe_div",
    "Neighborhood",
    "expand_adjacency_degrees",
    "knn_ranking",
    "max_degree",
    "pairwise_geometry",
    "select_neighborhood",
    "knn_select",
    "grid_knn_select",
    "segment_sum",
]
