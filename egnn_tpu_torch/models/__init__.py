from .attention import Attention, GlobalLinearAttention
from .egnn import EGNN, EGNNNetwork
from .egnn_sparse import (
    AttentionSparse,
    EGNNSparse,
    EGNNSparseNetwork,
    GlobalLinearAttentionSparse,
)

__all__ = [
    "Attention",
    "GlobalLinearAttention",
    "EGNN",
    "EGNNNetwork",
    "AttentionSparse",
    "EGNNSparse",
    "EGNNSparseNetwork",
    "GlobalLinearAttentionSparse",
]
