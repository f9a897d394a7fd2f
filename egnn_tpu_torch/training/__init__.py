"""Training: loss, optimizers, train state and step builders, the
data-parallel, ring and edge-partitioned steps among them, and the captured
step (``state.py``), the
input pipeline (``data.py``: synthetic chain and molecule batches,
``PrefetchLoader``), dataset files (``datasets.py``) and checkpoints
(``checkpoint.py``)."""
from .checkpoint import CheckpointManager
from .data import PrefetchLoader, synthetic_chain_batch, synthetic_molecule_batch_np, to_tensors
from .state import (
    Adam,
    FusedAdam,
    TrainState,
    capture_step,
    make_adam,
    make_denoise_train_step,
    make_fused_adam,
    make_partitioned_sparse_train_step,
    make_ring_denoise_train_step,
    make_sharded_denoise_train_step,
    masked_mse,
)

__all__ = [
    "Adam",
    "CheckpointManager",
    "FusedAdam",
    "PrefetchLoader",
    "TrainState",
    "capture_step",
    "make_adam",
    "make_denoise_train_step",
    "make_fused_adam",
    "make_partitioned_sparse_train_step",
    "make_ring_denoise_train_step",
    "make_sharded_denoise_train_step",
    "masked_mse",
    "synthetic_chain_batch",
    "synthetic_molecule_batch_np",
    "to_tensors",
]
