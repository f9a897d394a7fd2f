"""Training: loss, optimizers, train state and step builders
(``state.py``), and synthetic chain batches (``data.py``)."""
from .state import (
    Adam,
    FusedAdam,
    TrainState,
    make_adam,
    make_denoise_train_step,
    make_fused_adam,
    masked_mse,
)

__all__ = [
    "Adam",
    "FusedAdam",
    "TrainState",
    "make_adam",
    "make_denoise_train_step",
    "make_fused_adam",
    "masked_mse",
]
