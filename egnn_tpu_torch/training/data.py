"""Synthetic chain batches: the denoising workload's inputs, and the requests
``chip_smoke.py`` serves.

Counterparts of ``egnn_tpu/ops/graph.py:chain_adjacency`` and
``egnn_tpu/training/data.py:synthetic_chain_batch`` with the same shapes and
distributions (random-walk 'backbone' chains, denoise_sparse.py:48-74),
drawn from a numpy ``Generator`` instead of a JAX key.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device


class DenoiseBatch(NamedTuple):
    tokens: torch.Tensor        # (b, n) int64
    clean_coors: torch.Tensor   # (b, n, 3)
    noised_coors: torch.Tensor  # (b, n, 3)
    mask: torch.Tensor          # (b, n) bool
    adj_mat: torch.Tensor       # (n, n) bool, chain i ~ i±1


def chain_adjacency(n: int, device=None) -> torch.Tensor:
    """Chain graph i ~ i±1 (denoise_sparse.py:64-66), (n, n) bool."""
    ar = torch.arange(n, device=resolve_device(device))
    return (ar[:, None] - ar[None, :]).abs() == 1


def synthetic_chain_batch(
    rng: np.random.Generator,
    batch: int,
    n: int,
    num_tokens: int = 21,
    noise_std: float = 1.0,
    step_std: float = 1.2,
    min_len_frac: float = 0.6,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> DenoiseBatch:
    """Random-walk chains with variable valid lengths: coordinates are
    cumulative Gaussian steps, centred, plus Gaussian noise; the mask keeps
    a random prefix of at least ``min_len_frac * n`` nodes."""
    dev = resolve_device(device)
    tokens = rng.integers(0, num_tokens, size=(batch, n))
    steps = step_std * rng.standard_normal((batch, n, 3))
    clean = np.cumsum(steps, axis=1)
    clean = clean - clean.mean(axis=1, keepdims=True)
    noised = clean + noise_std * rng.standard_normal((batch, n, 3))
    lengths = rng.integers(int(n * min_len_frac), n + 1, size=(batch, 1))
    mask = np.arange(n)[None, :] < lengths
    return DenoiseBatch(
        tokens=torch.as_tensor(tokens, dtype=torch.int64, device=dev),
        clean_coors=torch.as_tensor(clean, dtype=dtype, device=dev),
        noised_coors=torch.as_tensor(noised, dtype=dtype, device=dev),
        mask=torch.as_tensor(mask, device=dev),
        adj_mat=chain_adjacency(n, device=dev),
    )
