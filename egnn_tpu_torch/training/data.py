"""Synthetic chain batches: the denoising workload's inputs, and the requests
``chip_smoke.py`` serves; and the layout of a packed molecule batch.

Counterparts of ``egnn_tpu/training/data.py:synthetic_chain_batch``, with
the same shapes and distributions (random-walk 'backbone' chains,
denoise_sparse.py:48-74) drawn from a numpy ``Generator`` instead of a JAX
key, and of its ``MoleculeBatch``. The chain adjacency is
``ops/graph.py:chain_adjacency``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.graph import chain_adjacency
from ..utils.device import resolve_device


class DenoiseBatch(NamedTuple):
    tokens: torch.Tensor        # (b, n) int64
    clean_coors: torch.Tensor   # (b, n, 3)
    noised_coors: torch.Tensor  # (b, n, 3)
    mask: torch.Tensor          # (b, n) bool
    adj_mat: torch.Tensor       # (n, n) bool, chain i ~ i±1


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


class MoleculeBatch(NamedTuple):
    """A packed variable-size molecule batch in the sparse path's layout
    (x = [coors | feats], COO edges, batch vector: the PyG convention of the
    reference's sparse stack, egnn_pytorch_geometric.py:182-191)."""

    x: torch.Tensor           # (G*NA, 3+1) coordinates and a raw type column
    edge_index: torch.Tensor  # (2, G*NA*K) [senders; receivers]
    edge_mask: torch.Tensor   # (G*NA*K,) bool
    batch_ids: torch.Tensor   # (G*NA,) graph ids
    node_mask: torch.Tensor   # (G*NA,) bool
    target: torch.Tensor      # (G,) regression target
