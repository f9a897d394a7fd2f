"""The benchmark's inputs, drawn on the host from the run's seed.

Each batch or request has its own stream, ``rng(seed, kind, i)``: the same
seed gives the same inputs in every run, and the i-th batch does not depend
on how many were drawn before it. The two generators are copies of the
program's synthetic data (``egnn_tpu_torch/training/data.py``:
``synthetic_chain_batch`` without its adjacency, and ``random_molecules``),
kept here so that a change to the program cannot change the yardstick.
"""
from __future__ import annotations

import numpy as np

TRAIN, SERVE, SAMPLE = 1, 2, 4   # the streams of batches, requests and the check's sample


def rng(seed: int, kind: int, i: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), kind, int(i)])


def chains(g: np.random.Generator, batch: int, n: int, num_tokens: int, noise_std: float,
           step_std: float, min_len_frac: float):
    """Random-walk chains: (tokens (b, n) int64, clean (b, n, 3) f32, noised
    (b, n, 3) f32, mask (b, n) bool). Coordinates are cumulative Gaussian
    steps, centred, plus Gaussian noise; the mask keeps a prefix of at least
    ``min_len_frac * n`` nodes."""
    tokens = g.integers(0, num_tokens, size=(batch, n))
    clean = np.cumsum(step_std * g.standard_normal((batch, n, 3)), axis=1)
    clean = clean - clean.mean(axis=1, keepdims=True)
    noised = clean + noise_std * g.standard_normal((batch, n, 3))
    lengths = g.integers(int(n * min_len_frac), n + 1, size=(batch, 1))
    mask = np.arange(n)[None, :] < lengths
    return (tokens.astype(np.int64), clean.astype(np.float32), noised.astype(np.float32),
            mask)


def molecules(g: np.random.Generator, num_graphs: int, slots: int, min_atoms: int,
              charges):
    """Random molecules of ``min_atoms`` to ``slots`` atoms: (coors (G, NA, 3)
    f32, types (G, NA) int64, mask (G, NA) bool, target (G,) f32), the target
    the Coulomb-like invariant E = sum_{i<j} q_i q_j / max(r_ij, 0.1) over the
    valid atoms."""
    G, NA = num_graphs, slots
    types = g.integers(0, len(charges), size=(G, NA))
    sizes = g.integers(min(min_atoms, NA), NA + 1, size=G)
    coors = 2.0 * g.standard_normal((G, NA, 3))
    q = np.asarray(charges)[types]
    mask = np.arange(NA)[None, :] < sizes[:, None]
    pm = mask[:, :, None] & mask[:, None, :] & ~np.eye(NA, dtype=bool)[None]
    sq = np.sum(coors ** 2, axis=-1)
    r2 = sq[:, :, None] + sq[:, None, :] - 2.0 * coors @ coors.transpose(0, 2, 1)
    r = np.sqrt(np.clip(r2, 1e-2, None))
    target = 0.5 * np.where(pm, q[:, :, None] * q[:, None, :] / r, 0.0).sum(axis=(1, 2))
    return (coors.astype(np.float32), types.astype(np.int64), mask,
            target.astype(np.float32))
