"""Dataset files for the two trainers, the counterpart of
``egnn_tpu/training/datasets.py``:

- a BACKBONE format on disk (npz; HDF5 where ``h5py`` imports): per protein
  residue tokens, (L, 3, 3) backbone coordinates [N, CA, C] and a residue
  validity mask;
- ``BackboneDataset``: its loader and the reference's batch transform
  (denoise_sparse.py:55-68): three backbone atoms a residue, tokens and mask
  repeated x3 to atoms, chain adjacency i ~ i +- 1, additive Gaussian noise,
  as the ``DenoiseBatch`` the train step takes;
- ``make_synthetic_backbone_dataset``: writes a backbone-shaped file (a CA
  random walk at about 3.8 A a step, N and C placed along the chain), so
  that the whole file -> ``PrefetchLoader`` -> train step pipeline runs
  without sidechainnet;
- ``export_sidechainnet``: converts a sidechainnet release (an optional
  package and a download) to that format;
- ``QM9Dataset`` and ``make_synthetic_qm9_file``: molecules for the
  regression trainer.

numpy on the host by design: decoding and batch assembly run on the host's
threads (``PrefetchLoader``) while the card steps; ``data.to_tensors`` makes
tensors of a batch on request.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.graph import chain_adjacency
from .data import DenoiseBatch


def save_backbone_npz(path: str, tokens: np.ndarray, coords: np.ndarray,
                      masks: np.ndarray) -> None:
    """Write the backbone format: tokens (P, L) int, coords (P, L, 3, 3) f32
    ([N, CA, C] per residue), masks (P, L) bool."""
    tokens = np.asarray(tokens, np.int32)
    coords = np.asarray(coords, np.float32)
    masks = np.asarray(masks, bool)
    P, L = tokens.shape
    assert coords.shape == (P, L, 3, 3) and masks.shape == (P, L)
    np.savez_compressed(path, tokens=tokens, coords=coords, masks=masks)


class BackboneDataset:
    """Backbone denoising dataset over the npz/HDF5 format above."""

    def __init__(self, tokens: np.ndarray, coords: np.ndarray,
                 masks: np.ndarray):
        self.tokens = np.asarray(tokens, np.int32)
        self.coords = np.asarray(coords, np.float32)
        self.masks = np.asarray(masks, bool)
        self.num_proteins, self.seq_len = self.tokens.shape

    @classmethod
    def load(cls, path: str) -> "BackboneDataset":
        if path.endswith((".h5", ".hdf5")):
            try:
                import h5py  # optional; not part of the baked environment
            except ImportError as e:
                raise ImportError(
                    "HDF5 backbone files need h5py; use the npz format "
                    "(save_backbone_npz) in this environment"
                ) from e
            with h5py.File(path, "r") as f:
                return cls(f["tokens"][()], f["coords"][()], f["masks"][()])
        with np.load(path) as z:
            return cls(z["tokens"], z["coords"], z["masks"])

    def denoise_batch(
        self,
        rng: np.random.RandomState,
        batch: int,
        num_residues: Optional[int] = None,
        noise_std: float = 1.0,
    ) -> DenoiseBatch:
        """Sample proteins and apply the reference's batch transform
        (denoise_sparse.py:48-68): crop/pad to ``num_residues``, expand to
        per-atom tokens/mask (x3), flatten coords to (b, 3L, 3), chain
        adjacency, additive Gaussian noise on the coordinates.

        Returns numpy arrays (a ``DenoiseBatch``); ``data.to_tensors`` or
        ``PrefetchLoader`` puts them on the card.
        """

        L = num_residues or self.seq_len
        idx = rng.randint(0, self.num_proteins, size=batch)
        tok = np.zeros((batch, L), np.int32)
        crd = np.zeros((batch, L, 3, 3), np.float32)
        msk = np.zeros((batch, L), bool)
        for bi, pi in enumerate(idx):
            Lp = min(L, self.seq_len)
            start = 0
            if self.seq_len > L:
                start = rng.randint(0, self.seq_len - L + 1)
            tok[bi, :Lp] = self.tokens[pi, start:start + Lp]
            crd[bi, :Lp] = self.coords[pi, start:start + Lp]
            msk[bi, :Lp] = self.masks[pi, start:start + Lp]

        n = 3 * L
        tokens_a = np.repeat(tok, 3, axis=1)                  # (b, 3L)
        mask_a = np.repeat(msk, 3, axis=1)                    # (b, 3L)
        clean = crd.reshape(batch, n, 3)
        # center valid atoms (translation-invariant task; keeps coordinates
        # in a scale-friendly range)
        denom = np.maximum(mask_a.sum(axis=1, keepdims=True), 1)[..., None]
        center = (clean * mask_a[..., None]).sum(axis=1, keepdims=True) / denom
        clean = np.where(mask_a[..., None], clean - center, 0.0)
        noised = clean + noise_std * rng.randn(batch, n, 3).astype(np.float32)
        return DenoiseBatch(
            tokens=tokens_a,
            clean_coors=clean.astype(np.float32),
            noised_coors=noised.astype(np.float32),
            mask=mask_a,
            adj_mat=chain_adjacency(n, device="cpu").numpy(),
        )


def make_synthetic_backbone_dataset(
    path: str,
    num_proteins: int = 64,
    seq_len: int = 128,
    num_tokens: int = 21,
    seed: int = 0,
) -> str:
    """Generate and save a synthetic-but-backbone-shaped dataset file:
    CA trace as a smoothed random walk with ~3.8 A steps; N and C placed at
    ~1.46/1.52 A offsets along the local chain direction; 10% of tail
    residues masked out per protein (variable lengths)."""
    rng = np.random.RandomState(seed)
    P, L = num_proteins, seq_len
    tokens = rng.randint(0, num_tokens, size=(P, L)).astype(np.int32)

    steps = rng.randn(P, L, 3).astype(np.float32)
    # smooth the walk so it locally resembles secondary structure
    for _ in range(2):
        steps[:, 1:] = 0.6 * steps[:, 1:] + 0.4 * steps[:, :-1]
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-8
    ca = np.cumsum(3.8 * steps, axis=1)
    ca -= ca.mean(axis=1, keepdims=True)
    d = np.diff(ca, axis=1, prepend=ca[:, :1] - 3.8 * steps[:, :1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-8
    n_at = ca - 1.46 * d
    c_at = ca + 1.52 * d
    coords = np.stack([n_at, ca, c_at], axis=2).astype(np.float32)  # (P,L,3,3)

    lengths = rng.randint(int(0.9 * L), L + 1, size=P)
    masks = np.arange(L)[None, :] < lengths[:, None]
    save_backbone_npz(path, tokens, coords, masks)
    return path


# ---------------------------------------------------------------------------
# Real-data adapters (optional external packages/files; synthetic fallbacks
# keep every example runnable in zero-egress environments)
# ---------------------------------------------------------------------------

# sidechainnet one-letter amino-acid vocabulary (scn.sequence VOCAB order);
# index 20 = unknown/pad, matching the reference's num_tokens=21
# (denoise_sparse.py:24).
_SCN_AA = "ACDEFGHIKLMNPQRSTVWY"
_SCN_AA_IDX = {a: i for i, a in enumerate(_SCN_AA)}
NUM_ATOMS_PER_RESIDUE = 14  # sidechainnet crd packing (denoise_sparse.py:55)


def export_sidechainnet(
    path: str,
    casp_version: int = 12,
    thinning: int = 30,
    split: str = "train",
    max_len: Optional[int] = 600,
    max_proteins: Optional[int] = None,
) -> str:
    """Convert a sidechainnet release to the backbone npz format.

    Mirrors the reference training pipeline's data handling
    (denoise_sparse.py:34-60): load CASP{casp_version}@{thinning}, keep the
    first three backbone atoms [N, CA, C] of each residue's 14-atom block,
    carry the residue validity mask. Requires the optional ``sidechainnet``
    package (external to both frameworks); raises ImportError with a clear
    message otherwise — callers fall back to
    ``make_synthetic_backbone_dataset``.

    Returns ``path``; train with
    ``python -m egnn_tpu_torch.examples.denoise --data <path>``.
    """
    try:
        import sidechainnet as scn  # optional, not in the baked environment
    except ImportError as e:
        raise ImportError(
            "export_sidechainnet needs the optional `sidechainnet` package "
            "(pip install sidechainnet); use make_synthetic_backbone_dataset "
            "for a file-compatible synthetic fallback"
        ) from e

    data = scn.load(casp_version=casp_version, thinning=thinning)
    split_data = data[split]
    seqs = split_data["seq"]          # list[str], one-letter codes
    crds = split_data["crd"]          # list[(L*14, 3) float]
    msks = split_data["msk"]          # list[str] of '+'/'-'

    toks, coords, masks = [], [], []
    for seq, crd, msk in zip(seqs, crds, msks):
        L = len(seq)
        crd = np.asarray(crd, np.float32).reshape(L, NUM_ATOMS_PER_RESIDUE, 3)
        if max_len is not None and L > max_len:
            crd, seq, msk = crd[:max_len], seq[:max_len], msk[:max_len]
            L = max_len
        toks.append(np.asarray(
            [_SCN_AA_IDX.get(a, 20) for a in seq], np.int32))
        coords.append(crd[:, :3, :])  # [N, CA, C]
        masks.append(np.asarray([c == "+" for c in msk], bool))
        if max_proteins is not None and len(toks) >= max_proteins:
            break

    Lmax = max(t.size for t in toks)
    P = len(toks)
    tok = np.full((P, Lmax), 20, np.int32)
    crd = np.zeros((P, Lmax, 3, 3), np.float32)
    msk = np.zeros((P, Lmax), bool)
    for i, (t, c, m) in enumerate(zip(toks, coords, masks)):
        tok[i, : t.size] = t
        crd[i, : t.size] = c
        msk[i, : t.size] = m
    save_backbone_npz(path, tok, crd, msk)
    return path


class QM9Dataset:
    """QM9-style molecular regression data from an npz file: the real-data
    side of ``egnn_tpu_torch/examples/molecule_regression.py`` (anchor 5;
    the reference exercises this workload class through its PyG path,
    egnn_pytorch_geometric.py:274-439).

    Accepted npz layouts (both widespread in public QM9 dumps):
    - padded:  R (M, A, 3) positions, Z (M, A) atomic numbers (0 = padding),
      and a target vector under one of {y, U0, targets} (M,) or (M, T);
    - flat:    R (sum_N, 3), Z (sum_N,), N (M,) per-molecule atom counts,
      same target keys.

    ``batch()`` emits the padded static-capacity layout the sparse network
    consumes once packed: (G, NA) molecules, atomic numbers as embedding
    tokens; the kNN edges are then built per graph on the card
    (``ops.graph.knn_graph``).
    """

    #: QM9 element set H C N O F -> compact token ids 0..4 (+5 = padding)
    ATOMIC_NUMBERS = (1, 6, 7, 8, 9)

    def __init__(self, positions, tokens, n_atoms, targets):
        self.positions = positions    # (M, A, 3) f32, padded
        self.tokens = tokens          # (M, A) int32, 5 = padding
        self.n_atoms = n_atoms        # (M,) int32
        self.targets = targets        # (M,) f32 (single selected target)
        self.num_molecules = positions.shape[0]
        self.max_atoms = positions.shape[1]

    @classmethod
    def load(cls, path: str, target_key: Optional[str] = None,
             target_index: int = 0) -> "QM9Dataset":
        with np.load(path, allow_pickle=False) as z:
            keys = set(z.files)
            if target_key is None:
                for cand in ("y", "U0", "targets", "T"):
                    if cand in keys:
                        target_key = cand
                        break
            if target_key is None:
                raise ValueError(
                    f"no target array found in {path} (looked for y/U0/"
                    f"targets/T; available: {sorted(keys)})")
            R, Z, y = z["R"], z["Z"], z[target_key]
            if R.ndim == 2:  # flat layout
                if "N" not in keys:
                    raise ValueError("flat R (sum_N, 3) layout needs N (M,)")
                N = np.asarray(z["N"], np.int64)
                A = int(N.max())
                M = N.size
                pos = np.zeros((M, A, 3), np.float32)
                zz = np.zeros((M, A), np.int64)
                off = 0
                for i, ni in enumerate(N):
                    pos[i, :ni] = R[off:off + ni]
                    zz[i, :ni] = Z[off:off + ni]
                    off += ni
                R, Z, n_atoms = pos, zz, N.astype(np.int32)
            else:
                R = np.asarray(R, np.float32)
                Z = np.asarray(Z, np.int64)
                n_atoms = (Z > 0).sum(axis=1).astype(np.int32)
        if y.ndim > 1:
            y = y[:, target_index]
        tok = np.full(Z.shape, len(cls.ATOMIC_NUMBERS), np.int32)
        for t, an in enumerate(cls.ATOMIC_NUMBERS):
            tok[Z == an] = t
        return cls(R.astype(np.float32), tok, n_atoms,
                   np.asarray(y, np.float32))

    def normalized_targets(self):
        mu, sd = float(self.targets.mean()), float(self.targets.std() + 1e-8)
        return (self.targets - mu) / sd, mu, sd

    def batch(self, rng: np.random.RandomState, num_graphs: int,
              node_capacity: Optional[int] = None, targets=None):
        """Sample molecules into the packed layout: returns (coors (G, NA, 3),
        tokens (G, NA) int32, node_mask (G, NA) bool, y (G,) f32). Molecules
        larger than ``node_capacity`` are cropped (rare in QM9: max 29)."""
        NA = node_capacity or self.max_atoms
        y_src = self.targets if targets is None else targets
        idx = rng.randint(0, self.num_molecules, size=num_graphs)
        coors = np.zeros((num_graphs, NA, 3), np.float32)
        tok = np.full((num_graphs, NA), len(self.ATOMIC_NUMBERS), np.int32)
        mask = np.zeros((num_graphs, NA), bool)
        for g, mi in enumerate(idx):
            ni = min(int(self.n_atoms[mi]), NA)
            coors[g, :ni] = self.positions[mi, :ni]
            tok[g, :ni] = self.tokens[mi, :ni]
            mask[g, :ni] = True
        return coors, tok, mask, y_src[idx].astype(np.float32)


def make_synthetic_qm9_file(path: str, num_molecules: int = 512,
                            max_atoms: int = 24, seed: int = 0) -> str:
    """Write a QM9-format npz (padded layout) with synthetic molecules and a
    Coulomb-like invariant target, so the --qm9 pipeline runs end-to-end
    without the external dataset."""
    rng = np.random.RandomState(seed)
    M, A = num_molecules, max_atoms
    n_atoms = rng.randint(8, A + 1, size=M)
    R = np.zeros((M, A, 3), np.float32)
    Z = np.zeros((M, A), np.int64)
    zs = np.asarray(QM9Dataset.ATOMIC_NUMBERS)
    y = np.zeros((M,), np.float32)
    for i, ni in enumerate(n_atoms):
        pos = 1.5 * rng.randn(ni, 3).astype(np.float32)
        zi = zs[rng.randint(0, len(zs), size=ni)]
        R[i, :ni] = pos
        Z[i, :ni] = zi
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        q = zi.astype(np.float32)
        iu = np.triu_indices(ni, k=1)
        y[i] = (q[iu[0]] * q[iu[1]] / np.maximum(d[iu], 0.5)).sum()
    np.savez_compressed(path, R=R, Z=Z, y=y)
    return path
