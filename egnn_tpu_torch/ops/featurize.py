"""Protein featurization helpers (the GVP-derived pipeline of the reference
notebook, examples/egnn_test.ipynb cells 16-22 and the addendum cells
37-39), the counterpart of ``egnn_tpu/ops/featurize.py``.

The notebook prepares its sparse-EGNN protein inputs with helpers from a GVP
data module: a sidechainnet 14-atom cloud mask, scalar Fourier position
encodings, atom and residue id columns, and a covalent-bond edge builder with
Nth-degree adjacency labels. Here:

- the encodings (``encode_dist``, ``chain2atoms``) are torch ops that return
  tensors on the caller's device;
- the sequence topology (``scn_cloud_mask``, ``prot_covalent_bond``,
  ``encode_whole_protein``) is built on the host in numpy: shape work that
  depends on the data, done once a protein, as the native host runtime
  (``egnn_tpu_torch/native``) does for graphs. It returns arrays of static
  shape, ready to copy to the device.

Atom layout: the sidechainnet convention, 14 slots a residue,
[N, CA, C, O, CB, ...sidechain in fixed order]. The bond tables below are
standard amino-acid chemistry in that order (with PRO's ring closure CD-N);
residue ids use the alphabetical one-letter convention
``ACDEFGHIKLMNPQRSTVWY`` -> 0..19 (any fixed convention serves, since ids
only index a learned embedding).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

NUM_COORDS_PER_RES = 14

AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"
AAS2NUM: Dict[str, int] = {aa: i for i, aa in enumerate(AA_ORDER)}

# sidechain atom names per residue, in sidechainnet slot order (slots 4..13)
_SIDECHAIN_ATOMS: Dict[str, List[str]] = {
    "A": ["CB"],
    "R": ["CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "N": ["CB", "CG", "OD1", "ND2"],
    "D": ["CB", "CG", "OD1", "OD2"],
    "C": ["CB", "SG"],
    "Q": ["CB", "CG", "CD", "OE1", "NE2"],
    "E": ["CB", "CG", "CD", "OE1", "OE2"],
    "G": [],
    "H": ["CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "I": ["CB", "CG1", "CG2", "CD1"],
    "L": ["CB", "CG", "CD1", "CD2"],
    "K": ["CB", "CG", "CD", "CE", "NZ"],
    "M": ["CB", "CG", "SD", "CE"],
    "F": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "P": ["CB", "CG", "CD"],
    "S": ["CB", "OG"],
    "T": ["CB", "OG1", "CG2"],
    "W": ["CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"],
    "Y": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"],
    "V": ["CB", "CG1", "CG2"],
}

# covalent bonds between sidechain atoms (by name); backbone N-CA, CA-C, C-O
# and CA-CB are added programmatically
_SIDECHAIN_BONDS: Dict[str, List[Tuple[str, str]]] = {
    "A": [],
    "R": [("CB", "CG"), ("CG", "CD"), ("CD", "NE"), ("NE", "CZ"),
          ("CZ", "NH1"), ("CZ", "NH2")],
    "N": [("CB", "CG"), ("CG", "OD1"), ("CG", "ND2")],
    "D": [("CB", "CG"), ("CG", "OD1"), ("CG", "OD2")],
    "C": [("CB", "SG")],
    "Q": [("CB", "CG"), ("CG", "CD"), ("CD", "OE1"), ("CD", "NE2")],
    "E": [("CB", "CG"), ("CG", "CD"), ("CD", "OE1"), ("CD", "OE2")],
    "G": [],
    "H": [("CB", "CG"), ("CG", "ND1"), ("CG", "CD2"), ("ND1", "CE1"),
          ("CD2", "NE2"), ("CE1", "NE2")],
    "I": [("CB", "CG1"), ("CB", "CG2"), ("CG1", "CD1")],
    "L": [("CB", "CG"), ("CG", "CD1"), ("CG", "CD2")],
    "K": [("CB", "CG"), ("CG", "CD"), ("CD", "CE"), ("CE", "NZ")],
    "M": [("CB", "CG"), ("CG", "SD"), ("SD", "CE")],
    "F": [("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"), ("CD1", "CE1"),
          ("CD2", "CE2"), ("CE1", "CZ"), ("CE2", "CZ")],
    "P": [("CB", "CG"), ("CG", "CD"), ("CD", "N")],   # proline ring closure
    "S": [("CB", "OG")],
    "T": [("CB", "OG1"), ("CB", "CG2")],
    "W": [("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"), ("CD1", "NE1"),
          ("NE1", "CE2"), ("CD2", "CE2"), ("CD2", "CE3"), ("CE2", "CZ2"),
          ("CE3", "CZ3"), ("CZ2", "CH2"), ("CZ3", "CH2")],
    "Y": [("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"), ("CD1", "CE1"),
          ("CD2", "CE2"), ("CE1", "CZ"), ("CE2", "CZ"), ("CZ", "OH")],
    "V": [("CB", "CG1"), ("CB", "CG2")],
}

_BACKBONE = ["N", "CA", "C", "O"]


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _atom_slots(aa: str) -> Dict[str, int]:
    names = _BACKBONE + _SIDECHAIN_ATOMS[aa]
    return {nm: i for i, nm in enumerate(names)}


def atoms_per_residue(aa: str) -> int:
    """Heavy-atom count of one residue in the 14-slot scheme (GLY=4, TRP=14)."""
    return 4 + len(_SIDECHAIN_ATOMS[aa])


def scn_cloud_mask(seq: str) -> np.ndarray:
    """(L, 14) bool — which of each residue's 14 sidechainnet slots hold a
    real atom (notebook ``scn_cloud_mask``). Host-side numpy."""
    mask = np.zeros((len(seq), NUM_COORDS_PER_RES), dtype=bool)
    for i, aa in enumerate(seq):
        mask[i, : atoms_per_residue(aa)] = True
    return mask


def chain2atoms(x, num_atoms: int = NUM_COORDS_PER_RES, device=None) -> torch.Tensor:
    """Broadcast per-residue values (L, ...) to per-atom (L, num_atoms, ...)
    (notebook ``chain2atoms``). A tensor keeps its device; anything else
    becomes a tensor on ``device``."""
    x = _as_tensor(x, device)
    return x[:, None].expand((x.shape[0], num_atoms) + tuple(x.shape[1:]))


def encode_dist(x, scales: Sequence[float], include_self: bool = True,
                device=None) -> torch.Tensor:
    """Scalar Fourier encoding with explicit scales (notebook ``encode_dist``):
    ``[sin(x/s) for s] + [cos(x/s) for s] (+ x)`` -> 2*len(scales)(+1)
    channels on the last axis. A tensor keeps its device; anything else
    becomes a tensor on ``device``."""
    x = _as_tensor(x, device)[..., None]
    s = torch.tensor(list(scales), dtype=x.dtype, device=x.device)
    parts = [torch.sin(x / s), torch.cos(x / s)]
    if include_self:
        parts.append(x)
    return torch.cat(parts, dim=-1)


def aa_ids(seq: str) -> np.ndarray:
    """(L,) int32 residue-type ids (AAS2NUM convention)."""
    return np.asarray([AAS2NUM[aa] for aa in seq], dtype=np.int32)


def prot_covalent_bond(
    seq: str,
    adj_degree: int = 1,
    cloud_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Covalent-bond edges of a protein's atom cloud with Nth-degree labels
    (capability parity with the notebook's ``prot_covalent_bond``, cell 38).

    Nodes are the PRESENT atoms in cloud-compacted order (the notebook's
    ``x[cloud_mask]`` indexing). Bonds: backbone N-CA/CA-C/C-O, CA-CB, the
    per-residue sidechain topology above (incl. PRO's CD-N ring), and the
    peptide bond C(i)-N(i+1); undirected (both directions emitted).
    ``adj_degree >= 2`` labels newly reached pairs with their degree, like
    ``nth_deg_adjacency`` (cell 39; dense boolean matmul — the in-repo
    device-side analog for labeled degrees is
    ops/neighbors.expand_adjacency_degrees).

    Returns ``(edge_index (2, E) int32, edge_attr (E,) float32 degrees)`` —
    host numpy, ready for torch.as_tensor and padding to a static
    capacity (ops/graph.py:EdgeSet conventions).
    """
    if cloud_mask is None:
        cloud_mask = scn_cloud_mask(seq)
    # compacted index of each (residue, slot) among present atoms
    flat = cloud_mask.reshape(-1)
    comp = np.cumsum(flat) - 1
    comp = comp.reshape(cloud_mask.shape)
    n = int(flat.sum())

    adj = np.zeros((n, n), dtype=bool)

    def bond(i_res, a, j_res, b):
        ia = comp[i_res, a]
        jb = comp[j_res, b]
        adj[ia, jb] = True
        adj[jb, ia] = True

    for i, aa in enumerate(seq):
        slots = _atom_slots(aa)
        bond(i, slots["N"], i, slots["CA"])
        bond(i, slots["CA"], i, slots["C"])
        bond(i, slots["C"], i, slots["O"])
        if "CB" in slots:
            bond(i, slots["CA"], i, slots["CB"])
        for a, b in _SIDECHAIN_BONDS[aa]:
            bond(i, slots[a], i, slots[b])
        if i + 1 < len(seq):
            bond(i, slots["C"], i + 1, 0)  # peptide bond C(i) - N(i+1)

    # Nth-degree labels (notebook nth_deg_adjacency accumulation: newly
    # reached pairs get their degree; degree-1 pairs keep label 1)
    attr = adj.astype(np.float32)
    reach = adj.copy()
    for deg in range(2, adj_degree + 1):
        nxt = (reach.astype(np.float32) @ reach.astype(np.float32)) > 0
        new = nxt & ~(attr > 0)
        attr[new] = deg
        reach = nxt

    idx = np.argwhere(attr > 0).T.astype(np.int32)
    # receiver-major deterministic order (row = receiver second in PyG style)
    order = np.lexsort((idx[0], idx[1]))
    idx = idx[:, order]
    attrs = attr[idx[0], idx[1]].astype(np.float32)
    return idx, attrs


def encode_whole_protein(
    seq: str,
    coords: np.ndarray,
    padding_seq: int = 0,
    aa_pos_scales: Sequence[float] = (2, 4, 8, 16, 32, 64, 128),
    adj_degree: int = 1,
    bond_scales: Sequence[float] = (0.5, 1, 2),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Whole-protein node/edge featurization (notebook cell 16 pipeline).

    Args:
      seq: 1-letter sequence (possibly right-padded; see ``padding_seq``).
      coords: (L*14, 3) sidechainnet-layout coordinates.
      padding_seq: number of padded residues at the tail to drop.

    Returns ``(x, edge_index, edge_attr, info)``:
      x: (N, 3 + 2P+1 + 2) f32 — [coords | aa-position Fourier encodings |
         atom-slot id | residue-type id] for the N present atoms; the two id
         columns are integer-valued, to be consumed by EGNNSparseNetwork's
         ``embedding_nums=[14, 20]`` categorical machinery (the notebook uses
         embedding_nums=[36, 20] with its own id vocabulary).
      edge_index/edge_attr: covalent bonds with degree labels
         (``prot_covalent_bond``); ``edge_attr`` is Fourier-encodable with
         ``encode_dist(edge_attr, bond_scales)`` as the notebook does.
      info: channel bookkeeping dict.
    """
    seq_eff = seq[: len(seq) - padding_seq] if padding_seq else seq
    L = len(seq_eff)
    cloud = scn_cloud_mask(seq_eff)
    flat = cloud.reshape(-1)
    coords = np.asarray(coords, dtype=np.float32)[: L * NUM_COORDS_PER_RES]
    pos = coords[flat]

    aa_pos = encode_dist(torch.arange(L, dtype=torch.float32), aa_pos_scales).numpy()
    atom_pos = np.repeat(aa_pos, NUM_COORDS_PER_RES, axis=0)[flat]

    slot_ids = np.tile(np.arange(NUM_COORDS_PER_RES), L)[flat].astype(np.float32)
    res_ids = np.repeat(aa_ids(seq_eff), NUM_COORDS_PER_RES)[flat].astype(np.float32)

    x = np.concatenate(
        [pos, atom_pos, slot_ids[:, None], res_ids[:, None]], axis=-1
    ).astype(np.float32)

    edge_index, edge_attr = prot_covalent_bond(seq_eff, adj_degree, cloud)
    info = {
        "point_n_scalars": 2 * len(aa_pos_scales) + 1 + 2,
        "point_n_vectors": 0,
        "bond_n_scalars": 1,
        "bond_scales": tuple(bond_scales),
        "num_atoms": int(flat.sum()),
    }
    return x, edge_index, edge_attr, info
