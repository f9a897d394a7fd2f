"""Graph builders of the sparse (COO) path: static-capacity edge lists.

PyTorch counterpart of ``egnn_tpu/ops/graph.py`` (the external torch-cluster
knn/radius graphs and the notebook's covalent-bond helper the reference
relies on), with the same names, layouts and tie rules. Every builder
returns an ``EdgeSet``: a fixed edge capacity, receiver-major where the
builder is kNN-based, plus a validity mask.

Selection goes through ``ops/neighbors.py:knn_select``, the route the dense
layer takes: on the card kernel K3 for graphs within the full-band reach
(16 384 nodes a graph), the large-n routes beyond it; their plain versions
on the CPU. Among equal distances the lowest node id wins, as in the JAX
package (a stable sort; ``torch.topk`` promises no tie order). Indices are
int64.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .neighbors import MASKED_RANK_FILL, knn_select

__all__ = ["EdgeSet", "knn_graph", "radius_graph_capped", "radius_graph",
           "backbone_covalent_bonds", "chain_adjacency", "edges_from_dense_adj"]


class EdgeSet(NamedTuple):
    """A static-capacity COO edge list: ``senders`` / ``receivers`` (E,)
    int64 and ``mask`` (E,) bool, False on padding rows, which point at
    node 0 so that gathers stay in bounds."""

    senders: torch.Tensor
    receivers: torch.Tensor
    mask: torch.Tensor

    @property
    def edge_index(self) -> torch.Tensor:
        """PyG's (2, E) layout: row 0 the sources j, row 1 the targets i."""
        return torch.stack([self.senders, self.receivers], dim=0)


def _batched_knn(cg, k, mg, loop):
    """(g, m, c) coordinates -> (idx (g, m, kw) within-graph ids, vals (g, m,
    kw) rankings), through ``knn_select``. ``loop=False`` selects min(k + 1,
    m) and drops the self slot of each row (or, where more than k
    exact-zero ties crowd it out, the last slot), so kw = min(k + 1, m) - 1;
    with ``loop`` kw = min(k, m). Masked pairs carry the 1e5 ranking fill."""
    m = cg.shape[1]
    if loop:
        nbhd = knn_select(cg, min(k, m), math.inf, mask=mg)
        return nbhd.indices, nbhd.ranking
    kk = min(k + 1, m)
    nbhd = knn_select(cg, kk, math.inf, mask=mg)
    idx, vals = nbhd.indices, nbhd.ranking                    # (g, m, kk)
    keep = idx != torch.arange(m, device=idx.device)[None, :, None]
    has_self = (~keep).any(dim=-1, keepdim=True)
    keep = keep & ~(~has_self & (torch.arange(kk, device=idx.device) == kk - 1))
    # exactly kk - 1 slots kept a row; keep their order
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[..., :kk - 1]
    return torch.gather(idx, -1, order), torch.gather(vals, -1, order)


def _ragged_caps(batch, max_graph_size, max_graphs):
    """(m_cap, G) of a ragged batch: the caller's caps, or the exact ones of
    ``batch``, read on the host once (the JAX package reads a concrete
    batch outside jit the same way). ``batch`` must be sorted."""
    if max_graph_size is not None and max_graphs is not None:
        return int(max_graph_size), int(max_graphs)
    bnp = batch.detach().cpu().numpy()
    if bnp.size and (np.diff(bnp) < 0).any():
        raise ValueError("knn_graph/radius_graph_capped: `batch` must be sorted "
                         "(torch-cluster convention)")
    counts = np.bincount(bnp) if bnp.size else np.asarray([0])
    m_cap = int(max_graph_size) if max_graph_size is not None else int(counts.max())
    g = int(max_graphs) if max_graphs is not None else int(counts.size)
    return max(m_cap, 1), max(g, 1)


def _ragged_knn(coors, k, node_mask, loop, batch, m_cap, G):
    """Ragged multi-graph kNN on a (G, m_cap) padded grid, without the (n, n)
    matrix (``egnn_tpu/ops/graph.py:_ragged_knn``): nodes go to slot (graph,
    position in graph), one batched selection, the winners map back to
    global ids. Nodes past the caps are dropped (their rows and edges come
    back invalid; their grid writes land in a sacrificial row and column).
    Edge validity is the selected slot's grid mask, so real pairs at squared
    distances >= 1e5 stay valid."""
    n, c = coors.shape
    dev = coors.device
    batch = batch.long()
    in_range = (batch >= 0) & (batch < G)
    counts = torch.zeros(G + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(in_range, batch, G), torch.ones_like(batch))[:G]
    starts = torch.cumsum(counts, 0) - counts
    bat_c = batch.clamp(0, G - 1)
    ar = torch.arange(n, device=dev)
    pos = ar - starts[bat_c]
    ok_node = (pos < m_cap) & (batch < G)
    if node_mask is not None:
        ok_node = ok_node & node_mask
    pos_c = pos.clamp(max=m_cap - 1)
    pos_s = torch.where(ok_node, pos_c, m_cap)
    bat_s = torch.where(ok_node, bat_c, G)

    grid_coors = torch.zeros(G + 1, m_cap + 1, c, dtype=coors.dtype, device=dev)
    grid_coors[bat_s, pos_s] = torch.where(ok_node[:, None], coors, 0.0)
    grid_mask = torch.zeros(G + 1, m_cap + 1, dtype=torch.bool, device=dev)
    grid_mask[bat_s, pos_s] = ok_node
    grid_gid = torch.zeros(G + 1, m_cap + 1, dtype=torch.int64, device=dev)
    grid_gid[bat_s, pos_s] = torch.where(ok_node, ar, 0)
    grid_coors, grid_mask, grid_gid = (grid_coors[:G, :m_cap].contiguous(),
                                       grid_mask[:G, :m_cap].contiguous(), grid_gid[:G, :m_cap])

    idx, vals = _batched_knn(grid_coors, k, grid_mask, loop)     # (G, m_cap, kw)
    gidx = torch.arange(G, device=dev)[:, None, None]
    gid = grid_gid[gidx, idx]
    sel_ok = grid_mask[gidx, idx]
    idx_n = gid[bat_c, pos_c]                                     # (n, kw)
    vals_n = vals[bat_c, pos_c]
    ok_pair = sel_ok[bat_c, pos_c] & ok_node[:, None]
    fill = torch.full((), 1e10, dtype=vals_n.dtype, device=dev)
    return idx_n, torch.where(ok_pair, vals_n, fill), fill


def _knn_indices(coors, k, node_mask, loop, batch, graph_size, max_graph_size=None,
                 max_graphs=None):
    """(idx (n, kw) global ids, vals (n, kw) rankings, fill): the selection
    the kNN builders share; a pair is a real neighbour where val < fill."""
    n = coors.shape[0]
    if batch is not None and graph_size is None:
        return _ragged_knn(coors, k, node_mask, loop, batch,
                           *_ragged_caps(batch, max_graph_size, max_graphs))
    fill = MASKED_RANK_FILL if node_mask is not None else math.inf
    if graph_size is not None:
        # a packed batch of equal graphs: each graph one row of the batched layout
        if n % graph_size:
            raise ValueError("graph_size must divide the node count")
        g, m = n // graph_size, graph_size
        idx, vals = _batched_knn(coors.reshape(g, m, -1), k,
                                 None if node_mask is None else node_mask.reshape(g, m), loop)
        base = (torch.arange(g, device=coors.device) * m)[:, None, None]
        kw = idx.shape[-1]
        idx, vals = (idx + base).reshape(n, kw), vals.reshape(n, kw)
    else:
        idx, vals = _batched_knn(coors[None], k,
                                 None if node_mask is None else node_mask[None], loop)
        idx, vals = idx[0], vals[0]
    return idx, vals, torch.full((), fill, dtype=vals.dtype, device=vals.device)


def _edge_set(idx, valid, node_mask) -> EdgeSet:
    """Receiver-major edges from (n, kw) sender ids and their validity."""
    n, kw = idx.shape
    receivers = torch.arange(n, device=idx.device).repeat_interleave(kw)
    mask = valid.reshape(-1)
    if node_mask is not None:
        mask = mask & node_mask.repeat_interleave(kw)
    zero = torch.zeros((), dtype=torch.int64, device=idx.device)
    return EdgeSet(senders=torch.where(mask, idx.reshape(-1), zero),
                   receivers=torch.where(mask, receivers, zero), mask=mask)


def knn_graph(
    coors: torch.Tensor,
    k: int,
    node_mask: Optional[torch.Tensor] = None,
    loop: bool = False,
    batch: Optional[torch.Tensor] = None,
    graph_size: Optional[int] = None,
    max_graph_size: Optional[int] = None,
    max_graphs: Optional[int] = None,
) -> EdgeSet:
    """k-nearest-neighbour edges of (n, c) coordinates: each valid node
    receives edges from its k nearest valid neighbours (squared Euclidean),
    E = n * kw edges receiver-major (all of node 0's first), kw = k (or
    m - 1 where a graph of m <= k nodes has fewer others).

    ``batch``: optional (n,) sorted graph ids; neighbours stay in their
    graph (torch-cluster's ``knn_graph(batch=...)``). A ragged batch is
    bucketed onto a (graphs, largest graph) padded grid and selected per
    graph, never through the (n, n) matrix. Its caps are read from
    ``batch`` on the host (one copy from the card) unless both
    ``max_graph_size`` and ``max_graphs`` are given. ``graph_size``: the
    node count of every graph of a packed batch (ids ``[0]*gs + [1]*gs +
    ...``), which maps onto the batched selection with no padding.
    """
    idx, vals, fill = _knn_indices(coors, k, node_mask, loop, batch, graph_size,
                                   max_graph_size, max_graphs)
    return _edge_set(idx, vals < fill, node_mask)


def radius_graph_capped(
    coors: torch.Tensor,
    radius: float,
    max_num_neighbors: int = 32,
    node_mask: Optional[torch.Tensor] = None,
    loop: bool = False,
    batch: Optional[torch.Tensor] = None,
    graph_size: Optional[int] = None,
    max_graph_size: Optional[int] = None,
    max_graphs: Optional[int] = None,
) -> EdgeSet:
    """Radius graph with a per-node cap (torch-cluster's
    ``radius_graph(r, max_num_neighbors=...)``): the kNN selection of the
    closest ``max_num_neighbors``, then the cut ``dist <= r^2``.
    Receiver-major, E = n * max_num_neighbors."""
    idx, vals, fill = _knn_indices(coors, max_num_neighbors, node_mask, loop, batch,
                                   graph_size, max_graph_size, max_graphs)
    r2 = torch.full((), radius, dtype=vals.dtype, device=vals.device) ** 2
    return _edge_set(idx, (vals <= r2) & (vals < fill), node_mask)


def _smallest(keys: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, keys) of the ``count`` smallest keys, the lowest id first among
    equal keys (``lax.top_k``'s rule on the negated keys)."""
    keys, ids = torch.sort(keys, stable=True)
    return ids[:count], keys[:count]


def radius_graph(
    coors: torch.Tensor,
    radius: float,
    max_edges: int,
    node_mask: Optional[torch.Tensor] = None,
    loop: bool = False,
) -> EdgeSet:
    """Every pair within ``radius``, packed into ``max_edges`` rows, the
    closest kept where there are more, then sorted receiver-major (padding
    last). It builds the (n, n) distance matrix and refuses n > 8192; use
    ``radius_graph_capped`` for large graphs."""
    n = coors.shape[0]
    if n > 8192:
        raise ValueError(
            f"radius_graph materializes an (N, N) distance matrix — refusing at n={n}. Use "
            f"radius_graph_capped (per-node neighbor cap, kernel-routed) for large graphs.")
    rel = coors[:, None, :] - coors[None, :, :]
    dist = (rel * rel).sum(dim=-1)
    ok = dist <= radius ** 2
    if not loop:
        ok = ok & ~torch.eye(n, dtype=torch.bool, device=coors.device)
    if node_mask is not None:
        ok = ok & (node_mask[:, None] & node_mask[None, :])
    big = torch.full((), 1e10, dtype=dist.dtype, device=dist.device)
    flat_idx, keys = _smallest(torch.where(ok, dist, big).reshape(-1), max_edges)
    mask = keys < big
    # receiver-major, padding last, as the kNN builders lay edges out
    order = torch.argsort(torch.where(mask, flat_idx, n * n), stable=True)
    flat_idx, mask = flat_idx[order], mask[order]
    zero = torch.zeros((), dtype=torch.int64, device=coors.device)
    return EdgeSet(senders=torch.where(mask, flat_idx % n, zero),
                   receivers=torch.where(mask, flat_idx // n, zero), mask=mask)


def backbone_covalent_bonds(num_residues: int, atoms_per_residue: int = 3,
                            device=None) -> EdgeSet:
    """Covalent bonds of a protein backbone of ``num_residues`` residues of
    ``atoms_per_residue`` atoms (N, CA, C): the chain within each residue and
    the peptide bond C(i) - N(i+1), both ways, receiver-major (the reference
    notebook's ``prot_covalent_bond``)."""
    a = atoms_per_residue
    src, dst = [], []
    for r in range(num_residues):
        for j in range(a - 1):
            src.append(r * a + j)
            dst.append(r * a + j + 1)
    for r in range(num_residues - 1):
        src.append(r * a + (a - 1))
        dst.append((r + 1) * a)
    dev = resolve_device(device)
    s = torch.tensor(src + dst, dtype=torch.int64, device=dev)
    d = torch.tensor(dst + src, dtype=torch.int64, device=dev)
    order = torch.argsort(d, stable=True)
    return EdgeSet(senders=s[order], receivers=d[order],
                   mask=torch.ones(s.shape, dtype=torch.bool, device=dev))


def chain_adjacency(n: int, device=None) -> torch.Tensor:
    """Chain graph i ~ i±1 (denoise_sparse.py:64-66), (n, n) bool: the
    adjacency of the reference's training example."""
    ar = torch.arange(n, device=resolve_device(device))
    return (ar[:, None] - ar[None, :]).abs() == 1


def edges_from_dense_adj(adj_mat: torch.Tensor, max_edges: int,
                         node_mask: Optional[torch.Tensor] = None) -> EdgeSet:
    """A dense (n, n) adjacency as ``max_edges`` COO rows, in row-major
    order; entries past the capacity are dropped."""
    n = adj_mat.shape[-1]
    ok = adj_mat.bool()
    if node_mask is not None:
        ok = ok & (node_mask[:, None] & node_mask[None, :])
    flat = ok.reshape(-1)
    score = torch.where(flat, torch.arange(n * n, device=adj_mat.device), n * n)
    flat_idx, keys = _smallest(score, max_edges)
    mask = keys < n * n
    zero = torch.zeros((), dtype=torch.int64, device=adj_mat.device)
    return EdgeSet(senders=torch.where(mask, flat_idx % n, zero),
                   receivers=torch.where(mask, flat_idx // n, zero), mask=mask)
