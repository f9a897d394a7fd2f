"""Neighbourhood selection: masked kNN ranking and adjacency-degree expansion.

PyTorch counterpart of the exact path of ``egnn_tpu/ops/neighbors.py``, with
the reference's selection rules (egnn_pytorch.py:230-268, 414-432):

- masked pairs are filled with 1e5 in the ranking,
- with an adjacency matrix, self pairs rank -1 and adjacent pairs 0, so they
  always win the top-k,
- ``only_sparse_neighbors`` sets k to the max row degree,
- neighbourhood validity is ``ranking <= valid_radius``,
- among equal rankings the lowest j wins (a stable sort; ``torch.topk``
  promises no tie order).

``knn_select_gather`` dispatches by device: a CUDA tensor goes to the
hand-written kernels of ``ops/cuda/knn.py`` (K1 with a payload, K3 without),
a CPU tensor to their plain versions. The gathered rows are differentiable
with respect to the table: the backward sums their cotangents into the
table's rows with ``ops/segment.py:batched_segment_sum`` (kernel K2 on the
card), as the JAX package's custom VJP does (``neighbors.py:727-746``);
selection is not differentiated. The JAX package's grid, packed, tiled and
window selection routes are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .segment import batched_segment_sum

MASKED_RANK_FILL = 1e5


class Neighborhood(NamedTuple):
    """Static-shape top-k neighbourhood of each node."""

    indices: torch.Tensor  # (b, n, k) int64 neighbour ids (j-dimension)
    ranking: torch.Tensor  # (b, n, k) the ranking values that won the top-k
    valid: torch.Tensor    # (b, n, k) bool: ranking <= valid_radius


def max_degree(adj_mat: torch.Tensor) -> int:
    """Max row degree of a (possibly batched) boolean adjacency
    (``int(adj_mat.float().sum(dim=-1).max().item())``, egnn_pytorch.py:249).
    A torch adjacency is always concrete, so this also stands for the JAX
    package's ``try_max_degree``."""
    return int(adj_mat.float().sum(dim=-1).max().item())


def pairwise_geometry(coors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, n, c) -> rel_coors (b, n, n, c) = x_i - x_j and squared distances
    rel_dist (b, n, n) (egnn_pytorch.py:232-233).

    The squares are summed one coordinate at a time, ((d0^2 + d1^2) + d2^2),
    which is the order the CUDA kernel rounds in: the kernel's ranking values
    then equal these bitwise.
    """
    rel_coors = coors[:, :, None, :] - coors[:, None, :, :]
    rel_dist = rel_coors[..., 0] * rel_coors[..., 0]
    for cc in range(1, coors.shape[-1]):
        rel_dist = rel_dist + rel_coors[..., cc] * rel_coors[..., cc]
    return rel_coors, rel_dist


def knn_ranking(
    rel_dist: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The (b, n, n) ranking matrix. Fill order follows the reference: the
    mask fill first, then the self -1 and adjacent 0 overrides
    (egnn_pytorch.py:238-256)."""
    ranking = rel_dist
    if mask is not None:
        rank_mask = mask[:, :, None] & mask[:, None, :]
        ranking = torch.where(rank_mask, ranking, MASKED_RANK_FILL)
    if adj_mat is not None:
        n = ranking.shape[-1]
        eye = torch.eye(n, dtype=torch.bool, device=ranking.device)
        adj = adj_mat.bool() & ~eye
        ranking = torch.where(eye, -1.0, ranking)
        ranking = torch.where(adj, 0.0, ranking)
    return ranking


def select_neighborhood(
    ranking: torch.Tensor, num_nearest: int, valid_radius: float
) -> Neighborhood:
    """The k smallest rankings of each row, lowest j first among ties
    (reference ``topk(largest=False)``, egnn_pytorch.py:258-260)."""
    vals, indices = torch.sort(ranking, dim=-1, stable=True)
    vals, indices = vals[..., :num_nearest], indices[..., :num_nearest]
    return Neighborhood(indices=indices, ranking=vals, valid=vals <= valid_radius)


def knn_select(
    coors: torch.Tensor,
    num_nearest: int,
    valid_radius: float,
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> Neighborhood:
    """Neighbour selection from coordinates: squared distances -> ranking
    fills -> the k smallest (egnn_pytorch.py:232-260). On a CUDA tensor this
    is kernel K3 (``ops/cuda/knn.py``)."""
    nbhd, _ = knn_select_gather(
        coors, num_nearest, valid_radius, mask=mask, adj_mat=adj_mat,
        backend=backend,
    )
    return nbhd


class _KnnSelectGather(torch.autograd.Function):
    """K1 (or its plain version) with the table's backward: the rows'
    cotangents summed into the table's rows at the saved indices."""

    @staticmethod
    def forward(ctx, table, coors_sg, k, mask, adj_mat):
        from .cuda import knn as knn_kernels

        vals, idx, rows = knn_kernels.knn_select_gather(
            coors_sg, k, table, mask=mask, adj_mat=adj_mat)
        ctx.mark_non_differentiable(vals, idx)
        ctx.save_for_backward(idx)
        return vals, idx, rows

    @staticmethod
    def backward(ctx, d_vals, d_idx, d_rows):
        (idx,) = ctx.saved_tensors
        b, n, k = idx.shape
        tw = d_rows.shape[-1]
        d_table = batched_segment_sum(
            d_rows.contiguous().reshape(b, n * k, tw), idx.reshape(b, n * k), n)
        return d_table, None, None, None, None


def knn_select_gather(
    coors: torch.Tensor,
    num_nearest: int,
    valid_radius: float,
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
    payload: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> tuple[Neighborhood, Optional[torch.Tensor]]:
    """Neighbour selection with an optional fused payload gather.

    Returns ``(nbhd, gathered)``. With a ``payload`` (b, n, w), ``gathered``
    is the (b, n, k, c [+1 with a mask] + w) rows of the table
    ``[coors | mask | payload]`` at the selected neighbours: the one combined
    gather the EGNN layer needs. Selection is not differentiated (``vals``
    and ``indices`` carry no gradient); the gathered rows carry gradients
    back to ``coors`` and the payload through the table, whose backward is
    a segment sum over the selected indices (kernel K2 on the card).

    Dispatch: CUDA tensor with a payload -> kernel K1, CUDA tensor without
    one -> kernel K3, CPU tensor -> their plain versions. ``backend`` is
    ``"auto"``; the JAX package's other routes are not ported and raise.
    """
    from .cuda import knn as knn_kernels

    if backend != "auto":
        raise NotImplementedError(
            f"backend={backend!r}: only the exact full-band selection is "
            "ported; the grid, packed, tiled and window routes are not")

    coors_sg = coors.detach().contiguous()
    k = num_nearest
    if payload is None:
        vals, indices = knn_kernels.knn_select(coors_sg, k, mask=mask, adj_mat=adj_mat)
        gathered = None
    else:
        parts = [coors]
        if mask is not None:
            parts.append(mask[..., None].to(coors.dtype))
        parts.append(payload.to(coors.dtype))
        table = torch.cat(parts, dim=-1)
        vals, indices, gathered = _KnnSelectGather.apply(table, coors_sg, k, mask, adj_mat)
    nbhd = Neighborhood(indices=indices, ranking=vals, valid=vals <= valid_radius)
    return nbhd, gathered


def expand_adjacency_degrees(
    adj_mat: torch.Tensor, num_adj_degrees: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nth-degree adjacency expansion with per-degree labels, exactly as
    EGNN_Network's loop (egnn_pytorch.py:420-428), quirk included: the
    reference relabels ``(nxt.float() - adj.float()).bool()``, an XOR, so
    pairs in ``adj`` that are not 2-step reachable are relabelled too; the
    expanded adjacency replaces ``adj`` and so gains self-loops."""
    adj = adj_mat.bool()
    adj_indices = adj.long()
    for ind in range(num_adj_degrees - 1):
        degree = ind + 2
        nxt = (adj.float() @ adj.float()) > 0
        new_mask = nxt ^ adj
        adj_indices = torch.where(new_mask, degree, adj_indices)
        adj = nxt
    return adj, adj_indices
