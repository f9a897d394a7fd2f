"""Spatial-grid kNN candidate pruning with an exactness certificate.

PyTorch counterpart of ``egnn_tpu/ops/spatial.py``, with the batch axis
written out. Instead of ranking all n columns of a row, rank the nodes of
the row's 3 x 3 x 3 block of grid cells:

1. bin the nodes into a gdim^3 grid with equal-mass edges per axis (the
   quantiles of a per-axis sort, so that a clustered cloud fills its cells
   evenly), each node at a slot of its cell in node order;
2. a node's candidates are the nodes of its 27 cells;
3. an exact float32 ranking of those candidates and its k smallest.

The result is certified per row, not assumed: a row is exact when its k-th
distance lies strictly inside its margin, the distance to the nearest face
of its 27-cell block that does not coincide with the bounding box (beyond
the box there is nothing); rows with fewer than k candidates, boundary ties
the selection could not order, the masked-fill regime and any cell overflow
fail. ``ops/neighbors.py`` repairs failing rows or falls back to the exact
kernels, so its results are always exact.

``assign_cells`` and ``resort_and_certify`` are shared with the
grid-blocked kernel's host side (``ops/cuda/grid_knn.py``);
``grid_knn_select`` is the plain-torch grid path that ``backend="grid"``
takes where that kernel's gate refuses the shape (n < 8192), on the card as
on the CPU. As in the selection it stands for, self is a candidate, and a
masked row returns the 1e5 fill at columns 0..k-1.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from .neighbors import MASKED_RANK_FILL, sum_of_squares

_BIG = 3.4e38  # sorts masked nodes' coordinates past every valid one


def grid_dims(n: int, occupancy: float = 8.0, m_cap: Optional[int] = None) -> tuple[int, int]:
    """(gdim, m_cap) for n nodes at the target mean cell occupancy; m_cap
    defaults to four times the mean (a Poisson tail that uniform data
    never reaches; overflow is detected, not silent, regardless)."""
    gdim = max(3, int(round((n / occupancy) ** (1.0 / 3.0))))
    if m_cap is None:
        m_cap = int(occupancy * 4)
    return gdim, max(m_cap, 1)


@functools.lru_cache(maxsize=16)
def neighbor_cells(gdim: int, device=None) -> torch.Tensor:
    """(G, 27) linear ids of each cell's 3^3 block; G marks a cell out of
    the grid. Kept for the last few (gdim, device): callers only read it."""
    g = torch.arange(gdim ** 3, device=device)
    ix, iy, iz = g // (gdim * gdim), (g // gdim) % gdim, g % gdim
    offs = torch.arange(-1, 2, device=device)
    nx = ix[:, None, None, None] + offs[:, None, None]
    ny = iy[:, None, None, None] + offs[None, :, None]
    nz = iz[:, None, None, None] + offs[None, None, :]
    inb = (nx >= 0) & (nx < gdim) & (ny >= 0) & (ny < gdim) & (nz >= 0) & (nz < gdim)
    lin = (nx * gdim + ny) * gdim + nz
    return torch.where(inb, lin, gdim ** 3).reshape(gdim ** 3, 27)


def assign_cells(c32: torch.Tensor, valid: Optional[torch.Tensor], gdim: int):
    """The grid geometry shared by the plain and the kernel grid paths.

    c32 (b, n, 3) float32, valid (b, n) bool or None for all. Returns cid
    (b, n) int64 (a masked node's is G = gdim^3), counts (b, G + 1) the
    cells' valid populations, margin (b, n) float32 the shaved distance to
    the nearest interior face of the 27-cell block, and order (b, n): the
    nodes sorted by cell and, within a cell, by node id (a stable sort),
    masked nodes last.
    """
    b, n, _ = c32.shape
    G = gdim ** 3
    dev = c32.device

    # per-axis equal-mass edges over the valid nodes: interior edges at the
    # valid ranks floor(i * nv / gdim), i = 1..gdim-1
    steps = torch.arange(1, gdim, device=dev)
    if valid is None:
        cs = torch.sort(c32, dim=1).values
        ranks = ((steps * n) // gdim).expand(b, gdim - 1)
    else:
        cs = torch.sort(torch.where(valid[..., None], c32, _BIG), dim=1).values
        ranks = ((steps[None, :] * valid.sum(dim=1, keepdim=True)) // gdim).clamp(0, n - 1)
    inner = torch.gather(cs, 1, ranks[..., None].expand(b, gdim - 1, 3))  # (b, gdim-1, 3)

    # bin index = number of interior edges <= x, compared directly
    ia = (c32[:, :, None, :] >= inner[:, None, :, :]).sum(dim=2)         # (b, n, 3)

    # Distance to the nearest face of the 27-cell block. inner[j] is face
    # j + 1: the low face ia - 1 is interior iff ia >= 2 (slot ia - 2), the
    # high face ia + 2 iff ia <= gdim - 3 (slot ia + 1); a face on or beyond
    # the bounding box bounds an empty region and counts as infinitely far.
    e_lo = torch.gather(inner, 1, (ia - 2).clamp(0, gdim - 2))
    e_hi = torch.gather(inner, 1, (ia + 1).clamp(0, gdim - 2))
    m_lo = torch.where(ia >= 2, c32 - e_lo, math.inf)
    m_hi = torch.where(ia <= gdim - 3, e_hi - c32, math.inf)
    # the binning compares are exact; the shave covers the float32 error of
    # the face subtraction, the squared distances and margin^2 (a few ulps)
    margin = torch.minimum(m_lo, m_hi).amin(dim=-1).clamp(min=0.0) * (1.0 - 1e-4)
    cid = (ia[..., 0] * gdim + ia[..., 1]) * gdim + ia[..., 2]
    if valid is not None:
        cid = torch.where(valid, cid, G)              # masked nodes -> cell G

    counts = torch.zeros(b, G + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, cid, torch.ones_like(cid) if valid is None else valid.long())
    # cell ids fit 32 bits, which halves the sort's passes
    order = torch.sort(cid.int(), dim=1, stable=True).indices
    return cid, counts, margin, order


def cell_assignment(c32: torch.Tensor, valid: Optional[torch.Tensor], gdim: int):
    """``assign_cells`` in the reference's form: (cid, pos, counts, margin)
    with pos (b, n) the node's slot within its cell, in node order."""
    cid, counts, margin, order = assign_cells(c32, valid, gdim)
    starts = counts.cumsum(dim=1) - counts
    pos_sorted = torch.arange(c32.shape[1], device=c32.device)[None, :] - torch.gather(
        starts, 1, torch.gather(cid, 1, order))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    return cid, pos, counts, margin


def resort_and_certify(vals, gid, valid, margin, n_valid_cand, cnt_le, overflow, k):
    """The shared tail of both grid paths: exact tie order, the certificate
    and the masked rows' fill.

    vals (b, n, k) float32 ascending, gid (b, n, k) their node ids, valid
    (b, n) the node mask or None without one, margin (b, n), n_valid_cand
    (b, n) the real candidates of the row's block, cnt_le (b, n) the
    candidates at or below the k-th selected distance, or None when the
    producer selected by exact (distance, id) order already (the grid
    kernel), overflow a 0-d bool tensor, or None where the caller has ruled
    it out.

    Returns (vals, idx, ok, row_exact): ``row_exact`` (b, n) marks the rows
    that are certified or masked (under ``overflow`` none is: a missing
    table entry spoils its neighbours' candidates too) and ``ok`` (0-d) is
    its conjunction. A row is certified when it has k candidates, its k-th
    distance is strictly below margin^2, no tie group straddles the k-th
    place (``cnt_le == k``) and, with a mask, its k-th distance is below the
    1e5 fill: beyond it the exact selection prefers masked pairs, which the
    grid's tables leave out.
    """
    if cnt_le is not None:
        # (distance, id) order: a stable sort by id, then by distance
        by_id = torch.sort(gid, dim=-1, stable=True)
        by_val = torch.sort(torch.gather(vals, -1, by_id.indices), dim=-1, stable=True)
        vals, gid = by_val.values, torch.gather(by_id.values, -1, by_val.indices)

    vkth = vals[..., k - 1]
    row_exact = (n_valid_cand >= k) & (vkth < margin * margin)
    if cnt_le is not None:
        row_exact = row_exact & (cnt_le == k)
    if valid is not None:
        row_exact = (row_exact & (vkth < MASKED_RANK_FILL)) | ~valid
    if overflow is not None:
        row_exact = row_exact & ~overflow
    if valid is not None:
        # masked query rows: every pair ranks at the fill, so columns 0..k-1 win
        vals = torch.where(valid[..., None], vals, MASKED_RANK_FILL)
        gid = torch.where(valid[..., None], gid, torch.arange(k, device=gid.device))
    return vals, gid, row_exact.all(), row_exact


def grid_knn_select(
    coors: torch.Tensor,                   # (b, n, 3)
    k: int,
    mask: Optional[torch.Tensor] = None,   # (b, n) bool
    occupancy: Optional[float] = None,
    m_cap: Optional[int] = None,
):
    """Grid-pruned kNN selection in plain torch.

    Returns (vals (b, n, k) float32, idx (b, n, k) int64, ok 0-d bool,
    row_exact (b, n) bool). ``ok`` certifies that the result equals the
    exact masked selection, values and tie order; otherwise the caller
    repairs the rows outside ``row_exact`` or falls back. ``occupancy``
    (mean nodes a cell) defaults to max(12, 1.5 k), which keeps the
    population of a box corner's truncated ball above k; cells hold
    ``m_cap`` = 4 x occupancy slots. A shape that cannot certify (27 m_cap
    < k, n < k, or gdim < 4, where a corner's block covers 8 of its 27
    cells) is rejected at once with the fill and ``ok`` false.
    """
    b, n, c = coors.shape
    if c != 3:
        raise ValueError("grid pruning is 3-D only; use the exact kernels otherwise")
    dev = coors.device
    if occupancy is None:
        occupancy = max(12.0, 1.5 * float(k))
    gdim, m_cap = grid_dims(n, occupancy, m_cap)
    if 27 * m_cap < k or n < k or gdim < 4:
        return (torch.full((b, n, k), MASKED_RANK_FILL, dtype=torch.float32, device=dev),
                torch.arange(k, device=dev).expand(b, n, k),
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.zeros(b, n, dtype=torch.bool, device=dev))
    G = gdim ** 3
    c32 = coors.float()
    valid = torch.ones(b, n, dtype=torch.bool, device=dev) if mask is None else mask
    bi = torch.arange(b, device=dev)[:, None]

    cid, pos, counts, margin = cell_assignment(c32, mask, gdim)
    overflow = (counts[:, :G] > m_cap).any()

    # (cell, slot) table of node ids, n for an empty slot; overflowing and
    # masked nodes go to a sacrificial slot
    ok_node = valid & (pos < m_cap)
    table = torch.full((b, G + 1, m_cap + 1), n, dtype=torch.int64, device=dev)
    table[bi, torch.where(ok_node, cid, G), torch.where(ok_node, pos, m_cap)] = torch.where(
        ok_node, torch.arange(n, device=dev)[None, :], n)
    table = table[:, :, :m_cap]
    table[:, G] = n

    # candidates: the 27 cells' slots of every node (a masked row's are
    # junk and its result is replaced by the fill)
    node_nbrs = neighbor_cells(gdim, dev)[cid.clamp(max=G - 1)]          # (b, n, 27)
    cand_gid = table[bi[..., None], node_nbrs].reshape(b, n, 27 * m_cap)
    cand_ok = cand_gid < n
    coors_pad = torch.cat([c32, c32.new_zeros(b, 1, 3)], dim=1)
    cand_xyz = coors_pad[bi[..., None], cand_gid]                        # (b, n, C, 3)
    dist = sum_of_squares(cand_xyz - c32[:, :, None, :])
    dist = torch.where(cand_ok, dist, float("inf"))

    # the k smallest, the lowest band slot first among equals (a stable
    # sort), re-sorted by (distance, id) and certified in the shared tail
    by_dist = torch.sort(dist, dim=-1, stable=True)
    vals, sel = by_dist.values[..., :k], by_dist.indices[..., :k]
    cnt_le = (dist <= vals[..., k - 1:k]).sum(dim=-1)
    return resort_and_certify(
        vals, torch.gather(cand_gid, -1, sel), mask, margin, cand_ok.sum(dim=-1), cnt_le,
        overflow, k)
