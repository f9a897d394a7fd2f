"""The kNN selection kernels K1, K3, K4, K5, K6, K8, K9, their plain PyTorch
versions and the reference's routing gates. Launches count into ``LAUNCH_COUNTS``
(``ops/cuda``).

- K1 ``knn_select_gather`` replaces the TPU kernel
  ``egnn_tpu/ops/pallas/knn.py:knn_select_gather_pallas``
  (``_knn_gather_kernel``).
- K3 ``knn_select`` replaces ``egnn_tpu/ops/pallas/knn.py:knn_select_pallas``
  (``_knn_kernel``).
- K4 ``knn_select_tiled`` replaces
  ``egnn_tpu/ops/pallas/knn.py:knn_select_pallas_tiled``
  (``_knn_tiled_kernel``): K3's selection at any n.
- K5 ``knn_candidates_packed_tiled`` replaces
  ``egnn_tpu/ops/pallas/knn.py:knn_candidates_packed_tiled``
  (``_knn_packed_tiled_kernel``): the kc smallest columns by (20-bit
  truncated distance key, column).
- K6 ``knn_candidates_packed`` replaces
  ``egnn_tpu/ops/pallas/knn.py:knn_candidates_packed``
  (``_knn_packed_kernel``): the same with 18-bit keys.
- K8 ``knn_select_queries`` replaces
  ``egnn_tpu/ops/pallas/knn.py:knn_select_queries_pallas``
  (``_knn_query_kernel``): K4's selection for a subset of query rows, the
  grid route's repair engine.
- K9 ``knn_select_window`` replaces
  ``egnn_tpu/ops/pallas/knn.py:knn_select_window_pallas``
  (``_knn_window_kernel``): the same against a window of the points sorted
  by x, with a margin per row that certifies it.

All seven run ``csrc/knn_select_large.cu``: one template that ranks several
rows a warp, with the ranking key its parameter, and for K1, K3, K8 and K9,
whose rows are few, several warps a row where one would leave the card
half empty (K8, K9: the query rows, K9 each group of rows against its
window of the columns; K1: the winners' payload rows copied at the end).
``knn_select_block_model`` is its traversal on the CPU, and the source's
header says what bounds each kernel on the card and how the design meets
that. A wrapper given a CUDA tensor launches its kernel
or raises; given a CPU tensor it runs the plain version, which the tests
hold against the JAX package and ``chip_smoke.py`` holds the kernel against
on the card. The plain versions take a ``row_chunk`` so that no (n, n)
matrix is ever whole in memory at large n.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import neighbors as nb
from ..core import gather_nodes
from . import LAUNCH_COUNTS, build
from . import raise_on_launch_error as _raise_on

MAX_K = 128       # longest top-k (and candidate) list the kernels keep
MAX_C = 16        # kMaxC in csrc/knn_select_large.cu


# ---------------------------------------------------------------------------
# the reference's routing rules
# ---------------------------------------------------------------------------
# These gates are copies of the TPU kernels' VMEM and bit-packing limits
# (egnn_tpu/ops/pallas/knn.py:82-89, :1146-1160, :1365-1384, :1455-1467),
# as pure functions of the shape. The card needs none of them: they are kept
# because they decide which route ``ops/neighbors.py:knn_select_gather``
# takes, and with it the shape of its result (k slots or kc slots).

LANE = 128
FULL_BAND_MAX_N = 16384              # lane-padded n the full-band kernels reach
PACKED_MASK_SENTINEL = 0x1FF00       # K6: above every real 18-bit key
PACKED_MASK_SENTINEL_TILED = 0x7F800  # K5: above every real 20-bit key
_PACKED_SHIFT, _PACKED_TILED_SHIFT = 14, 12
_TILED_MAX_TJ, _TILED_MAX_NJ, _TILED_MAX_KC = 4096, 64, 32


def _lane_pad(n: int) -> int:
    return -(-n // LANE) * LANE


def supports_knn_shapes(n: int) -> bool:
    """Whether the reference's full-band kernels (K1, K3, K6) take this n."""
    return _lane_pad(n) <= FULL_BAND_MAX_N


def supports_knn_gather(n: int, tw: int, k: int) -> bool:
    """The reference's gate of its fused select-and-gather kernel (K1,
    ``egnn_tpu/ops/pallas/knn.py:321-337``): the TPU's VMEM model of the
    ranking band, the payload table in three bf16 planes, the coordinate
    planes and the output block against 14 MB."""
    n_pad, tw_pad, ktw_pad = _lane_pad(n), _lane_pad(tw), _lane_pad(k * tw)
    used = (2 * LANE * n_pad * 4 + n_pad * tw_pad * 6 + 2 * n_pad * LANE * 4
            + LANE * ktw_pad * 4)
    return used <= 14 * 1024 * 1024


def supports_knn_packed(n: int, kc: int) -> bool:
    """The reference's gate of K6: the column must fit 14 bits."""
    return (LANE <= n <= (1 << _PACKED_SHIFT) and 1 <= kc <= LANE
            and supports_knn_shapes(n))


def _packed_tiled_tj(n: int, tj: int = _TILED_MAX_TJ) -> Optional[int]:
    """The reference's j-tile width at lane-padded ``n``: a power of two
    that divides n with n / tj <= 64 and tj <= 4096, or None when there is
    none (n whose odd part exceeds 64)."""
    tj = min(tj, n, _TILED_MAX_TJ)
    while n % tj:
        tj //= 2
    while n % (2 * tj) == 0 and n // tj > _TILED_MAX_NJ and tj < _TILED_MAX_TJ:
        tj *= 2
    if n % tj or n // tj > _TILED_MAX_NJ:
        return None
    return tj


def supports_knn_packed_tiled(n: int, kc: int) -> bool:
    """The reference's gate of K5."""
    return (n >= LANE and 1 <= kc <= _TILED_MAX_KC
            and _packed_tiled_tj(_lane_pad(n)) is not None)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _row_chunks(n: int, row_chunk: Optional[int], rows: Optional[tuple[int, int]] = None):
    """Slices of ``row_chunk`` rows over the rows r0 .. r0 + R - 1 of
    ``rows = (r0, R)``, or over all n."""
    r0, count = _row_block(n, rows)
    step = count if row_chunk is None else max(1, row_chunk)
    return [slice(i, min(i + step, r0 + count)) for i in range(r0, r0 + count, step)]


def _row_block(n: int, rows: Optional[tuple[int, int]]) -> tuple[int, int]:
    """(r0, R) of a row block of the n points: all of them by default."""
    if rows is None:
        return 0, n
    r0, count = int(rows[0]), int(rows[1])
    if not (0 <= r0 and 1 <= count and r0 + count <= n):
        raise ValueError(f"a row block (r0, R) lies in the {n} points; got ({r0}, {count})")
    return r0, count


def _default_row_chunk(b: int, n: int) -> int:
    """Rows per chunk that keep a chunk's (b, rows, n) matrix at 2^24
    elements."""
    return max(1, min(n, (1 << 24) // max(1, b * n)))


def _ranking_rows(coors, rows: slice, mask, adj_mat):
    """The (b, r, n) ranking of the query rows ``rows`` against every column,
    with the fills of ``ops/neighbors.py:knn_ranking`` in its order."""
    n = coors.shape[1]
    ranking = nb.sum_of_squares(coors[:, rows, None, :] - coors[:, None, :, :])
    if mask is not None:
        ranking = torch.where(mask[:, rows, None] & mask[:, None, :], ranking,
                              nb.MASKED_RANK_FILL)
    if adj_mat is not None:
        ar = torch.arange(n, device=coors.device)
        eye = ar[rows, None] == ar[None, :]
        ranking = torch.where(eye, -1.0, ranking)
        ranking = torch.where(adj_mat[:, rows].bool() & ~eye, 0.0, ranking)
    return ranking


def knn_select_plain(coors, k, mask=None, adj_mat=None, row_chunk: Optional[int] = None,
                     rows: Optional[tuple[int, int]] = None):
    """(vals, idx), each (b, n, k): the k smallest rankings per row, lowest
    j first among ties (a stable sort), ``row_chunk`` rows at a time; with
    ``rows = (r0, R)`` the rows r0 .. r0 + R - 1 alone, (b, R, k)."""
    parts = [nb.select_neighborhood(_ranking_rows(coors, chunk, mask, adj_mat), k, math.inf)
             for chunk in _row_chunks(coors.shape[1], row_chunk, rows)]
    return (torch.cat([p.ranking for p in parts], dim=1),
            torch.cat([p.indices for p in parts], dim=1))


def knn_select_gather_plain(coors, k, table, mask=None, adj_mat=None,
                            rows: Optional[tuple[int, int]] = None):
    """(vals, idx, rows): ``knn_select_plain`` plus the (b, n or R, k, tw)
    rows of the whole ``table`` at the winners."""
    vals, idx = knn_select_plain(coors, k, mask, adj_mat, rows=rows)
    return vals, idx, gather_nodes(table, idx)


def _candidates_plain(coors, kc, mask, shift, sentinel, row_chunk):
    b, n, _ = coors.shape
    if not 1 <= kc <= n:
        raise ValueError(f"candidates need 1 <= kc <= n; got kc={kc}, n={n}")
    coors = coors.float()
    col = torch.arange(n, dtype=torch.int64, device=coors.device)
    keys, cols = [], []
    for rows in _row_chunks(n, row_chunk):
        dist = nb.sum_of_squares(coors[:, rows, None, :] - coors[:, None, :, :])
        key = (dist.contiguous().view(torch.int32) >> shift).to(torch.int64)
        if mask is not None:
            key = torch.where(mask[:, rows, None] & mask[:, None, :], key, sentinel)
        # (key << 32) | col is distinct for every column of a row, so topk's
        # unspecified order among equal values cannot show
        top = torch.topk((key << 32) | col, kc, dim=-1, largest=False, sorted=True).values
        keys.append((top >> 32).to(torch.int32))
        cols.append(top & 0xFFFFFFFF)
    return torch.cat(keys, dim=1), torch.cat(cols, dim=1)


def knn_candidates_packed_tiled_plain(coors, kc, mask=None, row_chunk: Optional[int] = None):
    """(keys int32, cols int64), each (b, n, kc): the kc smallest columns of
    every row by (f32 bits of the squared distance >> 12, column); a masked
    pair's key is ``PACKED_MASK_SENTINEL_TILED``."""
    return _candidates_plain(coors, kc, mask, _PACKED_TILED_SHIFT,
                             PACKED_MASK_SENTINEL_TILED, row_chunk)


def knn_candidates_packed_plain(coors, kc, mask=None, row_chunk: Optional[int] = None):
    """The same with the 18-bit key (bits >> 14) and ``PACKED_MASK_SENTINEL``."""
    return _candidates_plain(coors, kc, mask, _PACKED_SHIFT, PACKED_MASK_SENTINEL,
                             row_chunk)


def knn_select_queries_plain(queries, points, k, q_mask=None, p_mask=None,
                             row_chunk: Optional[int] = None):
    """(vals float32, idx int64), each (b, R, k): for every query row the k
    smallest float32 squared distances to the n points, 1e5 where
    ``q_mask_i & p_mask_j`` fails, lowest column first among ties."""
    queries, points = queries.float(), points.float()
    vals, idx = [], []
    for rows in _row_chunks(queries.shape[1], row_chunk):
        ranking = nb.sum_of_squares(queries[:, rows, None, :] - points[:, None, :, :])
        if q_mask is not None:
            ranking = torch.where(q_mask[:, rows, None] & p_mask[:, None, :], ranking,
                                  nb.MASKED_RANK_FILL)
        part = nb.select_neighborhood(ranking, k, math.inf)
        vals.append(part.ranking)
        idx.append(part.indices)
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


# ---------------------------------------------------------------------------
# the traversal of the selection kernels on the card, as a CPU model
# ---------------------------------------------------------------------------
# csrc/knn_select_large.cu:knn_select_block_kernel ranks `rows` rows a warp,
# `stripes` warps a row, 8 warps a block, over tiles of 2048 columns (1024
# for K9's windows, 512 at c != 3); in each step lane l takes the columns
# t0 + 4l .. t0 + 4l + 3 of the tile, and the warp takes the insertion path
# only when one of its pairs is below its row's k-th value.

BLOCK_WARPS = 8      # kWarps
BLOCK_RUN = 4        # kRun: consecutive columns a lane ranks a step


def block_tile(c: int, window: bool = False) -> int:
    """Columns a tile (``block_tile``): 2048 at c = 3 (1024 for K9's
    windows, whose tiles carry the ids too), else 512."""
    if c != 3:
        return 512
    return 1024 if window else 2048


_I64_MIN, _I64_MAX = torch.iinfo(torch.int64).min, torch.iinfo(torch.int64).max


def _u32(t):
    """The 32 bits of an int32 or float32 tensor as an int64 in [0, 2^32)."""
    return t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _as_i32(u):
    """An int64 in [0, 2^32) as the int32 of the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _row_thresholds(tau, shift, fill_key):
    """(thr float32, mthr int64) of each row from its k-th packed value, as
    ``csrc/knn_select_large.cu:row_thresholds``: an unmasked pair below tau
    has ``!(v > thr)``; a masked pair is below tau exactly when the low word
    of its packed value is below mthr."""
    hi = (tau >> 32) + (1 << 31)
    lo = tau & 0xFFFFFFFF
    if shift == 0:
        bits = torch.where(hi >= 1 << 31, hi ^ 0x80000000, hi ^ 0xFFFFFFFF)
    else:
        bits = torch.where(hi > (0x7F7FFFFF >> shift), 0x7FFFFFFF,
                           (hi << shift) | ((1 << shift) - 1))
    thr = _as_i32(bits).view(torch.float32)
    mthr = torch.where(hi > fill_key, 0xFFFFFFFF, torch.where(hi == fill_key, lo, 0))
    return thr, mthr


def knn_select_block_model(coors, k, mask=None, adj_mat=None, shift: int = 0, rows: int = 4,
                           tile: Optional[int] = None, queries=None, q_mask=None,
                           stripes: int = 1, window=None, table=None,
                           row_block: Optional[tuple[int, int]] = None):
    """The traversal of ``knn_select_block_kernel`` in torch: K3 and K4
    (``shift`` 0, (vals float32, idx int64)), K5 (12) or K6 (14) ((keys
    int32, cols int64)), each (b, n, k), and the counts of the run; with
    ``table`` (b, n, tw), K1: the winners' rows (b, n, k, tw) before the
    counts; with ``queries`` (b, R, c) and their mask ``q_mask``, K8: the
    query rows against the points, (vals, idx) each (b, R, k); with
    ``queries`` and ``window`` = (starts (b, groups), ti, W, ids (b, n)),
    K9: every query row, unmasked, against the columns [start, min(start +
    W, n)) of its group of ti rows (``mask`` the columns'), ranked and
    reported by the columns' ids. With ``row_block = (r0, R)`` (K1, K3, K4),
    the points' rows r0 .. r0 + R - 1 alone, each with its global id's mask
    bit, adjacency row and self column: (b, R, k).

    It takes the kernel's steps: ``rows`` rows a warp and 8 warps a block
    (rows past the last in the last block rank nothing), ``stripes`` warps a
    group of rows (warp s of a group takes the steps s, s + stripes, ... of
    every tile into lists of its own), tiles of ``tile`` columns from the
    block's first column (the kernel's ``block_tile`` by default; +inf
    coordinates, and K9 the id ~0, past the last column; K9 ranks first the
    tile that holds the block's first row by x, then the tiles after it,
    then those before it downwards), in each step lane
    l's columns t0 + 4l + q, the pre-test of every pair against its row's
    thresholds (``_row_thresholds``; a masked row tests only its columns, a
    row's self and adjacent columns always pass), one vote a warp, then for
    each row that a lane flagged the lanes' offers of their packed values
    ``(key << 32) | j`` (K9: ``| id``; ordered here as a signed int64),
    column q by column q, each a merge into the row's ascending list, and
    the row's new thresholds; at the end, with stripes, the group's first
    warp merges the others' lists into its own, and K1 copies float f of a
    row's k * tw from float f % tw of winner f / tw. The counts: warp steps
    (``steps``), those that took the insertion path (``votes``) and list
    merges (``merges``)."""
    b, n, c = coors.shape
    x = coors.float()
    dev = x.device
    if queries is None and (q_mask is not None or window is not None):
        raise ValueError("q_mask and window come with the query rows")
    if queries is not None and (adj_mat is not None or table is not None
                                or row_block is not None):
        raise ValueError("the query rows take no adjacency, no payload and no row block")
    if (BLOCK_WARPS // stripes) * stripes != BLOCK_WARPS:
        raise ValueError(f"stripes must divide {BLOCK_WARPS}; got {stripes}")
    r0, nq = _row_block(n, row_block)
    xq = x[:, r0:r0 + nq] if queries is None else queries.float()
    nq = xq.shape[1]
    tile = block_tile(c, window is not None) if tile is None else tile
    per_block = BLOCK_WARPS // stripes * rows
    n_rows = -(-nq // per_block) * per_block
    ar = torch.arange(n_rows, device=dev)
    live = ar < nq
    xi = torch.zeros(b, n_rows, c, dtype=torch.float32, device=dev)
    xi[:, :nq] = xq
    mask_i = torch.ones(b, n_rows, dtype=torch.bool, device=dev)
    if mask is not None and window is None:
        mask_i[:, :nq] = mask[:, r0:r0 + nq] if queries is None else q_mask
    # each row's columns, [start, start + length) of the points (one row of
    # each broadcasts over all rows but K9's); K9: their ids
    bi = torch.arange(b, device=dev)[:, None, None]
    start = torch.zeros(1, 1, dtype=torch.int64, device=dev)
    length = torch.full((1, 1), n, dtype=torch.int64, device=dev)
    ids = None
    first = torch.zeros(1, 1, dtype=torch.int64, device=dev)  # the tile ranked first
    if window is not None:
        starts, ti, width, ids = window
        if ti % per_block:
            raise ValueError(f"a block's {per_block} rows must divide the window's {ti} rows")
        block0 = ar // per_block * per_block                            # the block's first row
        start = starts.long()[:, block0 // ti]                            # (b, n_rows)
        length = (n - start).clamp(max=width)
        ids = ids.long()
        first = torch.zeros_like(start)
        # the tile that holds the block's first row by x, ranked first: the
        # tiles after the first (the block's thread t + 1 tests tile t + 1)
        # whose first column's x is not above the row's
        for t in range(1, min(BLOCK_WARPS * 32 + 1, -(-width // tile))):
            col = start + t * tile
            x_first = x[bi[..., 0], col.clamp(max=n - 1), 0]
            first += (col < start + length) & (x_first <= xi[bi[..., 0], block0, 0])
    ntiles = -(-length // tile)
    # the lists of each row, one a stripe
    lists = torch.full((b, n_rows, stripes, k), _I64_MAX, dtype=torch.int64, device=dev)
    sentinel = {12: PACKED_MASK_SENTINEL_TILED, 14: PACKED_MASK_SENTINEL}.get(shift)
    fill_key = int(_u32(torch.tensor(nb.MASKED_RANK_FILL, dtype=torch.float32))) ^ 0x80000000 \
        if shift == 0 else sentinel
    thr, mthr = _row_thresholds(lists[..., k - 1], shift, fill_key)
    steps = votes = 0
    for visit in range(int(ntiles.max())):
        # the block's tile of this visit: its first, the tiles after it, then
        # those before it downwards
        j0 = torch.where(visit < ntiles - first, first + visit, ntiles - 1 - visit) * tile
        span = torch.where(visit < ntiles, (length - j0).clamp(0, tile), 0)
        for t0 in range(0, tile, 32 * BLOCK_RUN):
            taken = t0 < span                  # the blocks that take the step
            if not bool(taken.any()):
                break
            s = t0 // (32 * BLOCK_RUN) % stripes                      # the warp of the step
            rel = (j0 + t0)[..., None] + torch.arange(32 * BLOCK_RUN, device=dev)  # 4l + q
            cols = start[..., None] + rel
            valid = rel < length[..., None]
            cj = cols.clamp(max=n - 1)
            xj = torch.where(valid[..., None], x[bi, cj], math.inf)
            v = nb.sum_of_squares(xi[:, :, None, :] - xj)              # (b, rows, 128)
            masked = torch.zeros_like(v, dtype=torch.bool)
            if mask is not None:
                masked = ~(mask_i[:, :, None] & mask[bi, cj] & valid)
            special = torch.zeros_like(masked)
            fv = torch.where(masked, nb.MASKED_RANK_FILL, v)
            if adj_mat is not None:
                eye = (ar + r0)[:, None] == cols[0]
                a = torch.zeros_like(special)
                a[:, :nq] = adj_mat[:, r0:r0 + nq][:, :, cj[0, 0]].bool() & valid[0]
                special = eye | a
                fv = torch.where(eye, -1.0, torch.where(a, 0.0, fv))
            # the low words of the packed values: the columns, K9 their ids
            lo = cols if ids is None else torch.where(valid, ids[bi, cj], 0xFFFFFFFF)
            # the pre-test of every pair, per lane (its four columns) and row
            thr_s, mthr_s = thr[..., s, None], mthr[..., s, None]
            below = torch.where(masked, lo < mthr_s, ~(v > thr_s))
            below = torch.where(mask_i[..., None], below, (cols // BLOCK_RUN * BLOCK_RUN) < mthr_s)
            lane_flag = (below | special).reshape(b, n_rows, 32, BLOCK_RUN).any(dim=-1)
            lane_flag = lane_flag & live[:, None] & taken[..., None]
            vote = lane_flag.any(dim=-1).view(b, -1, rows).any(dim=-1)
            steps += int(taken.expand(b, n_rows).reshape(b, -1, rows)[..., 0].sum())
            votes += int(vote.sum())
            if shift == 0:
                u = _u32(fv)
                hi = torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u ^ 0x80000000)
            else:
                hi = torch.where(masked, sentinel, _u32(v) >> shift)
            p = ((hi - (1 << 31)) << 32) | lo
            offered = lane_flag.repeat_interleave(BLOCK_RUN, dim=-1) & valid
            lst = lists[:, :, s]
            for q in range(BLOCK_RUN):  # the warp's offers of column q, lanes in order
                offer = torch.where(offered[..., q::BLOCK_RUN], p[..., q::BLOCK_RUN], _I64_MAX)
                lst = torch.sort(torch.cat([lst, offer], dim=-1), dim=-1).values[..., :k]
            lists[:, :, s] = lst
            thr, mthr = _row_thresholds(lists[..., k - 1], shift, fill_key)
    # the stripes' lists merged (the union's top k)
    lists = torch.sort(lists.flatten(2), dim=-1).values[:, :nq, :k]
    hi = (lists >> 32) + (1 << 31)
    lo = lists & 0xFFFFFFFF
    counts = {"steps": steps, "votes": votes, "merges": b * n_rows * (stripes - 1)}
    if shift != 0:
        return _as_i32(hi), lo, counts
    bits = torch.where(hi >= 1 << 31, hi ^ 0x80000000, hi ^ 0xFFFFFFFF)
    vals = _as_i32(bits).view(torch.float32)
    if table is None:
        return vals, lo, counts
    tw = table.shape[-1]
    f = torch.arange(k * tw, device=dev)
    src = (lo[..., f // tw] * tw + f % tw).reshape(b, -1)
    rows_out = torch.gather(table.reshape(b, n * tw), 1, src).view(b, nq, k, tw)
    return vals, lo, rows_out, counts


def _pick_ti_window(W: int, n_pad: int, R: int) -> int:
    """The reference's group height of the windowed kernel
    (``egnn_tpu/ops/pallas/knn.py:674``): the rows of a group share one
    window. Its VMEM term is the TPU's; it is kept because the group decides
    each row's window, and with it the margin that is part of the result."""
    ti = LANE
    while ti > 8 and 2 * ti * W * 4 + 10 * n_pad * 4 > 9 * 1024 * 1024:
        ti //= 2
    while ti > 8 and n_pad * ti > (R * W) // 4:
        ti //= 2
    return ti


def _window_plan(queries, ranks, points_sorted, k, W, p_mask_sorted):
    """(ti, starts (b, groups) int64, margin (b, R) float32) of a windowed
    selection, by the reference's rule (``knn.py:771-773``, ``:810-829``):
    a group's window is centred on its middle row's x-rank, clipped into
    the lane-padded array and aligned down to 128. A row's margin is its
    x-distance to the nearer end of the window, infinite where that end is
    the end of the valid points, shaved by 1e-4: every point outside the
    window is at least that far away."""
    b, R, _ = queries.shape
    n = points_sorted.shape[1]
    n_pad = _lane_pad(n)
    if W % LANE or not LANE <= W <= n_pad or W - (n_pad - n) < k:
        raise ValueError(f"the window must be a multiple of {LANE} within the lane-padded n "
                         f"and hold k real columns wherever it lies; got W={W}, n={n}, k={k}")
    dev = queries.device
    ti = _pick_ti_window(W, n_pad, R)
    groups = -(-R // ti)
    mid = ranks.long()[:, (ti // 2 + ti * torch.arange(groups, device=dev)).clamp(max=R - 1)]
    starts = (mid - W // 2).clamp(0, n_pad - W) // LANE * LANE               # (b, groups)
    x_sorted = points_sorted[..., 0].float()
    x_lo = torch.gather(x_sorted, 1, starts)
    x_hi = torch.gather(x_sorted, 1, (starts + (W - 1)).clamp(max=n - 1))
    nv = n if p_mask_sorted is None else p_mask_sorted.sum(dim=1, keepdim=True)

    def per_row(group_values):
        return group_values.repeat_interleave(ti, dim=1)[:, :R]

    qx = queries[..., 0].float()
    m_lo = torch.where(per_row(starts == 0), math.inf, qx - per_row(x_lo))
    m_hi = torch.where(per_row(starts + W >= nv), math.inf, per_row(x_hi) - qx)
    margin = torch.minimum(m_lo, m_hi).clamp(min=0.0) * (1.0 - 1e-4)
    return ti, starts, margin


def _window_select_plain(queries, points_sorted, orig_ids, k, W, p_mask_sorted, ti, starts,
                         row_chunk):
    b, R, _ = queries.shape
    n = points_sorted.shape[1]
    dev = queries.device
    queries, points_sorted = queries.float(), points_sorted.float()
    bi = torch.arange(b, device=dev)[:, None, None]
    row_start = starts.repeat_interleave(ti, dim=1)[:, :R]
    empty = torch.iinfo(torch.int64).max
    vals, idx = [], []
    for rows in _row_chunks(R, row_chunk):
        cols = row_start[:, rows, None] + torch.arange(W, device=dev)        # (b, r, W)
        real = cols < n
        cols = cols.clamp(max=n - 1)
        ranking = nb.sum_of_squares(queries[:, rows, None, :] - points_sorted[bi, cols])
        if p_mask_sorted is not None:
            ranking = torch.where(p_mask_sorted[bi, cols], ranking, nb.MASKED_RANK_FILL)
        # (ranking bits << 32) | id is distinct for every real column, so
        # topk's unspecified order among equal values cannot show
        key = (ranking.contiguous().view(torch.int32).long() << 32) | orig_ids.long()[bi, cols]
        top = torch.topk(torch.where(real, key, empty), k, dim=-1, largest=False,
                         sorted=True).values
        vals.append((top >> 32).int().view(torch.float32))
        idx.append(top & 0xFFFFFFFF)
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def knn_select_window_plain(queries, ranks, points_sorted, orig_ids, k, W,
                            p_mask_sorted=None, row_chunk: Optional[int] = None):
    """(vals float32, idx int64, margin float32): for every query row the k
    smallest of its window's columns by (squared distance, 1e5 at a masked
    point; original id), reported by original id, and the row's margin
    (``_window_plan``)."""
    ti, starts, margin = _window_plan(queries, ranks, points_sorted, k, W, p_mask_sorted)
    vals, idx = _window_select_plain(queries, points_sorted, orig_ids, k, W, p_mask_sorted, ti,
                                     starts, row_chunk)
    return vals, idx, margin


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SELECT_ARGS = [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _P, _P, _P]
_CANDIDATE_ARGS = [_P, _P, _I, _I, _I, _I, _P, _P, _P]
_ENTRIES = {  # launch function -> argument types, all in csrc/knn_select_large.cu
    "knn_select_gather_launch": [_P, _P, _P, ctypes.c_longlong, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _P],
    "knn_select_launch": _SELECT_ARGS,
    "knn_select_tiled_launch": _SELECT_ARGS,
    "knn_candidates_packed_tiled_launch": _CANDIDATE_ARGS,
    "knn_candidates_packed_launch": _CANDIDATE_ARGS,
    "knn_select_queries_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "knn_select_window_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "knn_select_plan": [_I] * 8 + [ctypes.POINTER(_I)] * 3,
}
# the kernels whose rows are few: several warps a row where one row a warp
# would leave the card half empty (the source's block_plan)
_STRIPED = ("knn_select_gather", "knn_select", "knn_select_queries", "knn_select_window")


def _entry(name: str):
    return build.function("knn_select_large", name, _ENTRIES[name])


def built_plan(kernel: str, b: int, nrows: int, c: int, k: int, sms: int,
               adjacency: bool = False, ti: int = 0) -> tuple[int, int, int]:
    """(rows a warp, columns a lane a step, warps a row) of the launch of
    ``kernel`` (a ``LAUNCH_COUNTS`` name of this module) for b * nrows rows
    at (c, k) on a card of ``sms`` SMs, with an adjacency or not, K9's
    groups of ``ti`` rows sharing a window, as the built source plans it
    (``csrc/knn_select_large.cu:block_plan``, the rule's one owner)."""
    rows, cols, stripes = _I(), _I(), _I()
    _entry("knn_select_plan")(int(kernel in _STRIPED), b, nrows, c, k, int(adjacency), ti, sms,
                              ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(stripes))
    return rows.value, cols.value, stripes.value


def _check_inputs(coors, k, mask, adj_mat):
    """Validate what the kernels take; returns (mask_ptr, adj_ptr,
    adj_batch_stride, the tensors behind the pointers)."""
    if coors.dim() != 3 or coors.dtype != torch.float32 or not coors.is_contiguous():
        raise ValueError(f"coors must be a contiguous (b, n, c) float32 tensor, "
                         f"got {tuple(coors.shape)} {coors.dtype}")
    b, n, c = coors.shape
    if not (1 <= k <= MAX_K and k <= n and 1 <= c <= MAX_C):
        raise ValueError(f"kernel supports 1 <= k <= {MAX_K}, k <= n, "
                         f"1 <= c <= {MAX_C}; got k={k}, n={n}, c={c}")
    dev = coors.device
    keep = []
    mask_ptr = adj_ptr = None
    adj_bstride = 0
    if mask is not None:
        if mask.shape != (b, n) or mask.dtype != torch.bool or mask.device != dev:
            raise ValueError("mask must be a (b, n) bool tensor on the coors' device")
        mask = mask.contiguous()
        keep.append(mask)
        mask_ptr = mask.data_ptr()
    if adj_mat is not None:
        if (adj_mat.shape != (b, n, n) or adj_mat.dtype != torch.bool
                or adj_mat.device != dev):
            raise ValueError("adj_mat must be a (b, n, n) bool tensor on the coors' device")
        if adj_mat.stride(1) != n or adj_mat.stride(2) != 1:
            adj_mat = adj_mat.contiguous()
        keep.append(adj_mat)
        adj_ptr = adj_mat.data_ptr()
        adj_bstride = adj_mat.stride(0)  # 0 for one (n, n) expanded over b
    return mask_ptr, adj_ptr, adj_bstride, keep


def _count_name(name: str, rows) -> str:
    """The launch count of ``name``: a row-block launch counts apart
    (``<name>_rows``), so that a run shows which mode its path took."""
    return name if rows is None else f"{name}_rows"


def _launch_knn_select_gather(coors, k, table, mask, adj_mat, rows=None):
    # `keep` holds any contiguous copies behind the pointers until the launch
    mask_ptr, adj_ptr, adj_bstride, keep = _check_inputs(coors, k, mask, adj_mat)
    b, n, c = coors.shape
    r0, count = _row_block(n, rows)
    if (table.dim() != 3 or table.shape[:2] != (b, n) or table.dtype != torch.float32
            or table.device != coors.device or not table.is_contiguous()):
        raise ValueError("table must be a contiguous (b, n, tw) float32 tensor "
                         "on the coors' device")
    tw = table.shape[2]
    vals = torch.empty((b, count, k), dtype=torch.float32, device=coors.device)
    idx = torch.empty((b, count, k), dtype=torch.int64, device=coors.device)
    out = torch.empty((b, count, k, tw), dtype=torch.float32, device=coors.device)
    with torch.cuda.device(coors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("knn_select_gather_launch")(
            coors.data_ptr(), mask_ptr, adj_ptr, adj_bstride, table.data_ptr(),
            b, n, c, k, tw, r0, count, vals.data_ptr(), idx.data_ptr(), out.data_ptr(), stream)
    _raise_on(err, "knn_select_gather")
    LAUNCH_COUNTS[_count_name("knn_select_gather", rows)] += 1
    return vals, idx, out


def _launch_select(name, coors, k, mask, adj_mat, rows=None):
    """K3 or K4: the selection-only kernel behind the entry ``name``_launch,
    over the row block ``rows = (r0, R)`` or every row."""
    mask_ptr, adj_ptr, adj_bstride, keep = _check_inputs(coors, k, mask, adj_mat)
    b, n, c = coors.shape
    r0, count = _row_block(n, rows)
    vals = torch.empty((b, count, k), dtype=torch.float32, device=coors.device)
    idx = torch.empty((b, count, k), dtype=torch.int64, device=coors.device)
    with torch.cuda.device(coors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(f"{name}_launch")(
            coors.data_ptr(), mask_ptr, adj_ptr, adj_bstride, b, n, c, k, r0, count,
            vals.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, name)
    LAUNCH_COUNTS[_count_name(name, rows)] += 1
    return vals, idx


def _launch_candidates(name, coors, kc, mask):
    """K5 or K6: the candidate kernel behind the entry ``name``_launch."""
    mask_ptr, _, _, keep = _check_inputs(coors, kc, mask, None)
    b, n, c = coors.shape
    keys = torch.empty((b, n, kc), dtype=torch.int32, device=coors.device)
    cols = torch.empty((b, n, kc), dtype=torch.int64, device=coors.device)
    with torch.cuda.device(coors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(f"{name}_launch")(
            coors.data_ptr(), mask_ptr, b, n, c, kc, keys.data_ptr(), cols.data_ptr(), stream)
    _raise_on(err, name)
    LAUNCH_COUNTS[name] += 1
    return keys, cols


def _on_card(coors: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; no other device has a
    kernel or a plain version."""
    if not coors.is_cuda and coors.device.type != "cpu":
        raise ValueError(f"no kNN kernel for device {coors.device}")
    return coors.is_cuda


@torch.library.custom_op("egnn_tpu_torch::knn_select_gather", mutates_args=())
def _knn_select_gather_op(coors: torch.Tensor, k: int, table: torch.Tensor,
                          mask: Optional[torch.Tensor],
                          adj_mat: Optional[torch.Tensor], r0: int, nrows: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    rows = None if nrows < 0 else (r0, nrows)
    if _on_card(coors):
        return _launch_knn_select_gather(coors, k, table, mask, adj_mat, rows)
    return knn_select_gather_plain(coors, k, table, mask, adj_mat, rows)


@_knn_select_gather_op.register_fake
def _knn_select_gather_shapes(coors, k, table, mask, adj_mat, r0, nrows):
    b, n, _ = coors.shape
    r = n if nrows < 0 else nrows
    return (coors.new_empty((b, r, k)), coors.new_empty((b, r, k), dtype=torch.int64),
            table.new_empty((b, r, k, table.shape[-1])))


def knn_select_gather(
    coors: torch.Tensor,
    k: int,
    table: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
    rows: Optional[tuple[int, int]] = None,
):
    """K1: (vals (b, n, k), idx (b, n, k) int64, rows (b, n, k, tw)).

    coors (b, n, c) and table (b, n, tw) float32, mask (b, n) bool, adj_mat
    (b, n, n) bool (an expanded (n, n) is read without a copy). A CUDA tensor
    launches the kernel; a CPU tensor runs ``knn_select_gather_plain``.

    ``rows = (r0, R)``: the row-block mode, the rows r0 .. r0 + R - 1 of the
    points alone against all n columns, each equal to the whole launch's row
    bit for bit; the outputs are (b, R, ...), the payload rows gathered from
    the whole table. Its launches count as ``knn_select_gather_rows``.

    The call goes through the operator ``torch.ops.egnn_tpu_torch.
    knn_select_gather``, whose fake implementation gives the output shapes,
    so that ``torch.export`` can trace a forward that selects through K1
    (``examples/export_serving.py``) and the exported program launches the
    kernel on the card.
    """
    r0, nrows = (0, -1) if rows is None else rows
    return _knn_select_gather_op(coors, k, table, mask, adj_mat, r0, nrows)


def knn_select(
    coors: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
    rows: Optional[tuple[int, int]] = None,
):
    """K3: (vals, idx), the selection of ``knn_select_gather`` without rows;
    ``rows = (r0, R)`` its row-block mode (counted as ``knn_select_rows``)."""
    if _on_card(coors):
        return _launch_select("knn_select", coors, k, mask, adj_mat, rows)
    return knn_select_plain(coors, k, mask, adj_mat, rows=rows)


def knn_select_tiled(
    coors: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
    rows: Optional[tuple[int, int]] = None,
):
    """K4: (vals float32, idx int64), K3's selection at any n. Like the TPU
    kernel it ranks in float32 whatever the coordinates' type; a CPU tensor
    runs ``knn_select_plain`` over row chunks. ``rows = (r0, R)``: the
    row-block mode (counted as ``knn_select_tiled_rows``)."""
    if _on_card(coors):
        return _launch_select("knn_select_tiled", coors, k, mask, adj_mat, rows)
    b, n, _ = coors.shape
    return knn_select_plain(coors.float(), k, mask, adj_mat, _default_row_chunk(b, n),
                            rows=rows)


def knn_candidates_packed_tiled(
    coors: torch.Tensor, kc: int, mask: Optional[torch.Tensor] = None
):
    """K5: (keys (b, n, kc) int32, cols (b, n, kc) int64), ascending in
    (key, col). The TPU kernel returns int32 columns; these are int64, as
    K1's indices, because they index ``gather_nodes``. Needs kc <= n, so
    every slot holds a real column. A CPU tensor runs
    ``knn_candidates_packed_tiled_plain``."""
    if _on_card(coors):
        return _launch_candidates("knn_candidates_packed_tiled", coors, kc, mask)
    b, n, _ = coors.shape
    return knn_candidates_packed_tiled_plain(coors, kc, mask, _default_row_chunk(b, n))


def knn_candidates_packed(
    coors: torch.Tensor, kc: int, mask: Optional[torch.Tensor] = None
):
    """K6: as ``knn_candidates_packed_tiled`` with 18-bit keys. A CPU tensor
    runs ``knn_candidates_packed_plain``."""
    if _on_card(coors):
        return _launch_candidates("knn_candidates_packed", coors, kc, mask)
    b, n, _ = coors.shape
    return knn_candidates_packed_plain(coors, kc, mask, _default_row_chunk(b, n))


def _check_queries(queries, points, k, q_mask, p_mask):
    """Validate what K8 and K9 take; returns (q_mask, p_mask) contiguous."""
    if (queries.dim() != 3 or points.dim() != 3 or queries.shape[0] != points.shape[0]
            or queries.shape[2] != points.shape[2] or queries.shape[1] < 1):
        raise ValueError(f"queries (b, R, c) and points (b, n, c) expected, got "
                         f"{tuple(queries.shape)} and {tuple(points.shape)}")
    for name, t in (("queries", queries), ("points", points)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != queries.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on one device")
    n, c = points.shape[1], points.shape[2]
    if not (1 <= k <= MAX_K and k <= n and 1 <= c <= MAX_C):
        raise ValueError(f"kernel supports 1 <= k <= {MAX_K}, k <= n, 1 <= c <= {MAX_C}; "
                         f"got k={k}, n={n}, c={c}")
    out = []
    for name, m, t in (("q_mask", q_mask, queries), ("p_mask", p_mask, points)):
        if m is not None:
            if m.shape != t.shape[:2] or m.dtype != torch.bool or m.device != t.device:
                raise ValueError(f"{name} must be a bool tensor of shape {tuple(t.shape[:2])} "
                                 "on the queries' device")
            m = m.contiguous()
        out.append(m)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def knn_select_queries(
    queries: torch.Tensor,                   # (b, R, c)
    points: torch.Tensor,                    # (b, n, c)
    k: int,
    q_mask: Optional[torch.Tensor] = None,   # (b, R) the query rows' own mask bits
    p_mask: Optional[torch.Tensor] = None,   # (b, n)
):
    """K8: (vals float32, idx int64), each (b, R, k): the exact selection of
    R query rows against all n points, with K4's ranking (no adjacency) and
    tie order, so a row equals K4's row of the same node bit for bit. The
    masks come together or not at all. A CPU tensor runs
    ``knn_select_queries_plain``."""
    if (q_mask is None) != (p_mask is None):
        raise ValueError("q_mask and p_mask come together")
    if not _on_card(queries):
        b, n = points.shape[:2]
        return knn_select_queries_plain(queries, points, k, q_mask, p_mask,
                                        _default_row_chunk(b, n))
    q_mask, p_mask = _check_queries(queries, points, k, q_mask, p_mask)
    b, r, c = queries.shape
    n = points.shape[1]
    vals = torch.empty((b, r, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((b, r, k), dtype=torch.int64, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("knn_select_queries_launch")(
            queries.data_ptr(), _ptr(q_mask), points.data_ptr(), _ptr(p_mask), b, r, n, c, k,
            vals.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "knn_select_queries")
    LAUNCH_COUNTS["knn_select_queries"] += 1
    return vals, idx


def knn_select_window(
    queries: torch.Tensor,                   # (b, R, c): valid rows only
    ranks: torch.Tensor,                     # (b, R) int: each query's rank in the x-sort
    points_sorted: torch.Tensor,             # (b, n, c) ascending in x
    orig_ids: torch.Tensor,                  # (b, n) int: the sorted rows' original ids
    k: int,
    W: int,                                  # window width, a multiple of 128
    p_mask_sorted: Optional[torch.Tensor] = None,   # (b, n) the sorted points' mask
):
    """K9: (vals float32, idx int64, margin float32): the exact selection of
    the query rows against a W-wide window of the x-sorted points, ties by
    the lowest original id, indices original. A row with
    ``vals[..., k-1] < margin**2`` (and, under a mask, ``< 1e5``) equals the
    exact masked selection's row. The rows of a group of ``_pick_ti_window``
    share one window, so sort the queries by rank. The kernel takes the
    windows' starts as a tensor; starts and margins are computed here in
    torch, by the reference's rule. A CPU tensor runs
    ``knn_select_window_plain``."""
    if not _on_card(queries):
        b, n = points_sorted.shape[:2]
        return knn_select_window_plain(queries, ranks, points_sorted, orig_ids, k, W,
                                       p_mask_sorted, max(1, (1 << 24) // max(1, b * W)))
    _, p_mask_sorted = _check_queries(queries, points_sorted, k, None, p_mask_sorted)
    b, r, _ = queries.shape
    n = points_sorted.shape[1]
    if orig_ids.shape != (b, n) or ranks.shape != (b, r) or orig_ids.device != queries.device:
        raise ValueError("orig_ids must be (b, n) and ranks (b, R), on the queries' device")
    ti, starts, margin = _window_plan(queries, ranks, points_sorted, k, W, p_mask_sorted)
    vals, idx = _launch_window(queries, points_sorted, orig_ids, k, W, p_mask_sorted, ti, starts)
    return vals, idx, margin


def _launch_window(queries, points_sorted, orig_ids, k, W, p_mask_sorted, ti, starts):
    """K9's launch at the windows ``starts`` (b, ceil(R / ti)), any columns,
    of groups of ``ti`` rows (a multiple of 8): (vals, idx), each (b, R, k).
    Every window must hold k of the n columns."""
    b, r, c = queries.shape
    n = points_sorted.shape[1]
    starts32, ids32 = starts.int().contiguous(), orig_ids.int().contiguous()
    vals = torch.empty((b, r, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((b, r, k), dtype=torch.int64, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("knn_select_window_launch")(
            queries.data_ptr(), points_sorted.data_ptr(), _ptr(p_mask_sorted),
            ids32.data_ptr(), starts32.data_ptr(), ti, W, b, r, n, c, k,
            vals.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "knn_select_window")
    LAUNCH_COUNTS["knn_select_window"] += 1
    return vals, idx
