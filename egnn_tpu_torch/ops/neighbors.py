"""Neighbourhood selection: masked kNN ranking and adjacency-degree expansion.

PyTorch counterpart of the exact path of ``egnn_tpu/ops/neighbors.py``, with
the reference's selection rules (egnn_pytorch.py:230-268, 414-432):

- masked pairs are filled with 1e5 in the ranking,
- with an adjacency matrix, self pairs rank -1 and adjacent pairs 0, so they
  always win the top-k,
- ``only_sparse_neighbors`` sets k to the max row degree in a direct call,
  and to ``num_nearest_neighbors`` under a train step (``static_k``), as the
  JAX package's eager and jitted calls do,
- neighbourhood validity is ``ranking <= valid_radius``,
- among equal rankings the lowest j wins (a stable sort; ``torch.topk``
  promises no tie order).

``knn_select_gather`` picks a route from the shape, as the JAX dispatcher
does (``egnn_tpu/ops/neighbors.py:262-706``), and each route's kernel by
device: a CUDA tensor goes to the hand-written kernels of
``ops/cuda/knn.py`` and ``ops/cuda/grid_knn.py``, a CPU tensor to their plain
versions.

- A 3-D cloud without an adjacency at n >= 8192 (the grid kernel's gate), or
  ``backend="grid"``: the grid route. K7 ranks each node against the 27 grid
  cells around it and certifies every row; failing rows are repaired by K8
  (against all points) or K9 (against a window of the x-sorted points), and
  a cloud that cannot certify takes the whole-call exact fallback. k slots.
- Otherwise within the full-band reach (lane-padded n <= 16384): K1 with a
  payload, K3 without.
- Beyond it, or with ``backend="tiled"``: K4, the exact selection at any n,
  then ``gather_nodes`` for the payload.
- Beyond it without an adjacency, or with ``backend="packed_tiled"`` /
  ``"packed"``: the packed-key candidates (K5 / K6), kc = k + 4 of them, one
  kc-wide gather, an exact float32 re-rank, and a coverage certificate whose
  failure sends the whole call to the exact kernel.
- ``backend="pallas"`` / ``"fused"``: the reference's full-band selection at
  any n (K1 / K3) and its fused select-and-gather within its gate (K1).

The gathered rows are differentiable with respect to the table: the backward
sums their cotangents into the table's rows with
``ops/segment.py:batched_segment_sum`` (kernel K2 on the card), as the JAX
package's custom VJP does (``neighbors.py:727-746``); selection is not
differentiated.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, NamedTuple, Optional

import torch

from .core import gather_nodes
from .segment import batched_segment_sum

MASKED_RANK_FILL = 1e5

# Candidates extracted beyond k by the packed-key routes, so that the exact
# re-rank covers the true top-k whenever keys[kc-1] > keys[k-1].
CANDIDATE_SLACK = 4

# ``backend="auto"`` takes the grid route where the grid kernel's gate takes
# the shape (``ops/cuda/grid_knn.py:supports_grid_knn``), as the reference
# does; False leaves ``auto`` on the exact and packed routes.
GRID_AUTO = True

# Least n at which the grid route repairs a failing share in (3n/64, n/16]
# through the windowed kernel (K9); below it the full scan (K8) is short
# enough. Tests lower it.
_WINDOW_REPAIR_MIN_N = 16384


class Neighborhood(NamedTuple):
    """Static-shape top-k neighbourhood of each node."""

    indices: torch.Tensor  # (b, n, k) int64 neighbour ids (j-dimension)
    ranking: torch.Tensor  # (b, n, k) the ranking values that won the top-k
    valid: torch.Tensor    # (b, n, k) bool: ranking <= valid_radius
    # (b, n, kc) bool, only on a wide result: the slots that hold the exact
    # top-k; ``valid`` is then already restricted to them
    winner: Optional[torch.Tensor] = None


def max_degree(adj_mat: torch.Tensor) -> int:
    """Max row degree of a (possibly batched) boolean adjacency
    (``int(adj_mat.float().sum(dim=-1).max().item())``, egnn_pytorch.py:249):
    one host read."""
    return int(adj_mat.float().sum(dim=-1).max().item())


_STATIC_K = contextvars.ContextVar("static_k", default=False)


@contextlib.contextmanager
def static_k() -> Iterator[None]:
    """The rule of the JAX package's jitted calls, where the adjacency is
    traced: inside, ``try_max_degree`` answers ``None`` and a layer with
    ``only_sparse_neighbors`` takes its given ``num_nearest_neighbors`` as k.
    The step factories (``training/state.py``) and the pipelined functions
    (``parallel/pipeline.py``), the counterparts of ``jax.jit``, run under
    it; so such a step reads no adjacency degree back, and a CUDA graph can
    capture it."""
    token = _STATIC_K.set(True)
    try:
        yield
    finally:
        _STATIC_K.reset(token)


def try_max_degree(adj_mat: torch.Tensor) -> Optional[int]:
    """``max_degree``, or ``None`` under ``static_k`` (the JAX package's
    ``try_max_degree`` on a traced adjacency)."""
    return None if _STATIC_K.get() else max_degree(adj_mat)


def pairwise_geometry(
    coors: torch.Tensor, coors_j: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, n, c) -> rel_coors (b, n, n, c) = x_i - x_j and squared distances
    rel_dist (b, n, n) (egnn_pytorch.py:232-233); against ``coors_j`` (b, m,
    c), the j side of a node-sharded layer's rows, (b, n, m, c) and (b, n, m).

    The squares are summed one coordinate at a time, ((d0^2 + d1^2) + d2^2),
    which is the order the CUDA kernel rounds in: the kernel's ranking values
    then equal these bitwise.
    """
    cj = coors if coors_j is None else coors_j
    rel_coors = coors[:, :, None, :] - cj[:, None, :, :]
    return rel_coors, sum_of_squares(rel_coors)


def sum_of_squares(rel: torch.Tensor) -> torch.Tensor:
    """``((d0^2 + d1^2) + d2^2) + ...`` over the last axis, one coordinate at
    a time: the rounding order of the kernels' rankings."""
    out = rel[..., 0] * rel[..., 0]
    for cc in range(1, rel.shape[-1]):
        out = out + rel[..., cc] * rel[..., cc]
    return out


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
    fills -> the k smallest (egnn_pytorch.py:232-260), by the route
    ``knn_select_gather`` takes without a payload (K3 on a CUDA tensor within
    the full-band reach)."""
    nbhd, _ = knn_select_gather(
        coors, num_nearest, valid_radius, mask=mask, adj_mat=adj_mat,
        backend=backend,
    )
    return nbhd


class _KnnSelectGather(torch.autograd.Function):
    """K1 (or its plain version) with the table's backward: the rows'
    cotangents summed into the table's rows at the saved indices. With
    ``rows = (r0, R)`` (the row-block mode) the R rows' cotangents are summed
    into all n rows of the table."""

    @staticmethod
    def forward(ctx, table, coors_sg, k, mask, adj_mat, rows=None):
        from .cuda import knn as knn_kernels

        vals, idx, out = knn_kernels.knn_select_gather(
            coors_sg, k, table, mask=mask, adj_mat=adj_mat, rows=rows)
        ctx.mark_non_differentiable(vals, idx)
        ctx.save_for_backward(idx)
        ctx.num_nodes = table.shape[1]
        return vals, idx, out

    @staticmethod
    def backward(ctx, d_vals, d_idx, d_rows):
        (idx,) = ctx.saved_tensors
        b, r, k = idx.shape
        tw = d_rows.shape[-1]
        d_table = batched_segment_sum(
            d_rows.contiguous().reshape(b, r * k, tw), idx.reshape(b, r * k), ctx.num_nodes)
        return d_table, None, None, None, None, None


def _table(coors, mask, payload):
    """``[coors | mask | payload]`` rows, in the coordinates' type."""
    parts = [coors]
    if mask is not None:
        parts.append(mask[..., None].to(coors.dtype))
    if payload is not None:
        parts.append(payload.to(coors.dtype))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else coors


def _refine_candidates(coors, coors_sg, k, valid_radius, mask, payload, tiled, wide):
    """The packed-key routes (``egnn_tpu/ops/neighbors.py:293-389``):
    kc = k + CANDIDATE_SLACK candidates from K5 (``tiled``) or K6, certified,
    gathered once kc-wide, re-ranked exactly in float32, and returned as kc
    slots with a winner mask (``wide``) or compacted to the top k."""
    from .cuda import knn as knn_kernels

    n, c = coors.shape[1], coors.shape[2]
    kc = k + CANDIDATE_SLACK
    coors32 = coors_sg.float()
    if tiled:
        keys, cols = knn_kernels.knn_candidates_packed_tiled(coors32, kc, mask=mask)
        sentinel = knn_kernels.PACKED_MASK_SENTINEL_TILED
    else:
        keys, cols = knn_kernels.knn_candidates_packed(coors32, kc, mask=mask)
        sentinel = knn_kernels.PACKED_MASK_SENTINEL
    # Coverage certificate: fewer than k columns lie strictly below the true
    # k-th key, so keys[k-1] >= key(k-th value); a strictly larger last
    # candidate key then proves that every column with key <= keys[k-1] was
    # extracted. A boundary at the masked-fill sentinel is safe too: that tie
    # group holds masked pairs only, whose exact rankings are all equal, so
    # their column order is already the top-k order.
    ok = ((keys[..., kc - 1] > keys[..., k - 1]) | (keys[..., k - 1] >= sentinel)).all()
    # The reference branches on the device (lax.cond). Here the branch is
    # taken on the host: one synchronisation per call.
    ok = bool(ok)
    if not ok:
        # any failing row sends the whole call to the exact kernel; its k
        # columns fill the first slots and the pad column n the rest
        exact = knn_kernels.knn_select_tiled if tiled else knn_kernels.knn_select
        _, idx_e = exact(coors32, k, mask=mask)
        cols = torch.cat([idx_e, idx_e.new_full(idx_e.shape[:-1] + (kc - k,), n)], dim=-1)

    # one kc-wide differentiable gather of [coors | mask | payload]
    safe_cols = cols.clamp(max=n - 1)
    g = gather_nodes(_table(coors, mask, payload), safe_cols)   # (b, n, kc, tw)
    gj = g.detach()
    rank = sum_of_squares(coors32[:, :, None, :] - gj[..., :c].float())  # (b, n, kc) f32
    if mask is not None:
        pair_ok = mask[:, :, None] & (gj[..., c] > 0.5)
        rank = torch.where(pair_ok, rank, MASKED_RANK_FILL)
    if not ok:  # the candidate kernels need kc <= n: pad columns arise only here
        rank = torch.where(cols >= n, math.inf, rank)

    if wide:
        # Slots strictly below the k-th candidate's key are winners outright;
        # the tie group at that key is resolved by exact (rank, slot) order,
        # which is (rank, column) order: equal keys sit in ascending column.
        slot = torch.arange(kc, device=coors.device)
        if ok:
            kb = keys[..., k - 1:k]
            definite = keys < kb
            group = keys == kb
            t = k - definite.sum(dim=-1, keepdim=True)
            r_before, r_slot = rank[..., :, None], rank[..., None, :]
            precedes = (group[..., :, None] & group[..., None, :]
                        & ((r_before < r_slot)
                           | ((r_before == r_slot) & (slot[:, None] < slot[None, :]))))
            winner = definite | (group & (precedes.sum(dim=-2) < t))
        else:
            winner = (slot < k).expand(cols.shape)
        vals = rank.to(coors.dtype)
        nbhd = Neighborhood(indices=safe_cols, ranking=vals,
                            valid=winner & (vals <= valid_radius), winner=winner)
        return nbhd, (g if payload is not None else None)

    # compact: the k smallest ranks, the lowest slot first among equals (a
    # stable sort; torch.topk promises no tie order)
    order = torch.sort(rank, dim=-1, stable=True).indices[..., :k]
    vals = torch.gather(rank, -1, order).to(coors.dtype)
    nbhd = Neighborhood(indices=torch.gather(safe_cols, -1, order), ranking=vals,
                        valid=vals <= valid_radius)
    if payload is None:
        return nbhd, None
    return nbhd, torch.gather(g, 2, order[..., None].expand(*order.shape, g.shape[-1]))


def _grid_route(coors, coors_sg, k, valid_radius, mask, payload):
    """The grid route (``egnn_tpu/ops/neighbors.py:480-706``): the grid
    selection and its certificate, then by the number of failing rows

    - none: the grid's result;
    - up to n/16: a repair of exactly the failing rows. A share in
      (3n/64, n/16] at n >= ``_WINDOW_REPAIR_MIN_N`` goes to the windowed
      kernel K9 first, and the rows its margin does not certify to K8;
      every other share to K8 directly;
    - up to n/4: K8 again;
    - more (an early reject leaves no row certified): the compact exact
      selection ``auto`` gives without the grid.

    The reference pads each repair to a static bucket (n/64, n/32, 3n/64,
    n/16, n/4) with certified rows, because XLA needs static shapes; here the
    failing rows are repaired alone, so the bucket sizes remain only where
    they decide which kernel runs. With b > 1 the rows are padded to the
    batch's largest count with certified rows, whose repair rewrites what
    they hold: K8's rows equal K7's and the masked fill bit for bit. The
    reference's branches on the device are host reads here: one in the grid
    kernel's early check, one for (ok, failing rows), one for the rows the
    window left, and the certificate's inside a packed fallback.
    """
    from .cuda import grid_knn as grid_kernels
    from .cuda import knn as knn_kernels
    from .spatial import grid_knn_select

    b, n, c = coors.shape
    c32 = coors_sg.float().contiguous()
    if grid_kernels.supports_grid_knn(n, k):
        vals, idx, ok, row_exact = grid_kernels.grid_knn_select(c32, k, mask=mask)
    else:
        vals, idx, ok, row_exact = grid_knn_select(c32, k, mask=mask)
    bad = ~row_exact
    ok, nbad = torch.stack([ok.long(), bad.sum(dim=1).max()]).tolist()

    def failing_first(rows, count, key=None):
        """(b, count) row ids: the rows of ``rows`` first, in ascending
        ``key`` (default: row id), then others."""
        if key is None:
            return torch.sort(rows.int(), dim=1, descending=True, stable=True).indices[:, :count]
        return torch.sort(torch.where(rows, key, 2 * n + key), dim=1).indices[:, :count]

    def take(t, fidx):
        return torch.gather(t, 1, fidx if t.dim() == 2 else
                            fidx[..., None].expand(*fidx.shape, t.shape[-1]))

    def put(t, fidx, rows):
        return t.scatter(1, fidx[..., None].expand_as(rows), rows)

    def repair(vals, idx, rows, count):
        """K8 on the ``count`` first failing rows of every cloud."""
        fidx = failing_first(rows, count)
        rv, ri = knn_kernels.knn_select_queries(
            take(c32, fidx).contiguous(), c32, k,
            q_mask=None if mask is None else take(mask, fidx), p_mask=mask)
        return put(vals, fidx, rv), put(idx, fidx, ri)

    def window_tier(vals, idx):
        """K9 on the failing rows, sorted by x-rank so that the rows of a
        group lie within its window; then K8 on those it left."""
        xkey = c32[..., 0] if mask is None else torch.where(mask, c32[..., 0], math.inf)
        order = torch.sort(xkey, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=order.device).expand(b, n))
        fidx = failing_first(bad, nbad, key=rank)
        rv, ri, margin = knn_kernels.knn_select_window(
            take(c32, fidx).contiguous(), take(rank, fidx), take(c32, order).contiguous(),
            order, k, win_w, p_mask_sorted=None if mask is None else take(mask, order))
        win_ok = rv[..., k - 1] < margin * margin
        if mask is not None:
            win_ok = win_ok & (rv[..., k - 1] < MASKED_RANK_FILL)
        apply_row = take(bad, fidx) & win_ok
        vals = put(vals, fidx, torch.where(apply_row[..., None], rv, take(vals, fidx)))
        idx = put(idx, fidx, torch.where(apply_row[..., None], ri, take(idx, fidx)))
        still_bad = bad & ~torch.zeros_like(bad).scatter_(1, fidx, apply_row)
        left = int(still_bad.sum(dim=1).max())
        return repair(vals, idx, still_bad, left) if left else (vals, idx)

    lane = knn_kernels.LANE
    r_3q = min(n, max(lane, (3 * n) // 64))
    r_small = min(n, max(lane, n // 16))
    r_big = min(n, max(2 * lane, n // 4))
    n_pad = knn_kernels._lane_pad(n)
    win_w = min(knn_kernels._lane_pad(n // 4), n_pad)
    # the window must hold k real columns wherever it lies in the padded array
    can_window = n >= _WINDOW_REPAIR_MIN_N and win_w - (n_pad - n) >= k
    if ok:
        pass
    elif nbad <= r_small:
        if nbad > r_3q and can_window:
            vals, idx = window_tier(vals, idx)
        else:
            vals, idx = repair(vals, idx, bad, nbad)
    elif nbad <= r_big:
        vals, idx = repair(vals, idx, bad, nbad)
    else:
        # the compact exact selection: K3 within the full-band reach, K5 and
        # the refine where its gate takes the shape, else K4
        kc = k + CANDIDATE_SLACK
        if knn_kernels.supports_knn_shapes(n):
            vals, idx = knn_kernels.knn_select(c32, k, mask=mask)
        elif n >= 2 * kc and knn_kernels.supports_knn_packed_tiled(n, kc):
            exact, _ = _refine_candidates(c32, c32, k, math.inf, mask, None, tiled=True,
                                          wide=False)
            vals, idx = exact.ranking, exact.indices
        else:
            vals, idx = knn_kernels.knn_select_tiled(c32, k, mask=mask)

    vals = vals.to(coors.dtype)
    nbhd = Neighborhood(indices=idx, ranking=vals, valid=vals <= valid_radius)
    gathered = None if payload is None else gather_nodes(_table(coors, mask, payload), idx)
    return nbhd, gathered


def knn_select_gather(
    coors: torch.Tensor,
    num_nearest: int,
    valid_radius: float,
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
    payload: Optional[torch.Tensor] = None,
    backend: str = "auto",
    wide: bool = False,
) -> tuple[Neighborhood, Optional[torch.Tensor]]:
    """Neighbour selection with an optional fused payload gather.

    Returns ``(nbhd, gathered)``. With a ``payload`` (b, n, w), ``gathered``
    is the (b, n, k, c [+1 with a mask] + w) rows of the table
    ``[coors | mask | payload]`` at the selected neighbours: the one combined
    gather the EGNN layer needs. Selection is not differentiated (``vals``
    and ``indices`` carry no gradient); the gathered rows carry gradients
    back to ``coors`` and the payload through the table, whose backward is
    a segment sum over the selected indices (kernel K2 on the card).

    Routes (every one returns the same exact selection; the route is a
    function of the shape, the same on the card and on the CPU, where each
    kernel's plain version runs):

    - ``"auto"`` on a 3-D cloud without an adjacency, 1 <= k <= 128, where
      ``ops/cuda/grid_knn.py:supports_grid_knn`` takes the shape (n >= 8192)
      and ``GRID_AUTO`` is set: the grid route (``_grid_route``).
    - ``"auto"`` otherwise, within the full-band reach
      (``ops/cuda/knn.py:supports_knn_shapes``): K1 with a payload, K3
      without. Beyond it with an adjacency: K4. Beyond it without one, where
      ``n >= 2 * kc`` and ``supports_knn_packed_tiled(n, kc)``: K5 and the
      exact refine; otherwise K4.
    - ``"grid"``: the grid route for a 3-D cloud without an adjacency at
      128 <= n, 1 <= k <= 128 (through K7 where its gate takes the shape,
      else the plain-torch grid of ``ops/spatial.py``); any other call takes
      the exact route ``"auto"`` would without the grid.
    - ``"tiled"``: K4, then ``gather_nodes`` for the payload.
    - ``"pallas"``: the full-band selection at any n, as the reference forces
      its full-band kernel: K1 with a payload, K3 without.
    - ``"fused"``: with a payload, inside the reference's gate of its fused
      gather (128 <= n, k <= 128, ``ops/cuda/knn.py:supports_knn_gather``),
      K1; otherwise the exact selection, K3 within the full-band reach and K4
      beyond it, and ``gather_nodes`` apart, as the reference does there.
    - ``"packed_tiled"`` / ``"packed"``: K5 / K6 and the exact refine, which
      needs no adjacency, 128 <= n, k <= 128, n >= 2 * kc and the kernel's
      gate; a call that fails these takes the exact route ``"auto"`` would
      (the JAX dispatcher lets a forced ``"packed"`` fall through the same
      way).

    ``wide=True`` matters only where a packed route engages: the result then
    keeps all kc = k + ``CANDIDATE_SLACK`` slots, with ``nbhd.winner``
    marking the exact top-k and ``nbhd.valid`` restricted to it, and the
    consumer aggregates under that mask. Every other route returns k slots
    and ``winner=None``. When the certificate fails, the exact kernel's k
    columns take the first slots (``winner`` = the first k) and the rest
    point at node n - 1 with an infinite ranking.

    Raises ``ValueError`` when ``num_nearest`` exceeds n, on every route and
    device, as ``jax.lax.top_k`` and the reference's ``topk`` do.
    """
    from .cuda import grid_knn as grid_kernels
    from .cuda import knn as knn_kernels

    if backend not in ("auto", "grid", "tiled", "packed", "packed_tiled", "pallas", "fused"):
        raise ValueError(f"unknown backend {backend!r}")

    coors_sg = coors.detach().contiguous()
    n, c = coors.shape[1], coors.shape[2]
    k = num_nearest
    if k > n:
        raise ValueError(f"num_nearest {k} is larger than the {n} nodes to select from")
    kc = k + CANDIDATE_SLACK
    full_band = knn_kernels.supports_knn_shapes(n)
    lane = knn_kernels.LANE
    kernel_ok = n >= lane and 1 <= k <= lane
    # the grid is resolved first, as in the reference (neighbors.py:264-275):
    # it takes precedence over the packed-tiled route beyond the reach
    if adj_mat is None and c == 3 and kernel_ok and (
            backend == "grid"
            or (backend == "auto" and GRID_AUTO and grid_kernels.supports_grid_knn(n, k))):
        return _grid_route(coors, coors_sg, k, valid_radius, mask, payload)

    # the reference's gates of its packed routes (neighbors.py:261, :277-291)
    packed_ok = adj_mat is None and kernel_ok and n >= 2 * kc
    use_packed = (backend == "packed" and packed_ok
                  and knn_kernels.supports_knn_packed(n, kc))
    use_packed_tiled = (
        (backend == "packed_tiled" or (backend == "auto" and not full_band))
        and packed_ok and knn_kernels.supports_knn_packed_tiled(n, kc))
    if use_packed or use_packed_tiled:
        return _refine_candidates(coors, coors_sg, k, valid_radius, mask, payload,
                                  tiled=use_packed_tiled, wide=wide)

    # the reference's full-band and fused routes (neighbors.py:622-625,
    # :716-723): "pallas" takes the full-band kernel at any n; "fused" the
    # fused gather inside its gate, else the exact selection and a gather
    fused = (backend == "fused" and payload is not None and kernel_ok
             and knn_kernels.supports_knn_gather(
                 n, c + (mask is not None) + payload.shape[-1], k))
    full_band_route = backend == "pallas" or fused or (
        backend != "tiled" and full_band)
    if not full_band_route:
        vals, indices = knn_kernels.knn_select_tiled(
            coors_sg.float(), k, mask=mask, adj_mat=adj_mat)
        vals = vals.to(coors.dtype)
        gathered = None if payload is None else gather_nodes(
            _table(coors, mask, payload), indices)
    elif payload is None or (backend == "fused" and not fused):
        vals, indices = knn_kernels.knn_select(coors_sg, k, mask=mask, adj_mat=adj_mat)
        gathered = None if payload is None else gather_nodes(
            _table(coors, mask, payload), indices)
    else:
        vals, indices, gathered = _KnnSelectGather.apply(
            _table(coors, mask, payload), coors_sg, k, mask, adj_mat)
    nbhd = Neighborhood(indices=indices, ranking=vals, valid=vals <= valid_radius)
    return nbhd, gathered


def knn_select_gather_rows(
    coors: torch.Tensor,
    num_nearest: int,
    valid_radius: float,
    rows: tuple[int, int],
    mask: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
    payload: Optional[torch.Tensor] = None,
) -> tuple[Neighborhood, Optional[torch.Tensor]]:
    """``knn_select_gather`` for the rows r0 .. r0 + R - 1 of ``rows = (r0,
    R)`` alone: the selection of a node-sharded layer, whose rank ranks its
    own rows against the whole (gathered) cloud. ``coors`` (b, n, c),
    ``mask`` (b, n), ``adj_mat`` (b, n, n) and ``payload`` (b, n, w) are
    whole; the result is (b, R, k) and the gathered rows (b, R, k, tw) of
    ``[coors | mask | payload]``, each row equal to the whole call's row of
    the same node on the exact route.

    It takes the exact route in the kernels' row-block mode: within the
    full-band reach K1 with a payload (K3 without), beyond it K4 and
    ``gather_nodes``. Either backward sums the gathered rows' cotangents into
    all n rows of the table (K2 on the card). The grid and packed routes
    select the same neighbours and are not given a row block: a node-sharded
    call ranks its R rows against all n columns at any n."""
    from .cuda import knn as knn_kernels

    coors_sg = coors.detach().contiguous()
    n = coors.shape[1]
    k = num_nearest
    if k > n:
        raise ValueError(f"num_nearest {k} is larger than the {n} nodes to select from")
    rows = (int(rows[0]), int(rows[1]))
    if not knn_kernels.supports_knn_shapes(n):
        vals, indices = knn_kernels.knn_select_tiled(
            coors_sg.float(), k, mask=mask, adj_mat=adj_mat, rows=rows)
        vals = vals.to(coors.dtype)
        gathered = None if payload is None else gather_nodes(
            _table(coors, mask, payload), indices)
    elif payload is None:
        vals, indices = knn_kernels.knn_select(coors_sg, k, mask=mask, adj_mat=adj_mat,
                                               rows=rows)
        gathered = None
    else:
        vals, indices, gathered = _KnnSelectGather.apply(
            _table(coors, mask, payload), coors_sg, k, mask, adj_mat, rows)
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


def khop_neighbor_lists(
    nbr: torch.Tensor,
    nbr_mask: Optional[torch.Tensor],
    num_degrees: int,
    cap_out: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sparse k-hop expansion of padded neighbour lists, the counterpart of
    ``egnn_tpu/ops/neighbors.py:khop_neighbor_lists``: no (n, n) buffer,
    O(n * cap) memory, so it reaches clouds where the dense
    ``expand_adjacency_degrees`` would need gigabytes.

    Args:
      nbr: (n, c0) integer ids of each node's one-hop neighbours (a kNN
        builder's rows).
      nbr_mask: (n, c0) bool, False on padding slots; None: all valid.
      num_degrees: D, the hops to expand to.
      cap_out: each row's output width (default min(n - 1, c0 + c0**2 + ...
        + c0**D), the largest ball). A row that reaches more keeps its lowest
        ids.

    Returns ``(ids, degrees, mask)``, each (n, cap_out) (int32, int32,
    bool): per node the nodes reachable in 1..D hops along the directed
    lists, ids ascending, labelled with their least hop count, self left
    out; padding slots hold id n and degree 0. These are clean BFS labels,
    not the reference's XOR relabelling, which ``expand_adjacency_degrees``
    keeps.

    Each hop gathers the frontier's lists, packs (id, degree) into one int32
    key, sorts each row (the first of each id then carries its least
    degree) and compacts the survivors to the front by a stable argsort of
    (dropped, position): the same ids, degrees and order as the JAX code,
    bit for bit.
    """
    n, c0 = nbr.shape
    if num_degrees < 1:
        raise ValueError("num_degrees must be >= 1")
    if cap_out is None:
        cap_out = min(n - 1, sum(c0 ** d for d in range(1, num_degrees + 1)))
    D = num_degrees
    big = D + 1                        # degree sentinel of invalid slots
    stride = big + 1                   # key = id * stride + degree
    if (n + 1) * stride >= 2 ** 31:
        raise ValueError("khop_neighbor_lists: the (id, degree) key must fit int32")
    dev = nbr.device
    i32 = dict(dtype=torch.int32, device=dev)
    sentinel = n                       # invalid id: sorts last
    rows = torch.arange(n, **i32)[:, None]
    nbr_v = nbr.to(torch.int32)
    if nbr_mask is not None:
        nbr_v = torch.where(nbr_mask, nbr_v, sentinel)
    # row n of the gather table is all sentinel: an invalid slot expands to
    # invalid candidates only
    table = torch.cat([nbr_v, torch.full((1, c0), sentinel, **i32)], dim=0)

    def dedup_compact(ids, deg, cap):
        skey = torch.sort(ids * stride + deg, dim=1, stable=True).values
        sids, sdeg = skey // stride, skey % stride
        first = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                           sids[:, 1:] != sids[:, :-1]], dim=1)
        keep = first & (sids < n) & (sids != rows) & (sdeg <= D)
        w = sids.shape[1]
        pos = torch.arange(w, **i32)[None, :]
        order = torch.argsort(torch.where(keep, pos, w + pos), dim=1, stable=True)[:, :cap]
        sids, sdeg = torch.gather(sids, 1, order), torch.gather(sdeg, 1, order)
        kept = torch.gather(keep, 1, order)
        return torch.where(kept, sids, sentinel), torch.where(kept, sdeg, big), kept

    ids = nbr_v
    deg = torch.where(nbr_v < n, 1, big).to(torch.int32)
    ids, deg, mask_out = dedup_compact(ids, deg, min(cap_out, c0))
    for d in range(2, D + 1):
        # the frontier: the ids first reached at the hop before
        src = torch.where(deg == d - 1, ids, sentinel)
        cand_ids = table[src.long()].reshape(n, -1)           # (n, W * c0)
        cand_deg = torch.where(cand_ids < n, d, big).to(torch.int32)
        ids, deg, mask_out = dedup_compact(torch.cat([ids, cand_ids], dim=1),
                                           torch.cat([deg, cand_deg], dim=1), cap_out)
    return ids, torch.where(mask_out, deg, 0), mask_out
