"""Grid-blocked kNN selection: kernel K7, its plain version, its host side
and the reference's gate. Launches count into ``LAUNCH_COUNTS["grid_knn_cells"]``.

K7 ``grid_knn_cells`` replaces both ``pallas_call`` sites of
``egnn_tpu/ops/pallas/grid_knn.py``: ``_grid_knn_kernel`` (:225, the
candidate table resident in VMEM) and ``_grid_knn_streamed_kernel`` (:281,
candidate blocks streamed, beyond about 74 000 nodes). The two differ in how
a TPU core reaches the table; the function is one. With the nodes grouped by
spatial cell (``ops/spatial.py``), every node ranks the nodes of its cell's
3 x 3 x 3 block, at most 128 a cell, and keeps the k smallest by
(squared distance, node id): exactly the order of the exact selection, ties
included, so a certified row needs no tie check.

What is not carried over: the (cell, slot) tables padded to 128 slots with
sentinel coordinates beyond the bounding box, node ids stored as float32,
the 8-row sublane groups and the per-cell output blocks that a gather then
unsorts. The kernel reads the cells as a CSR over the nodes sorted by cell
(empty slots do not exist, so none needs a sentinel) and writes each row at
its node. The reference's contract is kept: the early checks (no cell over
128 nodes, k candidates in every valid row's block, coordinates within
``SCALE_MAX``) are decided before the kernel and skip it, and
``grid_knn_select`` returns the reference's (vals, idx, ok, row_exact).

A CUDA tensor launches ``csrc/grid_knn.cu`` or raises; a CPU tensor runs
``grid_knn_cells_plain``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..neighbors import sum_of_squares
from ..spatial import assign_cells, neighbor_cells, resort_and_certify
from . import LAUNCH_COUNTS, build
from . import raise_on_launch_error as _raise_on

M_CAP = 128            # nodes a cell may hold
SCALE_MAX = 1e15       # coordinates and box diagonals beyond it are rejected:
#                        their squares approach the float32 range
_OCC_TARGET = 64.0     # mean nodes a cell the grid aims at
_OCC_MAX = 96.0        # beyond it a cell overflows too often (P(X > 128 | 96) ~ 8e-4)
_MAX_CELLS = 2 ** 15   # the reference's cell-count backstop
_MIN_N = 8192          # below, the exact kernels rank fewer pairs than 27 cells hold


def grid_kernel_gdim(n: int) -> int:
    """Cells per axis for n nodes at the target occupancy."""
    return max(4, int(round((n / _OCC_TARGET) ** (1.0 / 3.0))))


def supports_grid_knn(n: int, k: int) -> bool:
    """The reference's gate of the grid kernel, as a function of the shape
    (``egnn_tpu/ops/pallas/grid_knn.py:109``). The card needs none of it; it
    is kept because it decides which route ``ops/neighbors.py`` takes, and
    with it the shape of the result."""
    G = grid_kernel_gdim(n) ** 3
    return 1 <= k <= M_CAP and n >= _MIN_N and n / G <= _OCC_MAX and G <= _MAX_CELLS


def _cell_table(cell_start, cell_nodes, n):
    """(b, G + 1, 128) node ids by (cell, slot) from the CSR, n where a slot
    is empty; a cell's nodes beyond slot 128 are left out, and row G (a
    cell out of the grid) is empty."""
    b, G = cell_start.shape[0], cell_start.shape[1] - 1
    slot = torch.arange(M_CAP, device=cell_start.device)
    src = cell_start[:, :G, None] + slot                                 # (b, G, 128)
    filled = src < cell_start[:, 1:, None]
    ids = torch.gather(cell_nodes, 1, src.clamp(max=n - 1).reshape(b, -1)).reshape(b, G, M_CAP)
    table = torch.where(filled, ids, n)
    return torch.cat([table, table.new_full((b, 1, M_CAP), n)], dim=1)


def grid_knn_cells_plain(coors, cell_start, cell_nodes, k, gdim, cell_chunk: int = 8):
    """The plain version of K7, ``cell_chunk`` cells at a time.

    coors (b, n, 3) float32; cell_start (b, G + 1) the CSR offsets of the
    cells into cell_nodes (b, n), the node ids sorted by cell (entries from
    cell_start[:, G] on belong to no cell). Returns vals (b, n, k) float32
    and idx (b, n, k) int64: for every node among the first 128 of a cell,
    the k smallest (squared distance, node id) over the first 128 nodes of
    each of the 27 cells around it, ascending; (inf, n) where there are
    fewer than k, and in the rows of nodes that are in no cell."""
    b, n, _ = coors.shape
    G = gdim ** 3
    dev = coors.device
    table = _cell_table(cell_start.long(), cell_nodes.long(), n)         # (b, G + 1, 128)
    nbrs = neighbor_cells(gdim, dev)                                     # (G, 27)
    coors_pad = torch.cat([coors, coors.new_zeros(b, 1, 3)], dim=1)
    vals = torch.full((b, n + 1, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((b, n + 1, k), n, dtype=torch.int64, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None]
    empty = torch.iinfo(torch.int64).max
    for c0 in range(0, G, cell_chunk):
        cells = slice(c0, min(c0 + cell_chunk, G))
        q_gid = table[:, cells]                                          # (b, ch, 128)
        cand_gid = table[bi, nbrs[cells][None]].reshape(b, -1, 1, 27 * M_CAP)
        dist = sum_of_squares(coors_pad[bi[..., None], cand_gid]
                              - coors_pad[bi, q_gid][:, :, :, None, :])  # (b, ch, 128, C)
        # (distance bits << 32) | id is distinct for every real candidate,
        # so topk's unspecified order among equal values cannot show
        key = (dist.contiguous().view(torch.int32).long() << 32) | cand_gid
        key = torch.where(cand_gid < n, key, empty)
        kk = min(k, key.shape[-1])
        top = torch.topk(key, kk, dim=-1, largest=False, sorted=True).values
        found = top != empty
        v = torch.where(found, (top >> 32).int().view(torch.float32), float("inf"))
        g = torch.where(found, top & 0xFFFFFFFF, n)
        rows = q_gid.reshape(b, -1)                                      # n: an empty slot
        vals[bi[..., 0], rows, :kk] = v.reshape(b, -1, kk)
        idx[bi[..., 0], rows, :kk] = g.reshape(b, -1, kk)
    vals[:, n], idx[:, n] = float("inf"), n
    return vals[:, :n].contiguous(), idx[:, :n].contiguous()


# ---------------------------------------------------------------------------
# the traversal of K7 on the card, as a CPU model
# ---------------------------------------------------------------------------
# csrc/grid_knn.cu:grid_knn_kernel takes one cell a block of 8 warps; a
# warp ranks one query of the cell at a time against the block's candidates
# (its 27 cells, the cell itself first, then kOrder), in steps of 128: lane l
# takes the candidates t0 + 4l .. t0 + 4l + 3. A pair passes the pre-test
# when its distance is not above the query's threshold; a step whose pairs
# all fail costs one vote. A passing pair below the query's k-th packed
# value is queued, and 32 queued values are merged into the list at once.

GRID_RUN = 4         # kRun: consecutive candidates a lane ranks a step
GRID_BATCH = 32      # kBatch: queued values a merge takes
# the cell offsets of a block in the kernel's order (kOrder), packed
# (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1): the cell, its faces, edges, corners
GRID_ORDER = (13, 4, 10, 12, 14, 16, 22, 1, 3, 5, 7, 9, 11, 15, 17, 19, 21, 23, 25, 0, 2, 6,
              8, 18, 20, 24, 26)
_EMPTY = torch.iinfo(torch.int64).max


def grid_knn_cells_model(coors, cell_start, cell_nodes, k, gdim):
    """The traversal of ``grid_knn_kernel`` in torch: (vals, idx) as
    ``grid_knn_cells_plain`` defines them, and the counts of the run.

    It takes the kernel's steps for every query of every cell at once: the
    block's candidates in the kernel's order (+inf past the last), in each
    step lane l's candidates t0 + 4l + q, the pre-test of every pair against
    the query's threshold (the float of its k-th packed value; NaN, so every
    pair passes, while the list is not full), one vote a warp step, then
    column q by column q the exact test of each flagged lane's packed value
    ``(bits(r) << 32) | id`` against the k-th, the values that pass appended
    to the query's queue in lane order, and a merge of the queue's last 32
    into the list whenever it holds 32; at the end a merge of what is left.
    The counts: warp steps (``steps``), those that took the insertion path
    (``votes``) and list merges (``merges``)."""
    b, n, _ = coors.shape
    G = gdim ** 3
    dev = coors.device
    x = coors.float()
    table = _cell_table(cell_start.long(), cell_nodes.long(), n)         # (b, G + 1, 128)
    nbrs = neighbor_cells(gdim, dev)[:, list(GRID_ORDER)]                # (G, 27)
    bi = torch.arange(b, device=dev)[:, None, None]
    cand = table[bi, nbrs[None]].reshape(b, G, 27 * M_CAP)                # n: an empty slot
    # the real candidates first, in order (a stable sort moves the empty slots last)
    cand = torch.gather(cand, 2, torch.sort((cand == n).to(torch.int8), dim=2,
                                            stable=True).indices)
    total = (cand < n).sum(dim=2)                                        # (b, G)
    steps_total = 27 * M_CAP // (32 * GRID_RUN)
    x_pad = torch.cat([x, x.new_full((b, 1, 3), math.inf)], dim=1)
    q_count = (cell_start[:, 1:G + 1] - cell_start[:, :G]).long().clamp(0, M_CAP)   # (b, G)
    slot = torch.arange(M_CAP, device=dev)
    live = slot < q_count[..., None]                                     # (b, G, 128)
    xi = x_pad[bi, cand[..., :M_CAP]]                                    # (b, G, 128, 3)
    lists = torch.full((b, G, M_CAP, k), _EMPTY, dtype=torch.int64, device=dev)
    cap = 2 * GRID_BATCH                                                 # kQueue
    queue = torch.full((b, G, M_CAP, cap + 1), _EMPTY, dtype=torch.int64, device=dev)
    cnt = torch.zeros((b, G, M_CAP), dtype=torch.int64, device=dev)
    counts = {"steps": 0, "votes": 0, "merges": 0}

    def thresholds():
        tau = lists[..., k - 1]
        thr = _bits_as_float(tau >> 32)
        return tau, torch.where(live, thr, -math.inf)

    def merge(rows_mask, batch):
        nonlocal lists
        merged = torch.sort(torch.cat([lists, batch], dim=-1), dim=-1).values[..., :k]
        lists = torch.where(rows_mask[..., None], merged, lists)
        counts["merges"] += int(rows_mask.sum())

    tau, thr = thresholds()
    for st in range(steps_total):
        t0 = st * 32 * GRID_RUN
        pos = t0 + torch.arange(32 * GRID_RUN, device=dev)               # lane l, run q: 4l + q
        active = t0 < total                                              # (b, G): the block steps
        ids = cand[..., t0:t0 + 32 * GRID_RUN]                           # (b, G, 128)
        xj = x_pad[bi, ids]                                              # +inf past the last
        dist = sum_of_squares(xi[:, :, :, None, :] - xj[:, :, None, :, :])   # (b, G, 128, 128)
        lane_flag = (~(dist > thr[..., None])).view(b, G, M_CAP, 32, GRID_RUN).any(dim=-1)
        lane_flag &= active[..., None, None]
        warp_steps = live & active[..., None]
        vote = lane_flag.any(dim=-1)
        counts["steps"] += int(warp_steps.sum())
        counts["votes"] += int((vote & warp_steps).sum())
        packed = (_u32(dist) << 32) | ids[:, :, None, :]
        offered = lane_flag.repeat_interleave(GRID_RUN, dim=-1) & (pos < total[..., None])[
            :, :, None, :]
        for q in range(GRID_RUN):  # the row's values of column q, lanes in order
            p = torch.where(offered[..., q::GRID_RUN], packed[..., q::GRID_RUN], _EMPTY)
            take = p < tau[..., None]                                    # (b, G, 128, 32)
            at = cnt[..., None] + torch.cumsum(take.long(), dim=-1) - 1
            queue.scatter_(-1, torch.where(take, at, cap), p)            # the last: a bin
            cnt += take.sum(dim=-1)
            full = cnt >= GRID_BATCH
            if bool(full.any()):
                cnt = torch.where(full, cnt - GRID_BATCH, cnt)
                batch = queue.gather(-1, cnt[..., None] + torch.arange(GRID_BATCH, device=dev))
                merge(full, batch)
                tau, thr = thresholds()
    left = cnt > 0
    if bool(left.any()):
        batch = torch.where(torch.arange(GRID_BATCH, device=dev) < cnt[..., None],
                            queue[..., :GRID_BATCH], _EMPTY)
        merge(left, batch)
    found = lists != _EMPTY
    vals = torch.full((b, n + 1, k), math.inf, dtype=torch.float32, device=dev)
    idx = torch.full((b, n + 1, k), n, dtype=torch.int64, device=dev)
    out_rows = torch.where(live, cand[..., :M_CAP], n).reshape(b, -1)    # n: no row
    vals[bi[..., 0], out_rows] = torch.where(found, _bits_as_float(lists >> 32), math.inf).reshape(
        b, -1, k)
    idx[bi[..., 0], out_rows] = torch.where(found, lists & 0xFFFFFFFF, n).reshape(b, -1, k)
    vals[:, n], idx[:, n] = math.inf, n
    return vals[:, :n].contiguous(), idx[:, :n].contiguous(), counts


def _u32(t):
    """The bits of a float32 tensor as an int64 in [0, 2^32)."""
    return t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bits_as_float(u):
    """An int64 in [0, 2^32) as the float32 of those bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P]


def built_grid_plan() -> tuple[int, int, tuple[int, ...]]:
    """(candidates a lane a step, queued values a merge takes, the order of
    the 27 cells) of K7's launch, as the built source plans it
    (``csrc/grid_knn.cu:grid_knn_plan``)."""
    run, batch, order = _I(), _I(), (_I * 27)()
    build.function("grid_knn", "grid_knn_plan", [ctypes.POINTER(_I)] * 3)(
        ctypes.byref(run), ctypes.byref(batch), order)
    return run.value, batch.value, tuple(order)


def _launch_grid_knn_cells(coors, cell_start, cell_nodes, k, gdim):
    b, n, c = coors.shape
    G = gdim ** 3
    dev = coors.device
    if c != 3 or coors.dtype != torch.float32 or not coors.is_contiguous():
        raise ValueError(f"coors must be a contiguous (b, n, 3) float32 tensor, got "
                         f"{tuple(coors.shape)} {coors.dtype}")
    if not (1 <= k <= M_CAP and 1 <= gdim and G <= _MAX_CELLS):
        raise ValueError(f"kernel supports 1 <= k <= {M_CAP} and gdim^3 <= {_MAX_CELLS}; "
                         f"got k={k}, gdim={gdim}")
    for name, t, shape in (("cell_start", cell_start, (b, G + 1)),
                           ("cell_nodes", cell_nodes, (b, n))):
        if (t.shape != shape or t.dtype != torch.int32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} int32 tensor on the "
                             "coors' device")
    vals = torch.full((b, n, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((b, n, k), n, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.function("grid_knn", "grid_knn_cells_launch", _ARGTYPES)(
            coors.data_ptr(), cell_start.data_ptr(), cell_nodes.data_ptr(), b, n, gdim, k,
            vals.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "grid_knn_cells")
    LAUNCH_COUNTS["grid_knn_cells"] += 1
    return vals, idx


def grid_knn_cells(coors, cell_start, cell_nodes, k, gdim):
    """K7: (vals (b, n, k) float32, idx (b, n, k) int64) as
    ``grid_knn_cells_plain`` defines them, with cell_start and cell_nodes
    int32. ``cell_start`` must ascend from 0 to at most n along each row
    (``cell_csr`` makes it so); the kernel trusts it."""
    if coors.is_cuda:
        return _launch_grid_knn_cells(coors, cell_start, cell_nodes, k, gdim)
    if coors.device.type != "cpu":
        raise ValueError(f"no grid kNN kernel for device {coors.device}")
    return grid_knn_cells_plain(coors, cell_start, cell_nodes, k, gdim)


def cell_csr(counts: torch.Tensor, order: torch.Tensor):
    """K7's cell tables from ``assign_cells``'s counts (b, G + 1) and order
    (b, n): (cell_start (b, G + 1), cell_nodes (b, n)), int32."""
    cell_start = (counts.cumsum(dim=1) - counts).int().contiguous()
    return cell_start, order.int().contiguous()


def grid_knn_select(
    coors: torch.Tensor,                   # (b, n, 3)
    k: int,
    mask: Optional[torch.Tensor] = None,   # (b, n) bool
    gdim: Optional[int] = None,
):
    """Grid-blocked kNN selection with its certificate: the contract of
    ``ops/spatial.py:grid_knn_select`` through K7.

    Returns (vals (b, n, k) float32, idx (b, n, k) int64, ok 0-d bool,
    row_exact (b, n) bool). ``gdim`` overrides the occupancy model's cells
    per axis (tests use small grids).

    What the cell assignment alone decides is read on the host before any
    table is built (one synchronisation; the reference branches on the
    device): a cell over 128 nodes, a valid row whose block holds fewer than
    k candidates, or coordinates beyond ``SCALE_MAX`` skip the kernel and
    return zeros with ``ok`` false and no row exact, and the caller falls
    back.
    """
    b, n, c = coors.shape
    if c != 3:
        raise ValueError("grid-blocked selection is 3-D only")
    if gdim is None:
        gdim = grid_kernel_gdim(n)
    G = gdim ** 3
    dev = coors.device
    c32 = coors.float().contiguous()

    cid, counts, margin, order = assign_cells(c32, mask, gdim)
    overflow = (counts[:, :G] > M_CAP).any()
    # the candidates of a row are those of its cell: sum the 27 cells'
    # counts per cell, then read them at the nodes' cells
    cell_cand = counts[:, neighbor_cells(gdim, dev)].sum(dim=-1)         # (b, G)
    if mask is None:
        ncand = torch.gather(cell_cand, 1, cid)
        lo, hi = torch.aminmax(c32, dim=1)                               # (b, 3) each
        enough = ncand >= k
    else:
        ncand = torch.gather(cell_cand, 1, cid.clamp(max=G - 1))
        lo = torch.where(mask[..., None], c32, 3.4e38).amin(dim=1)
        hi = torch.where(mask[..., None], c32, -3.4e38).amax(dim=1)
        enough = (ncand >= k) | ~mask
    # the box's corners and its diagonal within SCALE_MAX (an infinite
    # corner would pass the reference's check too; its diagonal does not)
    diag = torch.sqrt(((hi - lo).clamp(min=0.0) ** 2).sum(dim=-1))
    corners = torch.cat([lo, hi], dim=-1)
    scale_ok = ((corners.abs() < SCALE_MAX) | ~torch.isfinite(corners)).all() & (
        diag < SCALE_MAX).all()
    if not bool(~overflow & scale_ok & enough.all()):
        return (torch.zeros(b, n, k, dtype=torch.float32, device=dev),
                torch.zeros(b, n, k, dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.zeros(b, n, dtype=torch.bool, device=dev))

    cell_start, cell_nodes = cell_csr(counts, order)
    vals, gid = grid_knn_cells(c32, cell_start, cell_nodes, k, gdim)
    if mask is not None:
        # every valid row has k candidates here, so each of its ids is a
        # node's; a masked row holds (inf, n) until the tail fills it
        gid = gid.clamp(max=n - 1)
    return resort_and_certify(vals, gid, mask, margin, ncand, None, None, k)
