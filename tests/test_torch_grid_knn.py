"""The grid route's kernels against the JAX package, on the CPU in float32:
the plain versions of K7 (grid-blocked selection, with its host side), K8
(query rows against all points) and K9 (query rows against a window of the
x-sorted points), and the grid kernel's gate.

On the CPU the port's wrappers run the kernels' plain versions, which
``chip_smoke.py`` holds the CUDA kernels against bitwise on the card. Here
they meet the TPU kernels in Pallas interpret mode: K7 through
``grid_knn_select_pallas(gdim=4)``, table resident and streamed.

Tolerances. ``idx``, ``ok``, ``row_exact`` and K9's ``margin`` are exact
(the margin is one subtraction and one product). ``vals`` agree at rtol =
atol = 1e-6 on random floats (XLA may contract an FMA) and exactly on integer
coordinates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops.pallas import grid_knn as jg
from egnn_tpu.ops.pallas import knn as jk
from egnn_tpu_torch.ops.cuda import grid_knn as G
from egnn_tpu_torch.ops.cuda import knn as K
from egnn_tpu_torch.ops.spatial import neighbor_cells


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _uniform(seed, b, n, scale=10.0, with_mask=False):
    rng = np.random.RandomState(seed)
    coors = (rng.rand(b, n, 3) * scale).astype(np.float32)
    return coors, (rng.rand(b, n) > 0.1 if with_mask else None)


def _lattice(g=10):
    ax = np.arange(g, dtype=np.float32)
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(1, g ** 3, 3)


def _grid_both(coors, k, mask=None, streamed=False):
    jout = jg.grid_knn_select_pallas(_j(coors), k, mask=_j(mask), interpret=True, gdim=4,
                                     streamed=streamed)
    tout = G.grid_knn_select(_t(coors), k, mask=_t(mask), gdim=4)
    return jout, tout


def _assert_grid_same(jout, tout, exact_vals=False):
    jv, ji, jok, jrx = jout
    tv, ti, tok, trx = tout
    assert bool(tok) == bool(jok)
    np.testing.assert_array_equal(trx.numpy(), np.asarray(jrx))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tol = dict(rtol=0, atol=0) if exact_vals else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def test_gate_and_gdim_match_the_reference():
    assert G.M_CAP == jg.M_CAP and G.SCALE_MAX == jg._SCALE_MAX
    sizes = [128, 4096, 8191, 8192, 8193, 10000, 12288, 16384, 16896, 20480, 32768, 50000,
             65536, 74000, 131072, 262144, 1 << 20, 1 << 21, 3 << 20, 1 << 22]
    for n in sizes:
        assert G.grid_kernel_gdim(n) == jg.grid_kernel_gdim(n), n
        for k in (0, 1, 8, 16, 128, 129):
            assert G.supports_grid_knn(n, k) == jg.supports_grid_knn(n, k, backend="tpu"), (n, k)
    assert G.supports_grid_knn(65536, 16) and not G.supports_grid_knn(4096, 8)
    # the reference splits here into its resident and its streamed kernel;
    # the port's one kernel takes both
    assert jg._grid_resident_ok(jg.grid_kernel_gdim(65536))
    assert not jg._grid_resident_ok(jg.grid_kernel_gdim(131072))
    assert G.supports_grid_knn(131072, 16)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("seed,b,n,k,with_mask", [
    (0, 1, 1024, 8, False),
    (1, 2, 1024, 8, True),
    (2, 1, 2048, 16, False),
    (3, 1, 1000, 5, True),    # n not a power of two
])
def test_grid_kernel_matches_pallas_on_uniform_clouds(seed, b, n, k, with_mask, streamed):
    coors, mask = _uniform(seed, b, n, with_mask=with_mask)
    jout, tout = _grid_both(coors, k, mask, streamed)
    _assert_grid_same(jout, tout)
    assert bool(tout[2]), "a uniform cloud certifies"
    ev, ei = K.knn_select_plain(_t(coors), k, _t(mask))
    assert torch.equal(tout[1], ei) and torch.equal(tout[0], ev)


@pytest.mark.parametrize("streamed", [False, True])
def test_grid_kernel_lattice_ties(streamed):
    """Six neighbours at d^2 = 1 around every lattice point: the selection
    orders ties by node id and still certifies."""
    coors = _lattice()
    jout, tout = _grid_both(coors, 4, streamed=streamed)
    _assert_grid_same(jout, tout, exact_vals=True)
    assert bool(tout[2])
    ev, ei = K.knn_select_plain(_t(coors), 4)
    assert torch.equal(tout[1], ei) and torch.equal(tout[0], ev)


def test_grid_kernel_duplicate_pileup():
    """128 copies of 8 sites fill their cells exactly and are exact through
    ties alone; 256 copies overflow and take the early reject."""
    base = np.random.RandomState(0).rand(8, 3).astype(np.float32)
    coors = np.tile(base, (128, 1))[None]
    jout, tout = _grid_both(coors, 4)
    _assert_grid_same(jout, tout, exact_vals=True)
    assert bool(tout[2])
    _, ei = K.knn_select_plain(_t(coors), 4)
    assert torch.equal(tout[1], ei)
    jout, tout = _grid_both(np.tile(base, (256, 1))[None], 4)
    _assert_grid_same(jout, tout, exact_vals=True)
    assert not bool(tout[2]) and not tout[3].any() and not tout[1].any()


def test_grid_kernel_early_skip(monkeypatch):
    """A Gaussian cloud does not overflow equal-mass cells, and the kernel
    runs; a cloud with 40 valid nodes leaves corner blocks with fewer than
    k = 8 candidates, which is known before the kernel and skips it."""
    calls = []

    def spy(*a, _fn=G.grid_knn_cells_plain, **kw):
        calls.append(1)
        return _fn(*a, **kw)

    monkeypatch.setattr(G, "grid_knn_cells_plain", spy)
    rng = np.random.RandomState(5)
    gauss = (rng.randn(1, 2048, 3) * 10.0).astype(np.float32)
    jout, tout = _grid_both(gauss, 8)
    _assert_grid_same(jout, tout)
    assert calls == [1] and tout[3].float().mean() > 0.5
    # an isolated 4-point cluster shares its equal-mass cells with the bulk
    # and fails on its margin, not on its candidate count
    bulk = rng.rand(1, 1020, 3).astype(np.float32)
    far = (100.0 + 0.01 * rng.rand(1, 4, 3)).astype(np.float32)
    jout, tout = _grid_both(np.concatenate([bulk, far], axis=1), 8)
    _assert_grid_same(jout, tout)
    assert not bool(tout[2])
    calls.clear()
    sparse = np.zeros((1, 1024), bool)
    sparse[0, rng.permutation(1024)[:40]] = True
    jout, tout = _grid_both(gauss[:, :1024], 8, sparse)
    _assert_grid_same(jout, tout, exact_vals=True)
    assert not bool(tout[2]) and not tout[3].any() and calls == []


def test_grid_kernel_extreme_offsets_and_scale_guard():
    base, _ = _uniform(6, 1, 1024, scale=1.0)
    coors = base * np.float32(2e7) + np.float32(0.99e9)
    jout, tout = _grid_both(coors, 8)
    _assert_grid_same(jout, tout)
    assert bool(tout[2])
    _, ei = K.knn_select_plain(_t(coors), 8)
    assert torch.equal(tout[1], ei)
    jout, tout = _grid_both(coors * np.float32(1e7), 8)   # beyond SCALE_MAX
    _assert_grid_same(jout, tout, exact_vals=True)
    assert not bool(tout[2])


def test_grid_cells_plain_contract():
    """The kernel-level function on a hand-made CSR: rows by node, (inf, n)
    where the block holds fewer than k, nodes beyond a cell's 128 slots left
    out, nodes in no cell without a row."""
    n, k, gdim = 600, 5, 4
    coors = np.random.RandomState(1).rand(1, n, 3).astype(np.float32)
    coors[0, :200] = 0.25
    # cell 0 holds nodes 0..199 (72 beyond its slots), cell 41 = (2, 2, 1),
    # in neither block, nodes 203..589 (259 beyond its slots), the corner cell 63 nodes 200..202,
    # and nodes 590..599 are in no cell
    counts = np.zeros((1, gdim ** 3 + 1), np.int64)
    counts[0, [0, 41, 63]] = [200, 387, 3]
    order = np.concatenate([np.arange(200), np.arange(203, 590), np.arange(200, 203),
                            np.arange(590, 600)])[None]
    cell_start, cell_nodes = G.cell_csr(_t(counts), _t(order))
    assert cell_start.dtype == torch.int32 and cell_nodes.dtype == torch.int32
    assert cell_start[0, [0, 1, 41, 42, 63, 64]].tolist() == [0, 200, 200, 587, 587, 590]
    vals, idx = G.grid_knn_cells(_t(coors), cell_start, cell_nodes, k, gdim)
    chunked = G.grid_knn_cells_plain(_t(coors), cell_start, cell_nodes, k, gdim, cell_chunk=5)
    assert torch.equal(vals, chunked[0]) and torch.equal(idx, chunked[1])
    # the first 128 of the pile rank each other by id; the rest have no row
    assert idx[0, 7].tolist() == [0, 1, 2, 3, 4] and (vals[0, :128] == 0).all()
    assert torch.isinf(vals[0, 128:200]).all() and (idx[0, 128:200] == n).all()
    # the corner cell: three candidates, then the pad
    assert sorted(idx[0, 200, :3].tolist()) == [200, 201, 202] and idx[0, 200, 0] == 200
    assert torch.isinf(vals[0, 200, 3:]).all() and (idx[0, 200, 3:] == n).all()
    # cell 41 ranks its own first 128 nodes only
    ev, ei = K.knn_select_plain(_t(coors[:, 203:331]), k)
    assert torch.equal(idx[:, 203:331], ei + 203) and torch.equal(vals[:, 203:331], ev)
    assert torch.isinf(vals[0, 331:]).all() and (idx[0, 331:] == n).all()


def test_grid_cells_order_is_distance_then_node_id():
    """Two cells' worth of coincident points: within equal distances the
    lowest node ids win whatever cell and slot they sit at."""
    rng = np.random.RandomState(3)
    coors = (rng.rand(1, 1024, 3) * 8.0).astype(np.float32)
    coors[0, 900:920] = coors[0, 5]          # high ids tie with node 5 at distance 0
    tv, ti, tok, _ = G.grid_knn_select(_t(coors), 8, gdim=4)
    ev, ei = K.knn_select_plain(_t(coors), 8)
    assert torch.equal(ti, ei) and torch.equal(tv, ev)
    assert ti[0, 910, :8].tolist() == [5] + list(range(900, 907))


def test_grid_cells_ties_across_cells_go_by_node_id():
    """Every distance ties at 0 and the low ids sit in the neighbour cell:
    the winners are the lowest node ids, not the block's first slots."""
    n, k, gdim = 40, 5, 4
    counts = np.zeros((1, gdim ** 3 + 1), np.int64)
    counts[0, [0, 1]] = [10, 30]              # cell 0 holds nodes 30..39, cell 1 nodes 0..29
    order = np.concatenate([np.arange(30, 40), np.arange(30)])[None]
    cell_start, cell_nodes = G.cell_csr(_t(counts), _t(order))
    vals, idx = G.grid_knn_cells(torch.zeros(1, n, 3, dtype=torch.float32), cell_start,
                                 cell_nodes, k, gdim)
    assert torch.equal(idx, torch.arange(k).expand(1, n, k)) and (vals == 0).all()


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------


def _queries(seed, b, n, R, kind="float"):
    rng = np.random.RandomState(seed)
    if kind == "int":
        coors = rng.randint(-4, 5, size=(b, n, 3)).astype(np.float32)
    else:
        coors = (rng.randn(b, n, 3) * 3.0).astype(np.float32)
    mask = rng.rand(b, n) > 0.15
    fidx = rng.randint(0, n, size=(b, R))
    return coors, mask, fidx


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("n,k,R,kind", [
    (300, 6, 40, "float"),     # n not a multiple of the lane width
    (256, 8, 128, "int"),      # distance ties: lowest column first
    (512, 16, 9, "float"),
])
def test_query_kernel_plain_matches_pallas(n, k, R, kind, with_mask):
    coors, mask, fidx = _queries(n + k, 2, n, R, kind)
    m = mask if with_mask else None
    q = np.take_along_axis(coors, fidx[..., None], axis=1)
    qm = None if m is None else np.take_along_axis(m, fidx, axis=1)
    jv, ji = jk.knn_select_queries_pallas(_j(q), _j(coors), k, q_mask=_j(qm), p_mask=_j(m),
                                          interpret=True)
    tv, ti = K.knn_select_queries(_t(q), _t(coors), k, q_mask=_t(qm), p_mask=_t(m))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tol = dict(rtol=0, atol=0) if kind == "int" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64
    # the rows are the exact selection's rows, bit for bit
    ev, ei = K.knn_select_plain(_t(coors), k, _t(m))
    pick = _t(fidx)[..., None].expand(2, R, k)
    assert torch.equal(ti, torch.gather(ei, 1, pick)) and torch.equal(tv, torch.gather(ev, 1, pick))
    cv, ci = K.knn_select_queries_plain(_t(q), _t(coors), k, _t(qm), _t(m), row_chunk=7)
    assert torch.equal(ci, ti) and torch.equal(cv, tv)


def test_query_kernel_masks_come_together():
    q, pts = torch.zeros(1, 4, 3, dtype=torch.float32), torch.zeros(1, 16, 3, dtype=torch.float32)
    with pytest.raises(ValueError):
        K.knn_select_queries(q, pts, 2, q_mask=torch.ones(1, 4, dtype=torch.bool))


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


def _window_inputs(coors, mask, fidx):
    """The dispatcher's preparation: the x-sort (masked points last), the
    nodes' x-ranks, and the query rows sorted by rank."""
    xkey = coors[..., 0] if mask is None else np.where(mask, coors[..., 0], np.inf)
    order = np.argsort(xkey, axis=1, kind="stable").astype(np.int32)
    pts_s = np.take_along_axis(coors, order[..., None], axis=1)
    pm_s = None if mask is None else np.take_along_axis(mask, order, axis=1)
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(coors.shape[1], dtype=np.int32)[None], axis=1)
    qr = np.take_along_axis(rank, fidx, axis=1)
    fidx = np.take_along_axis(fidx, np.argsort(qr, axis=1, kind="stable"), axis=1)
    q = np.take_along_axis(coors, fidx[..., None], axis=1)
    return q, np.take_along_axis(rank, fidx, axis=1), pts_s, order, pm_s, fidx


def _window_both(q, qr, pts_s, order, k, W, pm_s):
    jv, ji, jm = jk.knn_select_window_pallas(_j(q), _j(qr), _j(pts_s), _j(order), k, W,
                                             p_mask_sorted=_j(pm_s), interpret=True)
    tv, ti, tm = K.knn_select_window(_t(q), _t(qr), _t(pts_s), _t(order), k, W,
                                     p_mask_sorted=_t(pm_s))
    return (jv, ji, jm), (tv, ti, tm)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("n,k,R,W,kind", [
    (256, 6, 64, 256, "float"),      # the full width: every margin infinite
    (2048, 8, 256, 512, "float"),    # W = n / 4
    (1000, 5, 100, 256, "float"),    # n not a multiple of the lane width
    (1000, 5, 77, 1024, "float"),    # the full lane-padded width at such an n
    (512, 8, 96, 128, "int"),        # distance ties: lowest original id first
])
def test_window_kernel_plain_matches_pallas(n, k, R, W, kind, with_mask):
    rng = np.random.RandomState(n + W + k)
    if kind == "int":
        coors = rng.randint(-4, 5, size=(2, n, 3)).astype(np.float32)
    else:
        coors = rng.randn(2, n, 3).astype(np.float32)
    mask = rng.rand(2, n) > 0.15 if with_mask else None
    valid = np.ones((2, n), bool) if mask is None else mask
    # R valid rows of each cloud
    fidx = np.stack([rng.permutation(np.nonzero(valid[bi])[0])[:R] for bi in range(2)])
    q, qr, pts_s, order, pm_s, fidx = _window_inputs(coors, mask, fidx)
    (jv, ji, jm), (tv, ti, tm) = _window_both(q, qr, pts_s, order, k, W, pm_s)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy().view(np.int32), np.asarray(jm).view(np.int32))
    tol = dict(rtol=0, atol=0) if kind == "int" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64 and tm.dtype == torch.float32
    # certified rows are the exact selection's rows, bit for bit
    cert = tv[..., k - 1] < tm * tm
    if mask is not None:
        cert &= tv[..., k - 1] < 1e5
    if W >= n:
        assert torch.isinf(tm).all() and cert.all()
    elif kind == "float":
        assert cert.float().mean() > 0.3
    ev, ei = K.knn_select_plain(_t(coors), k, _t(mask))
    pick = _t(fidx)[..., None].expand(2, R, k)
    assert torch.equal(ti[cert], torch.gather(ei, 1, pick)[cert])
    assert torch.equal(tv[cert], torch.gather(ev, 1, pick)[cert])
    cv, ci, cm = K.knn_select_window_plain(_t(q), _t(qr), _t(pts_s), _t(order), k, W, _t(pm_s),
                                           row_chunk=11)
    assert torch.equal(ci, ti) and torch.equal(cv, tv) and torch.equal(cm, tm)


def test_window_group_height_matches_the_reference():
    for W, n_pad, R in [(128, 1024, 64), (256, 1024, 1024), (512, 2048, 256), (4096, 16384, 1024),
                        (16384, 65536, 4096), (16384, 65536, 3100), (32768, 131072, 8192),
                        (256, 1024, 5)]:
        assert K._pick_ti_window(W, n_pad, R) == jk._pick_ti_window(W, n_pad, R), (W, n_pad, R)


def test_window_kernel_refuses_a_window_without_k_columns():
    """n = 129 pads to 256: a 128-wide window at the padded end holds one
    real column."""
    q = torch.zeros(1, 8, 3, dtype=torch.float32)
    pts = torch.zeros(1, 129, 3, dtype=torch.float32)
    ranks, ids = torch.zeros(1, 8, dtype=torch.int64), torch.arange(129)[None]
    with pytest.raises(ValueError):
        K.knn_select_window(q, ranks, pts, ids, 4, 128)
    with pytest.raises(ValueError):
        K.knn_select_window(q, ranks, pts, ids, 4, 100)    # not a multiple of 128
    assert K.knn_select_window(q, ranks, pts, ids, 4, 256)[1].shape == (1, 8, 4)


# ---------------------------------------------------------------------------
# K7's traversal on the card (its CPU model)
# ---------------------------------------------------------------------------


def _model_counts_hold(counts, cell_start, gdim):
    """The model's steps are every query's steps over its block; every
    query merges at least once (its own node is a candidate)."""
    cells = gdim ** 3
    q_count = (cell_start[0, 1:cells + 1] - cell_start[0, :cells]).clamp(0, G.M_CAP)
    nb = _block_candidates(cell_start, gdim)
    steps = int((q_count * ((nb + 127) // 128)).sum())
    assert counts["steps"] == steps
    assert 0 < counts["votes"] <= counts["steps"]
    assert counts["merges"] >= int(q_count.sum())


def _block_candidates(cell_start, gdim):
    """Real candidates of each cell's block: its 27 cells' first 128 nodes."""
    cells = gdim ** 3
    per_cell = (cell_start[0, 1:cells + 1] - cell_start[0, :cells]).clamp(0, G.M_CAP)
    padded = torch.cat([per_cell, per_cell.new_zeros(1)])
    return padded[neighbor_cells(gdim)].sum(dim=-1)


@pytest.mark.parametrize("k", [1, 16, 32, 33, 48, 64, 65, 128])
def test_grid_model_edges_match_plain(k):
    """A cell of one node, a cell of exactly 128, cells beyond 128, nodes in
    no cell, query counts that are no multiple of the warps, one to four
    list slots: the model's steps give the plain version's selection bit for
    bit."""
    n, gdim = 900, 4
    rng = np.random.RandomState(k)
    coors = rng.rand(1, n, 3).astype(np.float32)
    coors[0, 300:340] = coors[0, 7]               # a pile of ties at distance 0
    counts = np.zeros((1, gdim ** 3 + 1), np.int64)
    counts[0, [0, 1, 5, 21, 22, 42, 63]] = [1, 61, 128, 200, 150, 129, 221]
    order = rng.permutation(n)[None]
    cell_start, cell_nodes = G.cell_csr(_t(counts), _t(order))
    v, i, cnt = G.grid_knn_cells_model(_t(coors), cell_start, cell_nodes, k, gdim)
    pv, pi = G.grid_knn_cells_plain(_t(coors), cell_start, cell_nodes, k, gdim)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    _model_counts_hold(cnt, cell_start, gdim)
    # the cell of one node ranks its block (cells 1 and 5 are its
    # neighbours): itself, or a copy of it, at distance 0 first
    node = int(order[0, 0])
    assert v[0, node, 0] == 0 and torch.isfinite(v[0, node]).all()


@pytest.mark.parametrize("seed,n,k,kind,with_mask", [
    (0, 1024, 8, "uniform", False),
    (1, 2048, 16, "gaussian", True),
    (2, 1000, 5, "uniform", True),
    (3, 1000, 6, "lattice", False),   # six neighbours at d^2 = 1: ties by node id
    (4, 1024, 4, "pile", False),      # 128 copies of 8 sites: cells of exactly 128
])
def test_grid_model_matches_pallas(monkeypatch, seed, n, k, kind, with_mask):
    """The whole grid selection with the model in place of K7's plain
    version against the TPU kernel in interpret mode."""
    if kind == "lattice":
        coors, mask = _lattice(), None
    elif kind == "pile":
        base = np.random.RandomState(seed).rand(8, 3).astype(np.float32)
        coors, mask = np.tile(base, (128, 1))[None], None
    elif kind == "gaussian":
        rng = np.random.RandomState(seed)
        coors = (rng.randn(1, n, 3) * 3.0).astype(np.float32)
        mask = rng.rand(1, n) > 0.1 if with_mask else None
    else:
        coors, mask = _uniform(seed, 1, n, with_mask=with_mask)
    counts = []

    def model(c, s, m, kk, gdim):
        v, i, cnt = G.grid_knn_cells_model(c, s, m, kk, gdim)
        counts.append(cnt)
        return v, i

    monkeypatch.setattr(G, "grid_knn_cells_plain", model)
    jout, tout = _grid_both(coors, k, mask)
    _assert_grid_same(jout, tout, exact_vals=kind in ("lattice", "pile"))
    assert len(counts) == 1 and 0 < counts[0]["votes"] <= counts[0]["steps"]


# ---------------------------------------------------------------------------
# K9's traversal on the card (the block kernel over windows, its CPU model)
# ---------------------------------------------------------------------------


def _window_case(seed, n, R, kind, with_mask):
    """A batch of two clouds, R valid query rows of each, prepared as the
    dispatcher does (``_window_inputs``)."""
    rng = np.random.RandomState(seed)
    if kind == "int":
        coors = rng.randint(-4, 5, size=(2, n, 3)).astype(np.float32)
    else:
        coors = rng.randn(2, n, 3).astype(np.float32)
    mask = rng.rand(2, n) > 0.15 if with_mask else None
    valid = np.ones((2, n), bool) if mask is None else mask
    fidx = np.stack([rng.permutation(np.nonzero(valid[bi])[0])[:R] for bi in range(2)])
    return _window_inputs(coors, mask, fidx)


def _window_model(q, qr, pts_s, order, k, W, pm_s, rows, stripes):
    """The CPU model of K9 at the host's plan of the windows (group height,
    starts): (vals, idx, counts, ti)."""
    q, qr, pts_s, order, pm_s = (_t(x) for x in (q, qr, pts_s, order, pm_s))
    ti, starts, _ = K._window_plan(q, qr, pts_s, k, W, pm_s)
    v, i, counts = K.knn_select_block_model(pts_s, k, pm_s, None, 0, rows, None, q, None,
                                            stripes, window=(starts, ti, W, order))
    return v, i, counts, ti


@pytest.mark.parametrize("n,k,R,W,kind,with_mask,rows,stripes,ti", [
    (2048, 16, 256, 256, "float", True, 1, 1, 8),    # eight rows a block, one group
    (2048, 16, 256, 256, "int", False, 1, 4, 8),     # distance ties by id; four warps a row
    (1000, 1, 100, 256, "int", True, 1, 8, 8),       # k = 1; eight warps a row
    (1024, 16, 128, 1024, "float", True, 4, 1, 32),  # the whole width; 32 rows a block
    (3000, 48, 400, 1024, "float", True, 2, 2, 32),  # windows clipped at n = 3000; two slots
    (2048, 48, 256, 1024, "int", True, 2, 1, 32),    # ties under a mask
])
def test_window_model_matches_plain(n, k, R, W, kind, with_mask, rows, stripes, ti):
    """K9's steps (a block's rows in one group, its window's tiles, the ids as
    the packed values' low words, the masked pairs' pre-test on the ids)
    give the plain version's selection bit for bit."""
    q, qr, pts_s, order, pm_s, _ = _window_case(n + k + W, n, R, kind, with_mask)
    v, i, counts, got_ti = _window_model(q, qr, pts_s, order, k, W, pm_s, rows, stripes)
    assert got_ti == ti
    pv, pi, _ = K.knn_select_window_plain(_t(q), _t(qr), _t(pts_s), _t(order), k, W, _t(pm_s))
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    assert 0 < counts["votes"] <= counts["steps"]
    n_rows = -(-R // (8 // stripes * rows)) * (8 // stripes * rows)
    assert counts["merges"] == 2 * n_rows * (stripes - 1)


def test_window_model_takes_any_start():
    """Windows that start on any column (none a multiple of 4) and run past
    n: the model against the plain selection at the same starts."""
    n, k, R, W, ti = 700, 6, 40, 256, 8
    q, qr, pts_s, order, pm_s, _ = _window_case(3, n, R, "int", True)
    q, pts_s, order, pm_s = (_t(x) for x in (q, pts_s, order, pm_s))
    starts = torch.tensor([[1, 3, 250, 445, 599], [7, 190, 201, 301, 443]])
    v, i, _ = K.knn_select_block_model(pts_s, k, pm_s, None, 0, 1, None, q, None, 2,
                                       window=(starts, ti, W, order))
    pv, pi = K._window_select_plain(q, pts_s, order, k, W, pm_s, ti, starts, None)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    with pytest.raises(ValueError):   # a block's 16 rows span two groups of 8
        K.knn_select_block_model(pts_s, k, pm_s, None, 0, 2, None, q, None, 1,
                                 window=(starts, ti, W, order))


@pytest.mark.parametrize("n,k,R,W,kind,with_mask,rows,stripes", [
    (2048, 16, 256, 256, "int", True, 1, 2),
    (1000, 5, 100, 512, "float", False, 1, 1),
])
def test_window_model_matches_pallas(n, k, R, W, kind, with_mask, rows, stripes):
    q, qr, pts_s, order, pm_s, _ = _window_case(n + k, n, R, kind, with_mask)
    (jv, ji, _), _ = _window_both(q, qr, pts_s, order, k, W, pm_s)
    v, i, _, _ = _window_model(q, qr, pts_s, order, k, W, pm_s, rows, stripes)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    tol = dict(rtol=0, atol=0) if kind == "int" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **tol)
