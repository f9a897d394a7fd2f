"""The port's spatial grid (``egnn_tpu_torch/ops/spatial.py``) against the
JAX package's (``egnn_tpu/ops/spatial.py``), on the CPU in float32: the grid
geometry, and the plain grid selection with its certificate over the cases
of ``tests/test_spatial.py``.

Tolerances. ``cid``, ``pos``, ``counts``, ``idx``, ``ok`` and ``row_exact``
are exact; ``margin`` is bitwise (one subtraction and one product per
face). ``vals`` agree at rtol = atol = 1e-6: XLA may contract the sum of
three squares into an FMA, the port sums coordinate by coordinate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops import spatial as js
from egnn_tpu_torch.ops import spatial as ts
from egnn_tpu_torch.ops.cuda import knn as K


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _cloud(seed, b, n, scale=10.0, kind="uniform", with_mask=False, keep=0.85):
    rng = np.random.RandomState(seed)
    draw = rng.rand if kind == "uniform" else rng.randn
    coors = (draw(b, n, 3) * scale).astype(np.float32)
    mask = rng.rand(b, n) < keep if with_mask else None
    return coors, mask


def _pileup(tiles):
    base = np.random.RandomState(0).rand(8, 3).astype(np.float32)
    return np.tile(base, (tiles, 1))[None]


def _both(coors, k, mask=None, **kw):
    jout = js.grid_knn_select(_j(coors), k, mask=_j(mask), **kw)
    tout = ts.grid_knn_select(_t(coors), k, mask=_t(mask), **kw)
    return jout, tout


def _assert_same(jout, tout):
    jv, ji, jok, jrx = jout
    tv, ti, tok, trx = tout
    assert bool(tok) == bool(jok)
    np.testing.assert_array_equal(trx.numpy(), np.asarray(jrx))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64 and trx.dtype == torch.bool


@pytest.mark.parametrize("n,occupancy,m_cap", [
    (128, 1.0, 1), (512, 12.0, None), (777, 12.0, None), (1024, 12.0, None),
    (2048, 24.0, None), (4096, 72.0, None), (8191, 24.0, 7), (65536, 8.0, None),
])
def test_grid_dims_match_the_reference(n, occupancy, m_cap):
    assert ts.grid_dims(n, occupancy, m_cap) == js.grid_dims(n, occupancy, m_cap)
    assert ts.grid_dims(n) == js.grid_dims(n)


@pytest.mark.parametrize("gdim", [3, 4, 6])
def test_neighbor_cells_match_the_reference(gdim):
    np.testing.assert_array_equal(ts.neighbor_cells(gdim).numpy(),
                                  np.asarray(js._neighbor_cells(gdim)))


@pytest.mark.parametrize("seed,n,gdim,kind,with_mask", [
    (0, 1024, 4, "uniform", False),
    (1, 1000, 4, "uniform", True),
    (2, 2048, 5, "gaussian", True),
    (3, 777, 3, "gaussian", False),
    (4, 512, 6, "uniform", True),
])
def test_cell_assignment_matches_the_reference(seed, n, gdim, kind, with_mask):
    coors, mask = _cloud(seed, 2, n, kind=kind, with_mask=with_mask)
    valid = np.ones((2, n), bool) if mask is None else mask
    cid, pos, counts, margin = ts.cell_assignment(_t(coors), _t(valid), gdim)
    for bi in range(2):
        jcid, jpos, jcounts, jmargin = js.cell_assignment(_j(coors[bi]), _j(valid[bi]), gdim)
        np.testing.assert_array_equal(cid[bi].numpy(), np.asarray(jcid))
        np.testing.assert_array_equal(pos[bi].numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(counts[bi].numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(margin[bi].numpy().view(np.int32),
                                      np.asarray(jmargin).view(np.int32))
    # equal-mass edges: every cell of a Gaussian cloud holds about n / G
    assert counts[:, :gdim ** 3].max() <= 4 * max(1, valid.sum(1).max() // gdim ** 3) + 8


def test_cell_assignment_slots_follow_node_order():
    """Every node in one place: the slots of the one occupied cell are the
    node ids (a stable sort), and ``order`` lists masked nodes last."""
    coors = np.ones((1, 64, 3), np.float32)
    valid = np.ones((1, 64), bool)
    valid[0, [3, 40]] = False
    cid, pos, counts, _ = ts.cell_assignment(_t(coors), _t(valid), 4)
    order = ts.assign_cells(_t(coors), _t(valid), 4)[3]
    assert len(set(cid[0][valid[0]].tolist())) == 1
    assert pos[0][valid[0]].tolist() == list(range(62))
    assert order[0, :62].tolist() == [i for i in range(64) if valid[0, i]]
    assert order[0, 62:].tolist() == [3, 40] and cid[0, 3] == 64 and counts[0, 64] == 0


@pytest.mark.parametrize("seed,b,n,k,with_mask", [
    (0, 1, 1024, 8, False),
    (1, 2, 2048, 16, False),
    (2, 1, 1024, 8, True),
    (3, 1, 1000, 5, True),   # n not a power of two
])
def test_grid_knn_certified_uniform_clouds(seed, b, n, k, with_mask):
    coors, mask = _cloud(seed, b, n, with_mask=with_mask)
    jout, tout = _both(coors, k, mask)
    _assert_same(jout, tout)
    assert bool(tout[2]), "a uniform cloud certifies"
    ev, ei = K.knn_select_plain(_t(coors), k, _t(mask))
    assert torch.equal(tout[1], ei) and torch.equal(tout[0], ev)


def test_grid_knn_duplicate_pileup_is_rejected():
    """8 sites, 512 nodes each: the cells overflow, no row is trusted."""
    jout, tout = _both(_pileup(512), 4)
    _assert_same(jout, tout)
    assert not bool(tout[2]) and not tout[3].any()


def test_grid_knn_static_rejects():
    coors, _ = _cloud(1, 1, 128, scale=1.0)
    jout, tout = _both(coors, 64, occupancy=1.0, m_cap=1)   # 27 slots cannot hold k
    _assert_same(jout, tout)
    assert not bool(tout[2])
    coors, _ = _cloud(1, 1, 512, scale=1.0)            # gdim 3: a corner's block covers 8 cells
    jout, tout = _both(coors, 8)
    _assert_same(jout, tout)
    assert not bool(tout[2]) and (tout[0] == 1e5).all()
    assert torch.equal(tout[1][0, 7], torch.arange(8))
    with pytest.raises(ValueError):
        ts.grid_knn_select(torch.zeros(1, 256, 2, dtype=torch.float32), 4)


def test_grid_knn_masked_rows_take_the_fill():
    coors, _ = _cloud(2, 1, 2048, scale=4.0)
    mask = np.ones((1, 2048), bool)
    mask[0, :190] = False
    jout, tout = _both(coors, 6, mask)
    _assert_same(jout, tout)
    assert bool(tout[2])
    assert (tout[0][0, :190] == 1e5).all()
    assert torch.equal(tout[1][0, :190], torch.arange(6).expand(190, 6))
    ev, ei = K.knn_select_plain(_t(coors), 6, _t(mask))
    assert torch.equal(tout[1], ei)


def test_grid_knn_masked_fill_regime_is_rejected():
    """Box side 5000: the k-th real neighbour ranks beyond the 1e5 fill, so
    the exact selection prefers masked pairs that the grid leaves out."""
    coors, mask = _cloud(11, 1, 1024, scale=5000.0, with_mask=True, keep=0.9)
    jout, tout = _both(coors, 8, mask)
    _assert_same(jout, tout)
    assert not bool(tout[2])
    # without the mask the same cloud certifies
    _, bare = _both(coors, 8)
    assert bool(bare[2])


def test_grid_knn_anisotropy():
    base, _ = _cloud(3, 1, 4096, scale=1.0)
    mild = base * np.asarray([3.0, 1.0, 2.0], np.float32)
    jout, tout = _both(mild, 8, occupancy=6.0 * 12.0)
    _assert_same(jout, tout)
    assert bool(tout[2]), "mild anisotropy certifies with a boosted occupancy"
    needle = base * np.asarray([100.0, 1.0, 0.01], np.float32)
    jout, tout = _both(needle, 8)
    _assert_same(jout, tout)
    assert not bool(tout[2]), "a needle box fails the certificate"


def test_grid_knn_mixed_batch():
    """Two uniform clouds and a Gaussian one: the call is not certified,
    the rows of the uniform clouds are."""
    uni, _ = _cloud(21, 2, 1024)
    gauss, _ = _cloud(22, 1, 1024, kind="gaussian")
    jout, tout = _both(np.concatenate([uni, gauss]), 8)
    _assert_same(jout, tout)
    assert not bool(tout[2]) and tout[3][:2].all() and not tout[3][2].all()


@pytest.mark.parametrize("seed", range(6))
def test_grid_knn_fuzz_certified_rows_are_exact(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.choice([777, 1024, 1536, 2048]))
    k = int(rng.choice([4, 8, 13]))
    kind = str(rng.choice(["uniform", "gaussian"]))
    coors, mask = _cloud(seed + 50, 1, n, scale=float(rng.choice([0.01, 1.0, 40.0])), kind=kind,
                         with_mask=bool(rng.rand() < 0.5), keep=0.8)
    jout, tout = _both(coors, k, mask)
    _assert_same(jout, tout)
    ev, ei = K.knn_select_plain(_t(coors), k, _t(mask))
    rx = tout[3]
    assert torch.equal(tout[1][rx], ei[rx]) and torch.equal(tout[0][rx], ev[rx])


@pytest.mark.parametrize("n,k", [(1024, 8), (2048, 8)])
def test_grid_knn_integer_lattice_ties(n, k):
    """Nearly every distance ties: rows with a tie group across the k-th
    place are rejected (``cnt_le``), the others keep the exact tie order."""
    side = max(2, int(round(n ** (1 / 3))))
    coors = np.random.RandomState(n + k).randint(0, side, size=(1, n, 3)).astype(np.float32)
    jout, tout = _both(coors, k)
    _assert_same(jout, tout)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))   # integers: exact
    ev, ei = K.knn_select_plain(_t(coors), k)
    rx = tout[3]
    assert torch.equal(tout[1][rx], ei[rx])
