"""The port's kNN selection (kernels K1 and K3 and their dispatcher) against
the JAX package.

On the CPU the port's wrappers run the kernels' plain versions, which
``chip_smoke.py`` holds the CUDA kernels against bitwise on the card. Here
the plain versions meet the TPU kernels themselves, in Pallas interpret
mode, in float32: indices exact, payload rows bitwise, ranking values at
rtol = atol = 1e-6 (XLA's interpret path rounds the squared distances up to
one ulp apart from a coordinate-by-coordinate sum).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops import neighbors as jnb
from egnn_tpu.ops.pallas.knn import knn_select_gather_pallas, knn_select_pallas
from egnn_tpu_torch.ops import neighbors as tnb
from egnn_tpu_torch.ops.cuda import knn as K


def _case(seed, b, n, with_mask, with_adj, ties=False, dtype=np.float32):
    rng = np.random.RandomState(seed)
    if ties:  # 4 distinct points, each repeated: every distance ties
        coors = np.tile(np.arange(4)[:, None], (1, 3))[None].repeat(n // 4, axis=0)
        coors = coors.reshape(1, n, 3).repeat(b, axis=0).astype(dtype)
    else:
        coors = rng.randint(-8, 8, size=(b, n, 3)).astype(dtype)
    mask = rng.rand(b, n) > 0.2 if with_mask else None
    adj = None
    if with_adj:
        ar = np.arange(n)
        adj = np.zeros((b, n, n), dtype=bool)
        adj[:, ar[:-1], ar[1:]] = True
        adj[:, ar[1:], ar[:-1]] = True
        extra = rng.rand(b, n, n) < 0.01
        adj |= extra | np.swapaxes(extra, 1, 2)
    payload = rng.randn(b, n, 6).astype(dtype)
    return coors, mask, adj, payload


def _table(coors, mask, payload):
    parts = [coors] + ([mask[..., None].astype(coors.dtype)] if mask is not None else [])
    return np.concatenate(parts + [payload], axis=-1)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n,k", [(128, 8), (200, 1)])
@pytest.mark.parametrize("with_mask,with_adj",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_knn_select_gather_plain_matches_pallas(n, k, with_mask, with_adj):
    coors, mask, adj, payload = _case(n * 31 + k, 2, n, with_mask, with_adj)
    table = _table(coors, mask, payload)
    jv, ji, jg = knn_select_gather_pallas(
        _j(coors), k, _j(table), mask=_j(mask), adj_mat=_j(adj), interpret=True)
    tv, ti, tg = K.knn_select_gather(_t(coors), k, _t(table), _t(mask), _t(adj))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64


@pytest.mark.parametrize("n,k", [(128, 8), (200, 1)])
@pytest.mark.parametrize("with_mask,with_adj", [(False, False), (True, True)])
def test_knn_select_plain_matches_pallas(n, k, with_mask, with_adj):
    coors, mask, adj, _ = _case(n * 17 + k, 2, n, with_mask, with_adj)
    jv, ji = knn_select_pallas(_j(coors), k, mask=_j(mask), adj_mat=_j(adj), interpret=True)
    tv, ti = K.knn_select(_t(coors), k, _t(mask), _t(adj))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["gather", "select"])
def test_tie_pileup_lowest_index_first(which):
    """Duplicate coordinates and the adjacency's 0 fill make large tie groups:
    the lowest j must win each, as in the TPU kernels."""
    n, k = 128, 9
    coors, mask, adj, payload = _case(3, 1, n, True, True, ties=True)
    if which == "gather":
        table = _table(coors, mask, payload)
        _, ji, jg = knn_select_gather_pallas(
            _j(coors), k, _j(table), mask=_j(mask), adj_mat=_j(adj), interpret=True)
        _, ti, tg = K.knn_select_gather(_t(coors), k, _t(table), _t(mask), _t(adj))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    else:
        _, ji = knn_select_pallas(_j(coors), k, mask=_j(mask), adj_mat=_j(adj),
                                  interpret=True)
        _, ti = K.knn_select(_t(coors), k, _t(mask), _t(adj))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("with_mask,with_adj", [(False, False), (True, True)])
def test_dispatcher_matches_jax_float64(with_mask, with_adj):
    """``knn_select_gather`` on CPU float64 against the JAX dispatcher's CPU
    path: same neighbourhood, validity and gathered [coors | mask | payload]."""
    n, k, radius = 96, 8, 30.0
    coors, mask, adj, payload = _case(7, 2, n, with_mask, with_adj, dtype=np.float64)
    coors = coors + np.random.RandomState(8).randn(*coors.shape) * 0.1
    jn, jg = jnb.knn_select_gather(_j(coors), k, radius, mask=_j(mask), adj_mat=_j(adj),
                                   payload=_j(payload))
    tn, tg = tnb.knn_select_gather(_t(coors), k, radius, mask=_t(mask), adj_mat=_t(adj),
                                   payload=_t(payload))
    np.testing.assert_array_equal(tn.indices.numpy(), np.asarray(jn.indices))
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(jn.valid))
    np.testing.assert_allclose(tn.ranking.numpy(), np.asarray(jn.ranking), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    sel = tnb.knn_select(_t(coors), k, radius, mask=_t(mask), adj_mat=_t(adj))
    np.testing.assert_array_equal(sel.indices.numpy(), np.asarray(jn.indices))


def test_ranking_fill_order_matches_jax():
    """Mask fill first, then self -1 and adjacent 0: a masked node adjacent
    to i still ranks 0."""
    n = 12
    coors, mask, adj, _ = _case(11, 2, n, True, True, dtype=np.float64)
    mask[:, 3] = False
    adj[:, 2, 3] = adj[:, 3, 2] = True
    _, jd = jnb.pairwise_geometry(_j(coors))
    jr = jnb.knn_ranking(jd, mask=_j(mask), adj_mat=_j(adj))
    _, td = tnb.pairwise_geometry(_t(coors))
    tr = tnb.knn_ranking(td, mask=_t(mask), adj_mat=_t(adj))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tr[0, 2, 3] == 0.0 and tr[0, 3, 3] == -1.0


def test_expanded_adjacency_matches_batched():
    """An (n, n) adjacency expanded over the batch selects as its copy does."""
    n, k = 64, 8
    coors, mask, adj, payload = _case(5, 3, n, True, True)
    table = _t(_table(coors, mask, payload))
    shared = _t(adj[0]).expand(3, n, n)
    a = K.knn_select_gather(_t(coors), k, table, _t(mask), shared)
    b = K.knn_select_gather(_t(coors), k, table, _t(mask), shared.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_later_backends_raise():
    """Every backend of the reference is ported: the full-band and fused
    routes (tests/test_torch_dispatch_backends.py), the tiled and packed
    routes (tests/test_torch_knn_large.py) and the grid route
    (tests/test_torch_grid_dispatch.py); an unknown name raises."""
    coors = torch.zeros(1, 16, 3, dtype=torch.float32)
    with pytest.raises(ValueError):
        tnb.knn_select(coors, 4, math.inf, backend="mosaic")
    for backend in ("fused", "pallas", "tiled", "packed", "packed_tiled", "grid"):
        assert tnb.knn_select(coors, 4, math.inf, backend=backend).indices.shape == (1, 16, 4)


def test_expand_adjacency_degrees_matches_jax():
    n = 10
    ar = np.arange(n)
    adj = np.abs(ar[:, None] - ar[None, :]) == 1
    adj = np.broadcast_to(adj, (2, n, n))
    for degrees in (1, 2, 3):
        ja, ji = jnb.expand_adjacency_degrees(jnp.asarray(adj), degrees)
        ta, ti = tnb.expand_adjacency_degrees(_t(adj), degrees)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_max_degree_matches_jax():
    adj = np.random.RandomState(0).rand(2, 20, 20) < 0.2
    assert tnb.max_degree(_t(adj)) == jnb.max_degree(jnp.asarray(adj))


@pytest.mark.parametrize("with_mask,with_adj", [(False, False), (True, True)])
def test_gather_grad_matches_jax_float64(with_mask, with_adj):
    """The gathered rows' backward (the table's gradient, summed over the
    selected indices) reaches coors and the payload as jax.grad through the
    JAX dispatcher does; selection itself is not differentiated."""
    import jax

    n, k = 64, 8
    coors, mask, adj, payload = _case(13, 2, n, with_mask, with_adj, dtype=np.float64)
    coors = coors + np.random.RandomState(14).randn(*coors.shape) * 0.1
    tw = 3 + (1 if with_mask else 0) + payload.shape[-1]
    w = np.random.RandomState(15).randn(2, n, k, tw)

    def jloss(c, p):
        _, g = jnb.knn_select_gather(c, k, math.inf, mask=_j(mask), adj_mat=_j(adj), payload=p)
        return (g * jnp.asarray(w)).sum()

    jc, jp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(coors), jnp.asarray(payload))
    tc, tp = _t(coors).requires_grad_(), _t(payload).requires_grad_()
    nbhd, g = tnb.knn_select_gather(tc, k, math.inf, mask=_t(mask), adj_mat=_t(adj), payload=tp)
    assert not nbhd.indices.requires_grad and not nbhd.ranking.requires_grad
    (g * _t(w)).sum().backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jc), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp), rtol=0, atol=1e-10)


def test_gather_gradcheck_float64():
    n, k = 24, 4
    coors, mask, adj, payload = _case(16, 2, n, True, True, dtype=np.float64)
    coors = coors + np.random.RandomState(17).randn(*coors.shape) * 0.1
    tc, tp = _t(coors).requires_grad_(), _t(payload).requires_grad_()

    def rows(c, p):
        return tnb.knn_select_gather(c, k, math.inf, mask=_t(mask), adj_mat=_t(adj),
                                     payload=p)[1]

    assert torch.autograd.gradcheck(rows, (tc, tp))
