"""The port's ``khop_neighbor_lists`` against ``egnn_tpu``'s, bit for bit
(ids, degrees and mask, the rows' order and their truncation at
``cap_out``), and against a dense BFS, as ``tests/test_khop.py`` holds the
JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops import khop_neighbor_lists as jax_khop
from egnn_tpu_torch.ops import khop_neighbor_lists


def _dense_bfs(adj, D):
    """Least hop counts 1..D along directed edges, self excluded."""
    n = adj.shape[0]
    dist = np.zeros((n, n), np.int32)
    reach = np.eye(n, dtype=bool)
    frontier = np.eye(n, dtype=bool)
    for d in range(1, D + 1):
        nxt = (frontier.astype(np.int32) @ adj.astype(np.int32)) > 0
        new = nxt & ~reach
        dist[new] = d
        reach |= new
        frontier = new
    np.fill_diagonal(dist, 0)
    return dist


def _lists_from_adj(adj, c0):
    n = adj.shape[0]
    nbr = np.zeros((n, c0), np.int32)
    msk = np.zeros((n, c0), bool)
    for i in range(n):
        js = np.nonzero(adj[i])[0]
        nbr[i, : len(js)] = js
        msk[i, : len(js)] = True
    return nbr, msk


def _both(nbr, msk, D, cap_out=None):
    got = khop_neighbor_lists(torch.from_numpy(nbr),
                              None if msk is None else torch.from_numpy(msk), D, cap_out)
    ref = jax_khop(jnp.asarray(nbr), None if msk is None else jnp.asarray(msk), D, cap_out)
    for t, j in zip(got, ref):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), j)
    return [t.numpy() for t in got]


@pytest.mark.parametrize("seed,n,p,D", [(0, 30, 0.1, 2), (1, 40, 0.08, 3),
                                        (2, 25, 0.15, 4), (3, 50, 0.05, 3)])
def test_khop_matches_jax_and_dense_bfs(seed, n, p, D):
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < p
    np.fill_diagonal(adj, False)
    nbr, msk = _lists_from_adj(adj, max(int(adj.sum(1).max()), 1))
    ids, deg, mask = _both(nbr, msk, D)
    got = np.zeros((n, n), np.int32)
    for i in range(n):
        got[i, ids[i, mask[i]]] = deg[i, mask[i]]
        assert (np.diff(ids[i, mask[i]]) > 0).all()
    np.testing.assert_array_equal(got, _dense_bfs(adj, D))
    assert (ids[~mask] == n).all() and (deg[~mask] == 0).all()


@pytest.mark.parametrize("cap_out", [5, 1, 19])
def test_khop_truncation_keeps_lowest_ids(cap_out):
    n = 20
    adj = np.zeros((n, n), bool)
    adj[0, 1:] = True
    adj[7, [3, 12, 19]] = True
    nbr, msk = _lists_from_adj(adj, n - 1)
    ids, deg, mask = _both(nbr, msk, 2, cap_out=cap_out)
    assert mask[0].sum() == min(cap_out, n - 1)
    np.testing.assert_array_equal(ids[0][mask[0]], np.arange(1, 1 + min(cap_out, n - 1)))


def test_khop_chain_degrees():
    n, D = 12, 4
    nbr = np.minimum(np.arange(n) + 1, n - 1).astype(np.int32)[:, None]
    msk = (np.arange(n) < n - 1)[:, None]
    ids, deg, mask = _both(nbr, msk, D)
    row = {int(i): int(d) for i, d, m in zip(ids[0], deg[0], mask[0]) if m}
    assert row == {i: i for i in range(1, D + 1)}


def test_khop_no_mask_means_all_valid_and_ties_of_knn_lists():
    """Unmasked lists with repeats and self ids (what a kNN builder's rows
    hold where points coincide) give the JAX rows bit for bit."""
    n = 16
    rng = np.random.default_rng(5)
    nbr = rng.integers(0, n, (n, 4)).astype(np.int32)
    a = _both(nbr, None, 2)
    b = _both(nbr, np.ones((n, 4), bool), 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    _both(nbr, None, 3, cap_out=7)


def test_khop_int64_lists_and_bad_degrees():
    nbr = torch.tensor([[1], [2], [0]], dtype=torch.int64)
    ids, deg, mask = khop_neighbor_lists(nbr, None, 2)
    assert ids.dtype == torch.int32 and ids.shape == (3, 2)
    with pytest.raises(ValueError):
        khop_neighbor_lists(nbr, None, 0)
