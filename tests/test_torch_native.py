"""The port's host graph runtime (``egnn_tpu_torch/native``, its own copy of
the C++ source, compiled by the test with the host's g++) against
``egnn_tpu.native`` on the same numpy inputs, bit for bit: every function,
the numpy fallbacks, the kNN tie order, and the port's own
``ops.graph.knn_graph`` on the CPU (padding rows aside: the native batched
builder points them at the graph's first node, ``knn_graph`` at node 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu import native as jnat
from egnn_tpu.ops.graph import knn_graph as jax_knn_graph
from egnn_tpu_torch import native as nat
from egnn_tpu_torch.ops.graph import knn_graph


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_native_builds_from_its_own_source():
    assert nat.is_available(), f"native build failed:\n{nat.build_error()}"
    assert nat.build_error() is None and nat.num_threads() >= 1
    assert nat._SRC.parent.name == "native" and nat._SRC.parent.parent.name == "egnn_tpu_torch"
    assert nat._BUILD_DIR.parts[-3:] == ("build", "egnn_tpu_torch", "native")


@pytest.mark.parametrize("n,c,k,masked,loop", [
    (16, 3, 4, False, False), (33, 3, 8, True, False), (100, 5, 8, True, False),
    (24, 3, 6, False, True), (5, 3, 8, True, False)])
def test_knn_matches_jax_native_and_fallback(n, c, k, masked, loop):
    rng = np.random.RandomState(n + k)
    coors = rng.randn(n, c)
    nm = (rng.rand(n) > 0.25) if masked else None
    got = nat.knn_graph_np(coors, k, node_mask=nm, loop=loop)
    _same(got, jnat.knn_graph_np(coors, k, node_mask=nm, loop=loop))
    _same(got, nat._knn_graph_numpy(np.asarray(coors, np.float64), k, nm, loop))
    if k <= n - (0 if loop else 1):
        ref = jax_knn_graph(jnp.asarray(coors), k, node_mask=None if nm is None
                            else jnp.asarray(nm), loop=loop)
        _same(got, tuple(np.asarray(x).astype(g.dtype) for x, g in
                         zip((ref.senders, ref.receivers, ref.mask), got)))


def test_knn_tie_order_against_jax_and_the_ports_knn_graph():
    """Coincident points: equal distances go to the lower index everywhere."""
    coors = np.zeros((8, 3))
    coors[4:] = 1.0
    s, r, m = nat.knn_graph_np(coors, 3)
    ref = jax_knn_graph(jnp.asarray(coors), 3)
    np.testing.assert_array_equal(s, np.asarray(ref.senders))
    np.testing.assert_array_equal(m, np.asarray(ref.mask))
    es = knn_graph(torch.from_numpy(coors), 3)
    np.testing.assert_array_equal(s, es.senders.numpy())
    np.testing.assert_array_equal(r, es.receivers.numpy())
    np.testing.assert_array_equal(m, es.mask.numpy())


@pytest.mark.parametrize("lattice", [False, True], ids=["gaussian", "lattice"])
def test_batched_knn_matches_jax_and_knn_graph(lattice):
    rng = np.random.RandomState(7)
    g, na, c, k = 6, 12, 3, 4
    coors = (rng.randint(0, 3, (g, na, c)).astype(np.float64) if lattice
             else rng.randn(g, na, c))
    nm = rng.rand(g, na) > 0.3
    nm[0, 2:] = False            # a molecule of two atoms: fewer than k others
    got = nat.batched_knn_graph_np(coors, k, node_mask=nm)
    _same(got, jnat.batched_knn_graph_np(coors, k, node_mask=nm))
    s, r, m = got
    es = knn_graph(torch.from_numpy(coors.reshape(g * na, c)), k,
                   node_mask=torch.from_numpy(nm.reshape(-1)), graph_size=na)
    np.testing.assert_array_equal(m, es.mask.numpy())
    np.testing.assert_array_equal(np.where(m, s, 0), es.senders.numpy())
    np.testing.assert_array_equal(np.where(m, r, 0), es.receivers.numpy())
    base = np.repeat(np.arange(g) * na, na * k)
    assert (s[~m] == base[~m]).all() and (r[~m] == base[~m]).all()


@pytest.mark.parametrize("cap", [20, 1600], ids=["tight", "loose"])
def test_radius_matches_jax(cap):
    rng = np.random.RandomState(3)
    coors = rng.randn(40, 3)
    nm = rng.rand(40) > 0.2
    got = nat.radius_graph_np(coors, 1.5, cap, node_mask=nm)
    _same(got, jnat.radius_graph_np(coors, 1.5, cap, node_mask=nm))


def test_sort_edges_and_pack_batch_match():
    rng = np.random.RandomState(1)
    recv = rng.randint(0, 25, size=300).astype(np.int32)
    mask = rng.rand(300) > 0.3
    for m in (mask, None):
        perm = nat.sort_edges_by_receiver_np(recv, m, 25)
        np.testing.assert_array_equal(perm, jnat.sort_edges_by_receiver_np(recv, m, 25))
        key = recv if m is None else np.where(m, recv, 25)
        np.testing.assert_array_equal(perm, np.argsort(key, kind="stable"))
    sizes = np.array([3, 5, 0, 2])
    _same(nat.pack_batch_np(sizes, 6), jnat.pack_batch_np(sizes, 6))
    with pytest.raises(ValueError):
        nat.pack_batch_np(np.array([7]), 6)
