"""The port's graph builders (``egnn_tpu_torch/ops/graph.py``) against
``egnn_tpu.ops.graph`` on the CPU, where the kNN selection's plain version
runs: senders, receivers and masks bitwise.

Coordinates lie on a small integer lattice, so that distances tie many
times over and points repeat (zero distances besides the self pair): both
sides must break every tie the same way, the lowest node id first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops import graph as jg
from egnn_tpu_torch.ops import graph as tg


def _lattice(seed, n, c=3, side=3):
    return np.random.RandomState(seed).randint(0, side, size=(n, c)).astype(np.float64)


def _same(es_t, es_j):
    for name in ("senders", "receivers", "mask"):
        t, j = getattr(es_t, name).numpy(), np.asarray(getattr(es_j, name))
        assert t.shape == j.shape and np.array_equal(t, j), name
    assert np.array_equal(es_t.edge_index.numpy(), np.asarray(es_j.edge_index))


def _both(fn_name, arrays, **kw):
    """The builder on both sides; numpy arrays in ``arrays`` become tensors.
    The JAX side runs under jit (eager dispatch compiles op by op), with
    ``batch`` closed over as a constant: concrete, so that the JAX package
    derives its caps from it as it does outside jit."""
    to_t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    traced = {k: jnp.asarray(v) for k, v in arrays.items() if k != "batch"}
    if "batch" in arrays:
        kw_j = dict(kw, batch=jnp.asarray(arrays["batch"]))
    else:
        kw_j = kw
    fn_j = jax.jit(lambda **a: getattr(jg, fn_name)(**a, **kw_j))
    return getattr(tg, fn_name)(**to_t, **kw), fn_j(**traced)


def _ragged_batch(rng, sizes):
    return np.repeat(np.arange(len(sizes)), sizes)


ROUTES = ["one_graph", "graph_size", "ragged", "ragged_caps"]


def _route_args(route, seed, with_mask):
    """coors, node_mask and the batch arguments of one route."""
    rng = np.random.RandomState(seed)
    if route == "one_graph":
        n, extra = 40, {}
    elif route == "graph_size":
        n, extra = 48, dict(graph_size=12)
    else:
        sizes = [9, 1, 14, 3, 13]          # a graph of one node, and graphs of m <= k
        n = sum(sizes)
        extra = dict(batch=_ragged_batch(rng, sizes))
        if route == "ragged_caps":
            extra.update(max_graph_size=16, max_graphs=6)   # caps above the batch's
    arrays = dict(coors=_lattice(seed, n))
    if with_mask:
        arrays["node_mask"] = rng.rand(n) > 0.25
    arrays.update({k: v for k, v in extra.items() if isinstance(v, np.ndarray)})
    return arrays, {k: v for k, v in extra.items() if not isinstance(v, np.ndarray)}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("loop", [False, True], ids=["no_loop", "loop"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("k", [4, 13], ids=["k4", "k13"])   # k13: m <= k in some graphs
def test_knn_graph(route, loop, with_mask, k):
    arrays, static = _route_args(route, 11, with_mask)
    _same(*_both("knn_graph", arrays, k=k, loop=loop, **static))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("loop", [False, True], ids=["no_loop", "loop"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "masked"])
def test_radius_graph_capped(route, loop, with_mask):
    arrays, static = _route_args(route, 12, with_mask)
    _same(*_both("radius_graph_capped", arrays, radius=1.5, max_num_neighbors=6, loop=loop,
                 **static))


def test_knn_graph_duplicate_points_drop_the_last_slot():
    # eight copies of one point: k + 1 = 5 zero distances crowd out the
    # self slot of most rows, which then drop their last slot instead
    coors = np.zeros((8, 3))
    coors[4:] = 1.0
    es_t, es_j = _both("knn_graph", dict(coors=coors), k=4)
    _same(es_t, es_j)
    assert not (es_t.senders == es_t.receivers)[es_t.mask].any()


def test_knn_graph_ragged_overflow_stays_out():
    # caps below the batch's largest graph: its nodes past the cap get no
    # edges and are nobody's neighbour
    rng = np.random.RandomState(13)
    batch = _ragged_batch(rng, [5, 9, 4])
    arrays = dict(coors=_lattice(13, 18), batch=batch)
    es_t, es_j = _both("knn_graph", arrays, k=3, max_graph_size=6, max_graphs=3)
    _same(es_t, es_j)
    dropped = torch.tensor([11, 12, 13])
    assert not torch.isin(es_t.senders[es_t.mask], dropped).any()


def test_knn_graph_ragged_far_pairs_stay_valid():
    # squared distances beyond the 1e5 ranking fill are still real pairs
    coors = np.array([[0.0, 0, 0], [500.0, 0, 0], [0.0, 700, 0], [1.0, 1, 1]])
    es_t, es_j = _both("knn_graph", dict(coors=coors, batch=np.array([0, 0, 0, 1])), k=2)
    _same(es_t, es_j)
    assert int(es_t.mask.sum()) == 6


@pytest.mark.parametrize("loop", [False, True], ids=["no_loop", "loop"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("max_edges", [30, 300], ids=["cut", "room"])
def test_radius_graph(loop, with_mask, max_edges):
    rng = np.random.RandomState(14)
    arrays = dict(coors=_lattice(14, 18))
    if with_mask:
        arrays["node_mask"] = rng.rand(18) > 0.25
    _same(*_both("radius_graph", arrays, radius=1.2, max_edges=max_edges, loop=loop))


@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("max_edges", [12, 150], ids=["cut", "room"])
def test_edges_from_dense_adj(with_mask, max_edges):
    rng = np.random.RandomState(15)
    n = 13
    arrays = dict(adj_mat=rng.rand(n, n) > 0.7)
    if with_mask:
        arrays["node_mask"] = rng.rand(n) > 0.25
    _same(*_both("edges_from_dense_adj", arrays, max_edges=max_edges))


@pytest.mark.parametrize("num_residues,atoms", [(1, 3), (5, 3), (4, 4)])
def test_backbone_covalent_bonds(num_residues, atoms):
    _same(tg.backbone_covalent_bonds(num_residues, atoms, device="cpu"),
          jg.backbone_covalent_bonds(num_residues, atoms))


def test_chain_adjacency_is_the_training_data_one():
    from egnn_tpu_torch.training import data

    assert tg.chain_adjacency is data.chain_adjacency
    assert np.array_equal(tg.chain_adjacency(9, device="cpu").numpy(),
                          np.asarray(jg.chain_adjacency(9)))


def test_builders_refuse_what_the_reference_refuses():
    with pytest.raises(ValueError, match="sorted"):
        tg.knn_graph(torch.zeros(4, 3), 2, batch=torch.tensor([1, 0, 0, 1]))
    with pytest.raises(ValueError, match="radius_graph_capped"):
        tg.radius_graph(torch.zeros(8193, 3), 1.0, 10)
    with pytest.raises(ValueError, match="graph_size"):
        tg.knn_graph(torch.zeros(10, 3), 2, graph_size=4)
