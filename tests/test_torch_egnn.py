"""The port's EGNN layer and EGNN_Network against the JAX package's, on the
CPU in float64: Flax parameters are carried into the torch modules by
``load_flax_params``, the same numpy inputs go through both forwards, and
the outputs agree at atol 1e-9 (float64 rounding in other orders)."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
from egnn_tpu.ops.graph import chain_adjacency as jax_chain_adjacency
from egnn_tpu_torch import EGNN, EGNN_Network, EGNNNetwork
from egnn_tpu_torch.training.data import chain_adjacency, synthetic_chain_batch
from egnn_tpu_torch.utils.port_weights import load_flax_params

ATOL = 1e-9
F64 = dict(device="cpu", dtype=torch.float64)


def _inputs(seed, b, n, dim, with_mask=True, with_adj=True, edge_dim=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, n, dim)
    coors = rng.randn(b, n, 3) * 2.0
    mask = None
    if with_mask:
        mask = np.arange(n)[None, :] < rng.randint(n // 2, n + 1, size=(b, 1))
    adj = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1 if with_adj else None
    edges = rng.randn(b, n, n, edge_dim) if edge_dim else None
    return feats, coors, mask, adj, edges


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _flax_params(module, *args, **kwargs):
    variables = module.init(jax.random.PRNGKey(0), *args, **kwargs)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


LAYER_CASES = {
    # the serving layer: kNN, node mask, chain adjacency, CoorsNorm, clamp
    "knn_mask_adj": dict(kw=dict(num_nearest_neighbors=8, norm_coors=True,
                                 coor_weights_clamp_value=2.0, norm_feats=True)),
    "knn_no_mask": dict(kw=dict(num_nearest_neighbors=8, valid_radius=1.0),
                        mask=False, adj=False),
    "knn_mean_soft_fourier": dict(kw=dict(num_nearest_neighbors=8, m_pool_method="mean",
                                          soft_edges=True, fourier_features=2,
                                          valid_radius=3.0)),
    "knn_mean_no_mask": dict(kw=dict(num_nearest_neighbors=8, m_pool_method="mean"),
                             mask=False),
    "knn_dense_edges": dict(kw=dict(num_nearest_neighbors=6, edge_dim=4), edge_dim=4),
    "only_sparse_neighbors": dict(kw=dict(only_sparse_neighbors=True)),
    "tp_hidden_padding": dict(kw=dict(num_nearest_neighbors=8, tp_hidden_multiple=16)),
    "update_coors_only": dict(kw=dict(num_nearest_neighbors=8, update_feats=False)),
    "all_pairs": dict(kw=dict(norm_coors=True, m_pool_method="mean"), adj=False),
    "all_pairs_edges_no_mask": dict(kw=dict(edge_dim=3, soft_edges=True), mask=False,
                                    adj=False, edge_dim=3),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    spec = LAYER_CASES[case]
    kw = dict(spec["kw"], init_eps=0.1)
    dim, n = 16, 40
    feats, coors, mask, adj, edges = _inputs(
        zlib.crc32(case.encode()), 2, n, dim, spec.get("mask", True), spec.get("adj", True),
        spec.get("edge_dim", 0))
    jlayer = egnn_tpu.EGNN(dim=dim, **kw)
    jargs = (_j(feats), _j(coors), _j(edges), _j(mask), _j(adj))
    params = _flax_params(jlayer, *jargs)
    jf, jc = jlayer.apply({"params": params}, *jargs)

    tlayer = EGNN(dim=dim, **kw, **F64)
    load_flax_params(tlayer, params)
    tf, tc = tlayer(_t(feats), _t(coors), _t(edges), _t(mask), _t(adj))
    _close(tf, jf)
    _close(tc, jc)


def test_layer_compute_dtype_float32():
    """The float32 message path on float64 parameters: both frameworks round
    the message matmuls to float32, in their own orders (atol 1e-5)."""
    kw = dict(num_nearest_neighbors=8, norm_coors=True, init_eps=0.1)
    feats, coors, mask, adj, _ = _inputs(3, 2, 40, 16)
    jlayer = egnn_tpu.EGNN(dim=16, compute_dtype=jnp.float32, **kw)
    jargs = (_j(feats), _j(coors), None, _j(mask), _j(adj))
    params = _flax_params(jlayer, *jargs)
    jf, jc = jlayer.apply({"params": params}, *jargs)
    tlayer = EGNN(dim=16, compute_dtype=torch.float32, **kw, **F64)
    load_flax_params(tlayer, params)
    tf, tc = tlayer(_t(feats), _t(coors), None, _t(mask), _t(adj))
    assert tf.dtype == torch.float64 and tc.dtype == torch.float64
    _close(tf, jf, atol=1e-5)
    _close(tc, jc, atol=1e-5)


NETWORK_CASES = {
    # anchor-3 shape at depth 2, dim 16: tokens, positions, mask, chain
    "anchor_like": dict(net=dict(num_tokens=21, num_positions=96),
                        layer=dict(num_nearest_neighbors=8, norm_coors=True,
                                   coor_weights_clamp_value=2.0)),
    "no_mask": dict(net=dict(num_tokens=21), layer=dict(num_nearest_neighbors=8),
                    mask=False),
    "adj_degrees": dict(net=dict(num_tokens=21, num_adj_degrees=2, adj_dim=4),
                        layer=dict(num_nearest_neighbors=8)),
    "all_pairs": dict(net=dict(num_tokens=21, num_positions=64),
                      layer=dict(norm_coors=True), n=64),
}


@pytest.mark.parametrize("case", sorted(NETWORK_CASES))
def test_network_matches_jax(case):
    spec = NETWORK_CASES[case]
    n = spec.get("n", 96)
    layer = dict(spec["layer"], init_eps=0.1)
    rng = np.random.RandomState(zlib.crc32(case.encode()))
    tokens = rng.randint(0, 21, size=(2, n))
    _, coors, mask, adj, _ = _inputs(rng.randint(2**31), 2, n, 1, spec.get("mask", True))
    jnet = egnn_tpu.EGNNNetwork(depth=2, dim=16, layer_kwargs=layer, **spec["net"])
    jkw = dict(adj_mat=_j(adj), mask=_j(mask))
    params = _flax_params(jnet, _j(tokens), _j(coors), **jkw)
    jf, jc = jnet.apply({"params": params}, _j(tokens), _j(coors), **jkw)

    tnet = EGNNNetwork(depth=2, dim=16, layer_kwargs=layer, **spec["net"], **F64)
    load_flax_params(tnet, params)
    tf, tc = tnet(_t(tokens), _t(coors), adj_mat=_t(adj), mask=_t(mask))
    _close(tf, jf)
    _close(tc, jc)


@pytest.mark.parametrize("with_mask", [True, False])
def test_network_equivariance(with_mask):
    """Rotating and translating the input coordinates leaves the features
    unchanged and moves the output coordinates the same way (float64)."""
    n = 64
    net = EGNN_Network(depth=2, dim=16, num_tokens=21, num_nearest_neighbors=8,
                       norm_coors=True, coor_weights_clamp_value=2.0, init_eps=0.1,
                       generator=torch.Generator().manual_seed(3), **F64)
    batch = synthetic_chain_batch(np.random.default_rng(1), 2, n, device="cpu",
                                  dtype=torch.float64)
    mask = batch.mask if with_mask else None
    q, _ = torch.linalg.qr(torch.randn(3, 3, dtype=torch.float64,
                                       generator=torch.Generator().manual_seed(2)))
    shift = torch.tensor([0.3, -1.2, 2.0], dtype=torch.float64)
    f0, c0 = net(batch.tokens, batch.noised_coors, adj_mat=batch.adj_mat, mask=mask)
    f1, c1 = net(batch.tokens, batch.noised_coors @ q + shift, adj_mat=batch.adj_mat,
                 mask=mask)
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-9)
    torch.testing.assert_close(c1, c0 @ q + shift, rtol=0, atol=1e-9)


def test_egnn_network_alias_routes_layer_kwargs():
    net = EGNN_Network(depth=2, dim=8, num_tokens=5, num_nearest_neighbors=4,
                       norm_coors=True, device="cpu")
    ref = EGNNNetwork(depth=2, dim=8, num_tokens=5, device="cpu",
                      layer_kwargs=dict(num_nearest_neighbors=4, norm_coors=True))
    assert net.egnn_1.num_nearest_neighbors == 4 and net.egnn_1.norm_coors
    assert [k for k, _ in net.named_parameters()] == [k for k, _ in ref.named_parameters()]
    for (_, a), (_, b) in zip(net.named_parameters(), ref.named_parameters()):
        assert torch.equal(a, b)  # one default seed, one draw order


def test_egnn_network_takes_pairwise_chunk():
    """``pairwise_chunk`` reaches every layer, as in the reference; a kNN
    network built with it computes what the reference's does."""
    n = 48
    kw = dict(depth=2, dim=16, num_tokens=21, num_nearest_neighbors=8, norm_coors=True,
              init_eps=0.1, pairwise_chunk=64)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, 21, size=(2, n))
    _, coors, mask, adj, _ = _inputs(6, 2, n, 1)
    jnet = egnn_tpu.EGNN_Network(**kw)
    jkw = dict(adj_mat=_j(adj), mask=_j(mask))
    params = _flax_params(jnet, _j(tokens), _j(coors), **jkw)
    jf, jc = jnet.apply({"params": params}, _j(tokens), _j(coors), **jkw)
    tnet = EGNN_Network(**kw, **F64)
    assert all(getattr(tnet, f"egnn_{i}").pairwise_chunk == 64 for i in range(2))
    load_flax_params(tnet, params)
    tf, tc = tnet(_t(tokens), _t(coors), adj_mat=_t(adj), mask=_t(mask))
    _close(tf, jf)
    _close(tc, jc)


def test_load_flax_params_rejects_mismatches():
    layer = EGNN(dim=8, num_nearest_neighbors=4, device="cpu")
    params = {name: p.detach().numpy().copy() for name, p in layer.named_parameters()}
    load_flax_params(layer, params)
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(layer, {k: v for k, v in params.items() if k != "edge_mlp_0_w"})
    with pytest.raises(KeyError, match="unknown"):
        load_flax_params(layer, {**params, "edge_gate_w": np.zeros((16, 1))})
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(layer, {**params, "node_mlp_1_b": np.zeros(9)})


@pytest.mark.parametrize("with_edges", [False, True], ids=["no_edges", "edges"])
def test_network_with_edge_tokens_loads_the_reference(with_edges):
    """``num_edge_tokens`` set: the reference creates ``edge_emb`` only when
    edges reach its call, so a tree initialised without edges has none. The
    port's network, which makes it at construction, loads either tree and
    computes the reference's forward, with edges and without."""
    n = 24
    kw = dict(depth=2, dim=16, num_tokens=5, num_edge_tokens=4, edge_dim=3,
              layer_kwargs=dict(num_nearest_neighbors=6, norm_coors=True, init_eps=0.1))
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, 5, size=(2, n))
    edges = rng.randint(0, 4, size=(2, n, n)) if with_edges else None
    _, coors, mask, adj, _ = _inputs(12, 2, n, 1)
    jnet = egnn_tpu.EGNNNetwork(**kw)
    jkw = dict(edges=_j(edges), adj_mat=_j(adj), mask=_j(mask))
    params = _flax_params(jnet, _j(tokens), _j(coors), **jkw)
    assert ("edge_emb" in params) == with_edges
    jf, jc = jnet.apply({"params": params}, _j(tokens), _j(coors), **jkw)

    tnet = EGNNNetwork(**kw, **F64)
    assert "edge_emb" in dict(tnet.named_parameters())
    before = tnet.edge_emb.detach().clone()
    load_flax_params(tnet, params)
    if with_edges:
        np.testing.assert_array_equal(tnet.edge_emb.detach().numpy(), params["edge_emb"])
    else:
        assert torch.equal(tnet.edge_emb.detach(), before)   # left as it was
    tf, tc = tnet(_t(tokens), _t(coors), edges=_t(edges), adj_mat=_t(adj), mask=_t(mask))
    _close(tf, jf)
    _close(tc, jc)


def test_load_flax_params_still_refuses_other_missing_names():
    """Only the parameters that the reference creates on first use may be
    absent: any other missing name raises, and nothing is copied."""
    n = 12
    kw = dict(depth=1, dim=8, num_tokens=5, num_edge_tokens=4, edge_dim=2,
              layer_kwargs=dict(num_nearest_neighbors=3))
    rng = np.random.RandomState(13)
    tokens = rng.randint(0, 5, size=(1, n))
    coors = rng.randn(1, n, 3)
    params = _flax_params(egnn_tpu.EGNNNetwork(**kw), _j(tokens), _j(coors))
    assert "edge_emb" not in params
    tnet = EGNNNetwork(**kw, **F64)
    before = {k: v.detach().clone() for k, v in tnet.named_parameters()}
    with pytest.raises(KeyError, match=r"missing \['token_emb'\]"):
        load_flax_params(tnet, {k: v for k, v in params.items() if k != "token_emb"})
    with pytest.raises(KeyError, match="edge_mlp_0_w"):
        load_flax_params(tnet, {**params, "egnn_0": {
            k: v for k, v in params["egnn_0"].items() if k != "edge_mlp_0_w"}})
    assert all(torch.equal(v, before[k]) for k, v in tnet.named_parameters())
    # a plain layer lists no lazy parameter: its every name is required
    layer = EGNN(dim=8, num_nearest_neighbors=4, device="cpu")
    own = {name: p.detach().numpy().copy() for name, p in layer.named_parameters()}
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(layer, {k: v for k, v in own.items() if k != "node_mlp_0_w"})


def test_options_not_yet_ported_raise(tmp_path):
    """Every option is ported; what stays refused is ``ring_axis`` where the
    ring cannot go: with kNN (``ValueError``: shard-local neighbourhoods)
    and as an axis name in place of a process group (``TypeError``). The
    options that raised before their slice now run (each has its own
    tests; the ring's in ``tests/test_torch_ring.py``)."""
    import torch.distributed as dist

    with pytest.raises(TypeError, match="process group"):
        EGNN(dim=4, device="cpu", ring_axis="x")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1,
                            rank=0)
    try:
        with pytest.raises(ValueError, match="kNN"):
            EGNN(dim=4, num_nearest_neighbors=2, device="cpu", ring_axis=dist.group.WORLD)
        assert EGNN(dim=4, device="cpu", ring_axis=dist.group.WORLD).ring_axis is not None
    finally:
        dist.destroy_process_group()
    for kw in (dict(fused_knn=True), dict(fused_pairs=True)):   # ported: they construct
        EGNN(dim=4, num_nearest_neighbors=2, device="cpu", **kw)
    net = EGNNNetwork(depth=1, dim=4, global_linear_attn_every=1, global_linear_attn_heads=2,
                      global_linear_attn_dim_head=4, device="cpu")
    f, c = net(torch.randn(1, 6, 4, dtype=torch.float32),
               torch.randn(1, 6, 3, dtype=torch.float32))
    assert f.shape == (1, 6, 4) and hasattr(net, "global_attn_0")
    layer = EGNN(dim=4, device="cpu")   # the streamed all-pairs path at n >= 1024
    f, c = layer(torch.zeros(1, 1024, 4, dtype=torch.float32),
                 torch.randn(1, 1024, 3, dtype=torch.float32))
    assert torch.isfinite(f).all() and torch.isfinite(c).all()
    dropping = EGNN(dim=4, num_nearest_neighbors=2, dropout=0.1, device="cpu")
    feats = torch.randn(1, 6, 4, dtype=torch.float32)
    coors = torch.randn(1, 6, 3, dtype=torch.float32)
    with pytest.raises(ValueError, match="generator"):   # training mode draws from one
        dropping(feats, coors)
    dropping(feats, coors, generator=torch.Generator().manual_seed(0))
    dropping.eval()(feats, coors)


def test_chain_data_matches_jax_semantics():
    np.testing.assert_array_equal(chain_adjacency(7, device="cpu").numpy(),
                                  np.asarray(jax_chain_adjacency(7)))
    batch = synthetic_chain_batch(np.random.default_rng(0), 3, 50, device="cpu")
    assert batch.tokens.shape == (3, 50) and batch.tokens.dtype == torch.int64
    assert 0 <= batch.tokens.min() and batch.tokens.max() < 21
    assert batch.noised_coors.shape == (3, 50, 3) and batch.noised_coors.dtype == torch.float32
    torch.testing.assert_close(batch.clean_coors.mean(dim=1),
                               torch.zeros(3, 3, dtype=torch.float32),
                               rtol=0, atol=1e-5)
    lengths = batch.mask.sum(dim=1)
    assert torch.all(lengths >= 30) and torch.all(lengths <= 50)
    assert torch.all(batch.mask[:, :30])  # a valid prefix
    again = synthetic_chain_batch(np.random.default_rng(0), 3, 50, device="cpu")
    assert torch.equal(again.noised_coors, batch.noised_coors)


@pytest.mark.parametrize("mode", ["unfused", "fused_pairs", "fused_knn"])
def test_more_neighbours_than_nodes_raise(mode):
    """k > n raises ValueError in the port on every route, as in
    ``egnn_tpu``, whose ``lax.top_k`` refuses it: a mean over the n slots
    there are (unfused) and over k (fused) would disagree."""
    kw = dict(dim=8, num_nearest_neighbors=5, m_pool_method="mean")
    flags = {} if mode == "unfused" else {mode: True}
    feats, coors, _, _, _ = _inputs(60, 1, 3, 8, with_mask=False, with_adj=False)
    jax_layer = egnn_tpu.EGNN(**kw, **flags)
    with pytest.raises(ValueError):
        jax_layer.init(jax.random.PRNGKey(0), _j(feats), _j(coors))
    layer = EGNN(**kw, **flags, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="num_nearest 5"):
        layer(_t(feats), _t(coors))


def test_knn_graph_clamps_k_to_the_graph():
    """``knn_graph`` clamps k to the graph's size before it selects, as
    ``egnn_tpu.ops.graph.knn_graph`` does, so F6's check never reaches it."""
    from egnn_tpu.ops.graph import knn_graph as jax_knn_graph
    from egnn_tpu_torch.ops.graph import knn_graph

    coors = np.random.RandomState(61).randn(3, 3)
    for loop in (False, True):
        es_t = knn_graph(torch.from_numpy(coors), 5, loop=loop)
        es_j = jax_knn_graph(jnp.asarray(coors), 5, loop=loop)
        for a, b in ((es_t.senders, es_j.senders), (es_t.receivers, es_j.receivers),
                     (es_t.mask, es_j.mask)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(es_t.mask.sum()) == 3 * (3 if loop else 2)
