"""The port's sparse family (``egnn_tpu_torch/models/egnn_sparse.py``:
``EGNNSparse``, ``AttentionSparse``, ``GlobalLinearAttentionSparse``,
``EGNNSparseNetwork``) against ``egnn_tpu``'s on the CPU, with the weights
carried by ``load_flax_params``.

Inputs are numpy draws from a seed; edges come from ``knn_graph`` over
packed molecules, node and edge masks included. Everything is float64:
outputs, and the gradients of a random cotangent with respect to ``x`` and
to every parameter, agree at atol 1e-9 times the tensor's largest magnitude
where that exceeds 1 (the same arithmetic, sums in other orders; through
two layers the coordinate gradients reach 1e4). ``compute_dtype=bfloat16``
rounds the message path's operands on both sides, in the two libraries' own
bfloat16 matmuls: outputs agree at atol 3e-2 (times the largest magnitude
past 1), a few bfloat16 ulps of the messages.

``fused_uniform=True`` runs the plain version of K10 here (float64): it is
held against the JAX package's per-edge path at 1e-9 as well, and once
against its interpret-mode kernel, which computes in float32 (rtol 2e-4 /
atol 2e-5, the tolerance of ``tests/test_fused_uniform.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
import egnn_tpu_torch
from egnn_tpu_torch.models import init as tinit
from egnn_tpu_torch.ops.cuda import pair_messages as PM
from egnn_tpu_torch.ops.graph import knn_graph
from egnn_tpu_torch.utils.port_weights import load_flax_params

F64 = dict(device="cpu", dtype=torch.float64)
ATOL = 1e-9
G, NA, K = 3, 12, 4   # molecules, atoms a molecule (some masked), neighbours


def _molecules(seed, d, pos=3, masked=True, edge_attr_dim=0):
    """Packed molecules: x (N, pos + d), edge_index, edge_mask, batch,
    node_mask, edge_attr; numpy."""
    rng = np.random.RandomState(seed)
    n = G * NA
    coors = 1.5 * rng.randn(n, pos)
    node_mask = np.ones(n, bool)
    if masked:
        for g in range(G):
            node_mask[g * NA + rng.randint(NA - 3, NA + 1):(g + 1) * NA] = False
    es = knn_graph(torch.from_numpy(coors), K, node_mask=torch.from_numpy(node_mask),
                   graph_size=NA)
    x = np.concatenate([coors, rng.randn(n, d)], axis=-1)
    return dict(x=x, edge_index=es.edge_index.numpy(), edge_mask=es.mask.numpy(),
                batch=np.repeat(np.arange(G), NA), node_mask=node_mask,
                edge_attr=rng.randn(n * K, edge_attr_dim) if edge_attr_dim else None)


def _flax_params(module, *args, **kwargs):
    init = jax.jit(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs))
    return jax.tree_util.tree_map(np.asarray, init(*args)["params"])


def _close(actual, desired, atol, name=""):
    """|actual - desired| <= atol * max(1, the largest |desired|)."""
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max())) if desired.size else 1.0
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0, atol=atol * scale,
                               err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _t(v):
    return None if v is None else torch.from_numpy(np.asarray(v))


def _j(v):
    return None if v is None else jnp.asarray(v)


def _compare(jmod, tmod, x, args, kwargs, atol=ATOL, grads=True, seed=5):
    """Output of both modules and the gradients of <out, cot> wrt x and every
    parameter. ``args``/``kwargs`` are numpy (or plain) arguments after x."""
    jargs = [_j(a) if isinstance(a, np.ndarray) else a for a in args]
    jkw = {k: (_j(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()}
    params = _flax_params(jmod, jnp.asarray(x), *jargs, **jkw)
    load_flax_params(tmod, params)

    def apply(p, xx):
        return jmod.apply({"params": p}, xx, *jargs, **jkw)

    targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()}
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    out_t = tmod(xt, *targs, **tkw)
    cot = np.random.RandomState(seed).randn(*out_t.shape)

    @jax.jit
    def out_and_grads(p, xx):
        out, vjp = jax.vjp(apply, p, xx)
        return out, vjp(jnp.asarray(cot))

    out_j, (gp_j, gx_j) = out_and_grads(params, jnp.asarray(x))
    _close(out_t.detach().numpy(), out_j, atol, "output")
    if not grads:
        return params
    names, leaves = zip(*tmod.named_parameters())
    g_t = torch.autograd.grad(out_t, (xt,) + leaves, torch.from_numpy(cot), allow_unused=True)
    _close(g_t[0].numpy(), gx_j, atol, "x")
    flat = _flat(gp_j)
    assert set(flat) == set(names)
    for name, leaf, g in zip(names, leaves, g_t[1:]):
        _close(torch.zeros_like(leaf) if g is None else g, flat[name], atol, name)
    return params


def _layer_kwargs(mol, with_batch=True):
    kw = dict(edge_mask=mol["edge_mask"], num_graphs=G, node_mask=mol["node_mask"])
    if with_batch:
        kw["batch"] = mol["batch"]
    if mol["edge_attr"] is not None:
        kw["edge_attr"] = mol["edge_attr"]
    return kw


LAYER_CASES = {
    "add": dict(),
    "sum_soft_edge": dict(aggr="sum", soft_edge=1),
    "mean_fourier_norms": dict(aggr="mean", fourier_features=2, norm_feats=True,
                               norm_coors=True),
    "max_clamp": dict(aggr="max", coor_weights_clamp_value=0.3),
    "edge_attr": dict(edge_attr_dim=3, soft_edge=1),
    "feats_only": dict(update_coors=False, norm_feats=True),
    "coors_only": dict(update_feats=False, norm_coors=True),
    "pos_dim_4": dict(pos_dim=4, fourier_features=1),
    "uniform_mean": dict(uniform_degree=K, aggr="mean", norm_coors=True),
    "uniform_max_soft": dict(uniform_degree=K, aggr="max", soft_edge=1),
    "uniform_graph_size": dict(uniform_degree=K, uniform_graph_size=NA, norm_feats=True,
                               fourier_features=2, coor_weights_clamp_value=1.0),
    "graph_size_norm_only": dict(uniform_graph_size=NA, norm_feats=True, aggr="mean"),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_sparse_layer_matches_egnn_tpu(case):
    opts = dict(LAYER_CASES[case])
    d = 5
    mol = _molecules(1, d, pos=opts.get("pos_dim", 3), edge_attr_dim=opts.get("edge_attr_dim", 0))
    _compare(egnn_tpu.EGNNSparse(feats_dim=d, **opts),
             egnn_tpu_torch.EGNNSparse(feats_dim=d, **opts, **F64),
             mol["x"], [mol["edge_index"]], _layer_kwargs(mol))


@pytest.mark.parametrize("uniform", [False, True], ids=["segments", "uniform"])
def test_sparse_layer_bfloat16_messages(uniform):
    d = 6
    mol = _molecules(2, d)
    opts = dict(soft_edge=1, norm_coors=True, uniform_degree=K if uniform else None)
    _compare(egnn_tpu.EGNNSparse(feats_dim=d, compute_dtype=jnp.bfloat16, **opts),
             egnn_tpu_torch.EGNNSparse(feats_dim=d, compute_dtype=torch.bfloat16, **opts,
                                       **F64),
             mol["x"], [mol["edge_index"]], _layer_kwargs(mol), atol=3e-2, grads=False)


NET_CASES = {
    "embeddings": dict(feats_dim=2, embedding_nums=[5], embedding_dims=[6], fourier_features=2,
                       norm_coors=True),
    "edge_embeddings": dict(feats_dim=2, embedding_nums=[5], embedding_dims=[4],
                            edge_attr_dim=2, edge_embedding_nums=[3], edge_embedding_dims=[3],
                            soft_edge=1),
    "global_attention": dict(feats_dim=3, global_linear_attn_every=2,
                             global_linear_attn_heads=2, global_linear_attn_dim_head=4,
                             num_global_tokens=3, aggr="mean"),
    "global_attention_uniform": dict(feats_dim=2, embedding_nums=[5], embedding_dims=[4],
                                     global_linear_attn_every=1, global_linear_attn_heads=2,
                                     global_linear_attn_dim_head=3, uniform_degree=K,
                                     uniform_graph_size=NA),
    "recalc_edge": dict(feats_dim=2, edge_attr_dim=2, edge_embedding_nums=[3],
                        edge_embedding_dims=[3], recalc=1, uniform_degree=K),
}


@pytest.mark.parametrize("case", list(NET_CASES))
def test_sparse_network_matches_egnn_tpu(case):
    opts = dict(NET_CASES[case])
    n_cat = len(opts.get("embedding_nums", ()))
    mol = _molecules(3, opts["feats_dim"] - n_cat, edge_attr_dim=opts.get("edge_attr_dim", 0))
    rng = np.random.RandomState(4)
    x = np.concatenate([mol["x"]] + [rng.randint(0, 5, size=(G * NA, 1)).astype(np.float64)
                                     for _ in range(n_cat)], axis=-1)
    if opts.get("edge_embedding_nums"):
        mol["edge_attr"] = np.concatenate(
            [mol["edge_attr"][:, :1], rng.randint(0, 3, size=(G * NA * K, 1))], axis=-1)
    kw = dict(batch=mol["batch"], edge_mask=mol["edge_mask"], num_graphs=G,
              node_mask=mol["node_mask"])
    if mol["edge_attr"] is not None:
        kw["edge_attr"] = mol["edge_attr"]
    if opts.get("recalc"):
        attr = mol["edge_attr"]

        def recalc_j(xx):
            es = egnn_tpu.ops.graph.knn_graph(xx[:, :3], K, node_mask=jnp.asarray(
                mol["node_mask"]), graph_size=NA)
            return es.edge_index, jnp.asarray(attr), es.mask

        def recalc_t(xx):
            es = knn_graph(xx[:, :3].detach(), K, node_mask=_t(mol["node_mask"]),
                           graph_size=NA)
            return es.edge_index, _t(attr), es.mask

    jnet = egnn_tpu.EGNNSparseNetwork(n_layers=2, **opts)
    tnet = egnn_tpu_torch.EGNNSparseNetwork(n_layers=2, **opts, **F64)
    if not opts.get("recalc"):
        _compare(jnet, tnet, x, [mol["edge_index"]], kw)
        return
    # the hook: both sides rebuild the kNN edges from the updated coordinates
    params = _compare(jnet, tnet, x, [mol["edge_index"]], kw, grads=False)
    kj = {k: (_j(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    out_j = jax.jit(lambda p, xx: jnet.apply({"params": p}, xx, jnp.asarray(mol["edge_index"]),
                                             recalc_edge=recalc_j, **kj))(params, jnp.asarray(x))
    kt = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    out_t = tnet(_t(x), _t(mol["edge_index"]), recalc_edge=recalc_t, **kt)
    _close(out_t.detach().numpy(), out_j, ATOL)
    no_hook = tnet(_t(x), _t(mol["edge_index"]), **kt)
    assert not torch.allclose(out_t, no_hook)   # the hook changed the edges


# ---------------------------------------------------------------------------
# the fused arm: K10's plain version under EGNNSparse(fused_uniform=True)
# ---------------------------------------------------------------------------


@pytest.fixture
def count_fused(monkeypatch):
    calls = {"n": 0, "gate_feats_only": []}
    real = PM.fused_pair_messages

    def counted(*a, **kw):
        calls["n"] += 1
        calls["gate_feats_only"].append(a[11])
        return real(*a, **kw)

    monkeypatch.setattr(PM, "fused_pair_messages", counted)
    return calls


FUSED_CASES = {
    "plain": dict(),
    "soft_edge": dict(soft_edge=1),
    "norm_clamp_fourier": dict(norm_coors=True, coor_weights_clamp_value=0.5,
                               fourier_features=2),
    "soft_norms": dict(soft_edge=1, norm_coors=True, norm_feats=True),
    "mean": dict(aggr="mean", soft_edge=1),
    "graph_size_mean": dict(aggr="mean", uniform_graph_size=NA, norm_feats=True),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_uniform_layer_matches_the_per_edge_path(case, count_fused):
    opts = dict(FUSED_CASES[case], uniform_degree=K)
    d = 6
    mol = _molecules(6, d)
    _compare(egnn_tpu.EGNNSparse(feats_dim=d, fused_uniform=False, **opts),
             egnn_tpu_torch.EGNNSparse(feats_dim=d, fused_uniform=True, **opts, **F64),
             mol["x"], [mol["edge_index"]], _layer_kwargs(mol))
    assert count_fused["n"] == 1 and count_fused["gate_feats_only"] == [True]


def test_fused_uniform_network_matches_and_equals_the_per_edge_port(count_fused):
    opts = dict(n_layers=2, feats_dim=1, embedding_nums=[5], embedding_dims=[8],
                fourier_features=2, norm_feats=True, norm_coors=True, uniform_degree=K,
                uniform_graph_size=NA)
    mol = _molecules(7, 0)
    x = np.concatenate([mol["x"], np.random.RandomState(8).randint(0, 5, (G * NA, 1))], axis=-1)
    kw = dict(batch=mol["batch"], edge_mask=mol["edge_mask"], num_graphs=G,
              node_mask=mol["node_mask"])
    fused = egnn_tpu_torch.EGNNSparseNetwork(**opts, fused_uniform=True, **F64)
    params = _compare(egnn_tpu.EGNNSparseNetwork(**opts, fused_uniform=False), fused, x,
                      [mol["edge_index"]], kw)
    assert count_fused["n"] == 2   # two layers
    per_edge = egnn_tpu_torch.EGNNSparseNetwork(**opts, fused_uniform=False, **F64)
    load_flax_params(per_edge, params)
    kt = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    torch.testing.assert_close(fused(_t(x), _t(mol["edge_index"]), **kt),
                               per_edge(_t(x), _t(mol["edge_index"]), **kt), rtol=0, atol=ATOL)


def test_fused_uniform_matches_the_interpret_mode_kernel():
    """Against egnn_tpu's fused_uniform=True, its Pallas kernel in interpret
    mode (float32 inside): one small masked case with the soft gate."""
    d = 8
    mol = _molecules(9, d)
    opts = dict(feats_dim=d, uniform_degree=K, soft_edge=1, norm_coors=True, aggr="mean")
    jmod = egnn_tpu.EGNNSparse(**opts, fused_uniform=True)
    tmod = egnn_tpu_torch.EGNNSparse(**opts, fused_uniform=True, **F64)
    kw = _layer_kwargs(mol)
    jkw = {k: (_j(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    params = _flax_params(jmod, jnp.asarray(mol["x"]), jnp.asarray(mol["edge_index"]), **jkw)
    load_flax_params(tmod, params)
    out_j = jmod.apply({"params": params}, jnp.asarray(mol["x"]), jnp.asarray(mol["edge_index"]),
                       **jkw)
    out_t = tmod(_t(mol["x"]), _t(mol["edge_index"]),
                 **{k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("opts", [dict(aggr="max"), dict(edge_attr_dim=2),
                                  dict(update_feats=False), dict()],
                         ids=["max", "edge_attr", "coors_only", "no_uniform_degree"])
def test_fused_uniform_takes_the_per_edge_path_outside_its_gate(opts, count_fused):
    d = 4
    mol = _molecules(10, d, edge_attr_dim=opts.get("edge_attr_dim", 0))
    uk = None if not opts else K
    layer = egnn_tpu_torch.EGNNSparse(feats_dim=d, uniform_degree=uk, fused_uniform=True,
                                      **opts, **F64)
    kw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in _layer_kwargs(mol).items()}
    out = layer(_t(mol["x"]), _t(mol["edge_index"]), **kw)
    assert out.shape == mol["x"].shape and count_fused["n"] == 0


def test_fused_gate_takes_the_molecule_widths():
    """F5: anchor 5's layer (dim 64, fourier 4, m 16: h = 274, k = 8) fuses,
    as the JAX gate says; the dense paths keep their tiles."""
    assert PM.supports_fused_pair_messages(8, 274, 16, 64, fourier=4)
    assert PM.supports_fused_pair_messages(8, 274, 16, 64, fourier=4, soft_edges=True)
    from egnn_tpu.ops.pallas.pair_messages import supports_fused_pair_messages as jax_gate
    assert jax_gate(1024, 8, 274, 16, 64, backend="tpu")
    layer = egnn_tpu_torch.EGNNSparse(feats_dim=64, fourier_features=4, norm_coors=True,
                                      norm_feats=True, uniform_degree=8, fused_uniform=True,
                                      **F64)
    assert layer.hidden == 274 and layer._uses_fused()
    assert PM._tile_rows(8, 3, 64, 274, 16, 64, 4, False) == 48
    assert PM._bwd_tile_rows(8, 3, 64, 274, 16, 64, 4, False) == 32
    assert PM._fwd_tile_rows(1, 1024, 8, 3, 64, 274, 16, 64, 4, False, 132) == 32
    # anchor 3, path C (k 16) and path A (kc 20): the tiles they had
    for k, fwd, bwd in ((8, 32, 32), (16, 64, 32), (20, 64, 24)):
        n = 1024 if k == 8 else 65536
        assert PM._bwd_tile_rows(k, 3, 32, 130, 16, 64, 0, False) == bwd
        assert PM._fwd_tile_rows(1, n, k, 3, 32, 130, 16, 64, 0, False, 132) == fwd


# ---------------------------------------------------------------------------
# weights, initialisers, refusals
# ---------------------------------------------------------------------------


def test_load_flax_params_on_sparse_trees():
    opts = NET_CASES["global_attention"]
    mol = _molecules(11, opts["feats_dim"])
    jnet = egnn_tpu.EGNNSparseNetwork(n_layers=2, **opts)
    params = _flax_params(jnet, jnp.asarray(mol["x"]), jnp.asarray(mol["edge_index"]),
                          batch=jnp.asarray(mol["batch"]), num_graphs=G)
    tnet = egnn_tpu_torch.EGNNSparseNetwork(n_layers=2, **opts, **F64)
    assert set(_flat(params)) == {name for name, _ in tnet.named_parameters()}
    assert "global_attn_0.attn1.to_q_w" in _flat(params)
    # a tree without the tokens leaves the port's own
    own = tnet.global_tokens.detach().clone()
    load_flax_params(tnet, {k: v for k, v in params.items() if k != "global_tokens"})
    assert torch.equal(tnet.global_tokens, own)
    np.testing.assert_array_equal(tnet.mpnn_1.edge_mlp_0_w.detach().numpy(),
                                  params["mpnn_1"]["edge_mlp_0_w"])
    with pytest.raises(KeyError):
        load_flax_params(tnet, {**params, "mpnn_9": params["mpnn_0"]})


def test_sparse_initialisers():
    gen = torch.Generator().manual_seed(0)
    w = tinit.xavier_normal_init((300, 500), gen)
    assert abs(w.std().item() - (2.0 / 800) ** 0.5) < 2e-3
    u = tinit.torch_linear_weight_init((400, 300), gen)
    assert u.abs().max().item() <= 400 ** -0.5 and u.abs().max().item() > 0.95 * 400 ** -0.5
    layer = egnn_tpu_torch.EGNNSparse(feats_dim=4, **F64)
    assert not layer.edge_mlp_0_b.any() and layer.edge_mlp_0_w.std().item() > 0


def test_aliases_and_exports():
    assert egnn_tpu_torch.EGNN_Sparse is egnn_tpu_torch.EGNNSparse
    assert egnn_tpu_torch.EGNN_Sparse_Network is egnn_tpu_torch.EGNNSparseNetwork
    for name in ("AttentionSparse", "GlobalLinearAttentionSparse"):
        assert name in egnn_tpu_torch.__all__


def test_unported_options_raise():
    # shard_axis and axis_name take a process group (tests/test_torch_
    # sparse_partition.py runs them); the JAX package's axis names raise
    with pytest.raises(TypeError, match="shard_axis takes a torch.distributed process group"):
        egnn_tpu_torch.EGNNSparse(feats_dim=4, shard_axis="edges", **F64)
    with pytest.raises(TypeError, match="shard_axis takes a torch.distributed process group"):
        egnn_tpu_torch.EGNNSparseNetwork(n_layers=1, feats_dim=4, shard_axis="edges", **F64)
    with pytest.raises(TypeError, match="axis_name takes a torch.distributed process group"):
        egnn_tpu_torch.GlobalLinearAttentionSparse(8, axis_name="nodes", **F64)
    # dropout in training mode runs, its masks from the caller's generator
    layer = egnn_tpu_torch.EGNNSparse(feats_dim=4, dropout=0.1, **F64)
    mol = _molecules(12, 4)
    with pytest.raises(ValueError, match="generator"):
        layer(_t(mol["x"]), _t(mol["edge_index"]))
    out = layer(_t(mol["x"]), _t(mol["edge_index"]), generator=torch.Generator().manual_seed(0))
    assert out.shape == mol["x"].shape
    layer.eval()
    assert layer(_t(mol["x"]), _t(mol["edge_index"])).shape == mol["x"].shape


def test_layout_contracts_are_checked():
    d = 4
    mol = _molecules(13, d, masked=False)
    x, ei = _t(mol["x"]), _t(mol["edge_index"])
    batch = _t(mol["batch"])
    with pytest.raises(ValueError, match="n\\*k"):
        egnn_tpu_torch.EGNNSparse(feats_dim=d, uniform_degree=K + 1, **F64)(x, ei)
    layer = egnn_tpu_torch.EGNNSparse(feats_dim=d, uniform_degree=K, uniform_graph_size=NA,
                                      **F64)
    with pytest.raises(ValueError, match="contiguous"):
        layer(x, ei, batch=batch.flip(0), num_graphs=G)
    crossing = ei.clone()
    crossing[0, 0] = NA + 1           # an edge from another molecule
    with pytest.raises(ValueError, match="block-local"):
        layer(x, crossing, batch=batch, num_graphs=G)
    shuffled = ei[:, torch.randperm(ei.shape[1], generator=torch.Generator().manual_seed(0))]
    with pytest.raises(ValueError, match="receiver-major"):
        layer(x, shuffled, batch=batch, num_graphs=G)
    # a masked padding row may point anywhere
    em = torch.ones(ei.shape[1], dtype=torch.bool)
    em[0] = False
    assert layer(x, crossing, batch=batch, num_graphs=G, edge_mask=em).shape == x.shape
    with pytest.raises(ValueError, match="valid option"):
        egnn_tpu_torch.EGNNSparse(feats_dim=d, aggr="min", **F64)
    net = egnn_tpu_torch.EGNNSparseNetwork(n_layers=1, feats_dim=d, **F64)
    with pytest.raises(ValueError, match="bsize"):
        net(x, ei, bsize=7)
    assert net(x, ei, bsize=x.shape[0]).shape == x.shape


@pytest.mark.parametrize("recalc, checks", [(0, 1), (2, 3)], ids=["one_edge_set", "recalc"])
def test_network_checks_each_edge_set_once(monkeypatch, recalc, checks):
    """The network checks the ``uniform_graph_size`` layout once for each
    edge set (at entry, after each ``recalc_edge``), not once a layer, and a
    bad recalculated edge set is still refused."""
    from egnn_tpu_torch.models import egnn_sparse as tsparse

    d = 4
    mol = _molecules(14, d)
    x, ei, em, batch = (_t(mol[key]) for key in ("x", "edge_index", "edge_mask", "batch"))
    seen = []
    check = tsparse._check_uniform_layout
    monkeypatch.setattr(tsparse, "_check_uniform_layout",
                        lambda *args: seen.append(1) or check(*args))
    net = egnn_tpu_torch.EGNNSparseNetwork(n_layers=4, feats_dim=d, recalc=recalc,
                                           uniform_degree=K, uniform_graph_size=NA, **F64)
    kw = dict(batch=batch, edge_mask=em, num_graphs=G)
    assert net(x, ei, recalc_edge=lambda _: (ei, None, em), **kw).shape == x.shape
    assert len(seen) == checks
    if recalc:
        crossing = ei.clone()
        crossing[0, 1] = NA + 1       # a live edge from another molecule
        with pytest.raises(ValueError, match="block-local"):
            net(x, ei, recalc_edge=lambda _: (crossing, None, em), **kw)
