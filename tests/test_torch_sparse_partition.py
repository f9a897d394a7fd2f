"""The port's edge-partitioned sparse path against ``egnn_tpu``'s, on the
CPU: ``partition_edges`` and ``partition_uniform_edges`` equal to
``egnn_tpu.parallel``'s (the ids' values, masks and edge features bit for
bit) for 2, 4 and 8 shards, and the sharded modules on two gloo ranks
(``test_torch_parallel.run_ranks``) against JAX's ``shard_map`` on a
2-device mesh and against the port's unsharded modules, the cases of
``tests/test_sparse_partition.py``: ``EGNNSparse`` with ``norm_feats`` off
and on times ``aggr`` add and mean, the uniform degree (also through K10's
plain version, ``fused_uniform``), the network with global attention and a
node mask, and ``make_partitioned_sparse_train_step`` against JAX's.

Float64 throughout. Outputs and gradients agree at 1e-9 times the tensor's
largest magnitude where that exceeds 1 (the same arithmetic, the sums over
the ranks' blocks in another order); the step's loss at rtol 1e-9 and its
parameters at rtol 1e-8 / atol 1e-10 after one Adam step, the tolerance of
``tests/test_sparse_partition.py``'s step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import egnn_tpu
from egnn_tpu import parallel as jpar
from egnn_tpu import training as jtrain
from egnn_tpu.ops.graph import knn_graph
from egnn_tpu_torch import EGNNSparse, EGNNSparseNetwork, parallel
from egnn_tpu_torch.utils.port_weights import load_flax_params
from test_torch_parallel import run_ranks, sparse_cases

F64 = dict(device="cpu", dtype=torch.float64)
ATOL = 1e-9
SHARDS = 2


def _close(actual, desired, atol=ATOL, name=""):
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max())) if desired.size else 1.0
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0, atol=atol * scale,
                               err_msg=name)


# ---------------------------------------------------------------------------
# the partition functions, bitwise
# ---------------------------------------------------------------------------

def _edges(seed, n=64, k=4, masked=False, attr=False):
    rng = np.random.RandomState(seed)
    es = knn_graph(jnp.asarray(rng.randn(n, 3)), k)
    mask = np.array(es.mask)
    if masked:
        mask = mask & (rng.rand(mask.shape[0]) > 0.3)
    return (np.array(es.senders), np.array(es.receivers), mask,
            rng.randn(mask.shape[0], 3) if attr else None)


def _same(port, jaxs):
    np.testing.assert_array_equal(port.senders.numpy(), np.asarray(jaxs.senders))
    np.testing.assert_array_equal(port.receivers.numpy(), np.asarray(jaxs.receivers))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(jaxs.mask))
    assert port.capacity == jaxs.capacity
    assert (port.edge_attr is None) == (jaxs.edge_attr is None)
    if port.edge_attr is not None:
        a, b = port.edge_attr.numpy(), np.asarray(jaxs.edge_attr)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))


PARTITION_CASES = {
    "plain": dict(),
    "mask": dict(masked=True),
    "mask_attr": dict(masked=True, attr=True),
    "tight_capacity": dict(masked=True, attr=True, capacity=20),
}


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_partition_edges_matches_jax_bitwise(shards, case):
    spec = dict(PARTITION_CASES[case])
    cap = spec.pop("capacity", None)
    snd, rcv, mask, attr = _edges(shards, **spec)
    jax_pe = jpar.partition_edges(jnp.asarray(snd), jnp.asarray(rcv), 64, shards,
                                  edge_attr=None if attr is None else jnp.asarray(attr),
                                  edge_mask=jnp.asarray(mask) if spec else None, capacity=cap)
    port_pe = parallel.partition_edges(
        torch.from_numpy(snd), torch.from_numpy(rcv), 64, shards,
        edge_attr=None if attr is None else torch.from_numpy(attr),
        edge_mask=torch.from_numpy(mask) if spec else None, capacity=cap)
    _same(port_pe, jax_pe)
    if cap is not None:     # the tight budget drops edges from the end
        assert int(port_pe.mask.sum()) < int(mask.sum())


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("case", ["plain", "mask_attr"])
def test_partition_uniform_edges_matches_jax_bitwise(shards, case):
    masked = case == "mask_attr"
    snd, _, mask, attr = _edges(10 + shards, masked=masked, attr=masked)
    jax_pe = jpar.partition_uniform_edges(
        jnp.asarray(snd), 64, shards, 4, edge_attr=None if attr is None else jnp.asarray(attr),
        edge_mask=jnp.asarray(mask) if masked else None)
    port_pe = parallel.partition_uniform_edges(
        torch.from_numpy(snd), 64, shards, 4,
        edge_attr=None if attr is None else torch.from_numpy(attr),
        edge_mask=torch.from_numpy(mask) if masked else None)
    _same(port_pe, jax_pe)


# ---------------------------------------------------------------------------
# the sharded modules on two ranks
# ---------------------------------------------------------------------------

N, D, K, G = 64, 6, 4, 2


def _graph_case(seed, attr=True):
    """tests/test_sparse_partition.py's ``_graph_case`` from numpy draws."""
    rng = np.random.RandomState(seed)
    coors = rng.randn(N, 3)
    x = np.concatenate([coors, rng.randn(N, D)], axis=-1)
    es = knn_graph(jnp.asarray(coors), K)
    return dict(x=x, edge_index=np.array(es.edge_index), edge_mask=np.array(es.mask),
                batch=np.repeat(np.arange(G), N // G),
                edge_attr=rng.randn(N * K, 2) if attr else None, num_graphs=G)


LAYER = dict(feats_dim=D, edge_attr_dim=2, fourier_features=2, norm_coors=True)
NETWORK = dict(n_layers=2, feats_dim=D, edge_attr_dim=2, fourier_features=2, norm_feats=True,
               norm_coors=True)
MODULE_CASES = {
    **{f"layer_norm{int(nf)}_{aggr}": dict(kind="layer", kw=dict(LAYER, norm_feats=nf,
                                                                 aggr=aggr), seed=0)
       for nf in (False, True) for aggr in ("add", "mean")},
    "layer_uniform": dict(kind="layer", kw=dict(LAYER, norm_feats=True), uniform=K, seed=5),
    # K10's plain version on each rank's own nodes (no edge features: the
    # fused gate takes none); JAX's reference is its per-edge layer
    "layer_uniform_fused": dict(kind="layer", kw=dict(feats_dim=D, fourier_features=2,
                                                      norm_feats=True, norm_coors=True),
                                port_kw=dict(fused_uniform=True), uniform=K, seed=6, attr=False),
    "network": dict(kind="network", kw=dict(NETWORK, n_layers=3), seed=3),
    "network_attention_node_mask": dict(
        kind="network", kw=dict(NETWORK, global_linear_attn_every=1, global_linear_attn_heads=2,
                                global_linear_attn_dim_head=8, num_global_tokens=3),
        seed=3, node_mask=True),
}


def _jax_module(case, sharded):
    kw = dict(case["kw"])
    if case.get("uniform") and sharded:
        kw["uniform_degree"] = case["uniform"]
    cls = egnn_tpu.EGNNSparse if case["kind"] == "layer" else egnn_tpu.EGNNSparseNetwork
    return cls(**kw, shard_axis="graph" if sharded else None)


def _jax_shard_map(module, params, g, pe, node_mask):
    mesh = jpar.make_mesh(data=1, graph=SHARDS, devices=jax.devices()[:SHARDS])

    def apply(p, xx, snd, rcv, msk, ea, bi, nm):
        return module.apply(p, xx, jnp.stack([snd, rcv]), edge_attr=ea, batch=bi, edge_mask=msk,
                            num_graphs=G, node_mask=nm)

    apply = jax.shard_map(apply, mesh=mesh, in_specs=(P(),) + (P("graph"),) * 7,
                          out_specs=P("graph"), check_vma=False)
    return np.asarray(jax.jit(apply)(params, jnp.asarray(g["x"]), pe.senders, pe.receivers,
                                     pe.mask, pe.edge_attr, jnp.asarray(g["batch"]),
                                     jnp.asarray(node_mask)))


def _port_unsharded(case, params, g, node_mask, cot):
    kw = dict(case["kw"])
    if case.get("uniform"):
        kw["uniform_degree"] = case["uniform"]
    cls = EGNNSparse if case["kind"] == "layer" else EGNNSparseNetwork
    module = cls(**kw, **case.get("port_kw", {}), **F64)
    load_flax_params(module, params)
    x = torch.from_numpy(g["x"]).requires_grad_()
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    y = module(x, t(g["edge_index"]), edge_attr=t(g["edge_attr"]), batch=t(g["batch"]),
               edge_mask=t(g["edge_mask"]), num_graphs=G, node_mask=t(node_mask))
    (y * torch.from_numpy(cot)).sum().backward()
    return (y.detach().numpy(), x.grad.numpy(),
            {k: v.grad.numpy() for k, v in module.named_parameters() if v.grad is not None})


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every case's JAX shard_map output and port unsharded output and
    gradients (and JAX's step) here, and the port's sharded ones from one
    spawn of two ranks."""
    expect, payload = {}, {}
    for name, case in MODULE_CASES.items():
        g = _graph_case(case["seed"], attr=case.get("attr", True))
        rng = np.random.RandomState(case["seed"] + 100)
        node_mask = (rng.rand(N) > 0.2) if case.get("node_mask") else np.ones(N, bool)
        g["node_mask"] = node_mask if case.get("node_mask") else None
        ja = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
        module = _jax_module(case, sharded=False)
        params = module.init(jax.random.PRNGKey(1), ja(g["x"]), ja(g["edge_index"]),
                             edge_attr=ja(g["edge_attr"]), batch=ja(g["batch"]),
                             edge_mask=ja(g["edge_mask"]), num_graphs=G,
                             node_mask=ja(g["node_mask"]))
        params_np = jax.tree_util.tree_map(np.asarray, params["params"])
        snd, rcv = ja(g["edge_index"][0]), ja(g["edge_index"][1])
        if case.get("uniform"):
            pe = jpar.partition_uniform_edges(snd, N, SHARDS, case["uniform"],
                                              edge_attr=ja(g["edge_attr"]),
                                              edge_mask=ja(g["edge_mask"]))
        else:
            pe = jpar.partition_edges(snd, rcv, N, SHARDS, edge_attr=ja(g["edge_attr"]),
                                      edge_mask=ja(g["edge_mask"]))
        jax_out = _jax_shard_map(_jax_module(case, sharded=True), params, g, pe, node_mask)
        cot = rng.randn(*jax_out.shape)
        expect[name] = dict(jax=jax_out, port=_port_unsharded(case, params_np, g,
                                                              g["node_mask"], cot))
        payload[name] = dict(kind=case["kind"], kw=dict(case["kw"], **case.get("port_kw", {})),
                             uniform=case.get("uniform"), params=params_np, inputs=g, cot=cot)
        if case.get("uniform"):
            payload[name]["kw"]["uniform_degree"] = case["uniform"]
    expect["step"], payload["step"] = _jax_step_case()
    ranks = run_ranks(sparse_cases, SHARDS, tmp_path_factory.mktemp("sparse"), payload)
    return expect, ranks


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_sharded_output_matches_jax_shard_map_and_unsharded(sharded, case):
    expect, ranks = sharded
    out = np.concatenate([r[case]["out"] for r in ranks])
    _close(out, expect[case]["jax"], name="against JAX's shard_map")
    _close(out, expect[case]["port"][0], name="against the unsharded port")


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_sharded_gradients_match_unsharded(sharded, case):
    """The gradients of <output, cot>: x's rows from each rank, the
    parameters' summed over the ranks (the all-gather's backward is a
    reduce-scatter; the statistics' sums go back through all_reduce)."""
    expect, ranks = sharded
    _, x_grad, grads = expect[case]["port"]
    _close(np.concatenate([r[case]["x_grad"] for r in ranks]), x_grad, name="x")
    assert set(ranks[0][case]["grads"]) == set(grads)
    for name, g in grads.items():
        _close(sum(r[case]["grads"][name] for r in ranks), g, name=name)


def _jax_step_case():
    """JAX's partitioned step at 2 devices (``tests/test_sparse_partition.py``'s
    step case): its loss and parameters after one Adam step, and the
    port's payload for the same step."""
    g = _graph_case(11)
    rng = np.random.RandomState(12)
    clean = g["x"][:, :3] + 0.05 * rng.randn(N, 3)
    node_mask = np.arange(N) < N - 5
    g["node_mask"] = node_mask
    kw = dict(NETWORK)
    net = egnn_tpu.EGNNSparseNetwork(**kw)
    params = net.init(jax.random.PRNGKey(1), jnp.asarray(g["x"]), jnp.asarray(g["edge_index"]),
                      edge_attr=jnp.asarray(g["edge_attr"]), batch=jnp.asarray(g["batch"]),
                      edge_mask=jnp.asarray(g["edge_mask"]), num_graphs=G)["params"]
    params_np = jax.tree_util.tree_map(np.array, params)   # before the step donates them
    mesh = jpar.make_mesh(data=1, graph=SHARDS, devices=jax.devices()[:SHARDS])
    pe = jpar.partition_edges(jnp.asarray(g["edge_index"][0]), jnp.asarray(g["edge_index"][1]),
                              N, SHARDS, edge_attr=jnp.asarray(g["edge_attr"]),
                              edge_mask=jnp.asarray(g["edge_mask"]))
    step = jtrain.make_partitioned_sparse_train_step(
        egnn_tpu.EGNNSparseNetwork(**kw, shard_axis="graph"), mesh, num_graphs=G)
    sp = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("graph")))  # noqa: E731
    state = jax.device_put(jtrain.TrainState.create(params, jtrain.make_adam(1e-3)),
                           NamedSharding(mesh, P()))
    state, loss = step(state, sp(g["x"]), sp(pe.senders), sp(pe.receivers), sp(pe.mask),
                       sp(pe.edge_attr), sp(g["batch"]), sp(clean), sp(node_mask))
    jflat = {}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if hasattr(v, "items"):
                flat(v, f"{prefix}{k}.")
            else:
                jflat[f"{prefix}{k}"] = np.asarray(v)

    flat(state.params)
    return (float(loss), jflat), dict(kind="step", kw=kw, params=params_np, inputs=g,
                                      clean=clean)


def test_partitioned_train_step_matches_jax(sharded):
    """``make_partitioned_sparse_train_step`` at 2 ranks against JAX's at 2
    devices: the loss and the parameters after one Adam step; both ranks'
    parameters bitwise equal."""
    expect, ranks = sharded
    loss, jflat = expect["step"]
    for res in ranks:
        np.testing.assert_allclose(res["step"]["loss"], loss, rtol=1e-9)
        assert sorted(res["step"]["params"]) == sorted(jflat)
        for name, value in jflat.items():
            np.testing.assert_allclose(res["step"]["params"][name], value, rtol=1e-8,
                                       atol=1e-10, err_msg=name)
            np.testing.assert_array_equal(res["step"]["params"][name],
                                          ranks[0]["step"]["params"][name])
