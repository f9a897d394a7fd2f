"""The port's tensor parallelism (``egnn_tpu_torch/parallel/tp.py``)
against ``egnn_tpu``'s on the CPU, ranks as processes under gloo
(``test_torch_parallel.run_ranks``), the JAX side on a ``(data, model)``
mesh of the same shard count over the first 2 or 4 of conftest's 8 virtual
devices, its parameters placed by ``tp_param_sharding`` (GSPMD): the cases
of ``tests/test_tp.py``.

Held here: the spec rules and their placements; ``EGNN(dim=64, m_dim=32)``
at model = 2 (its edge hidden 258 shards) and 4 (it stays replicated):
outputs and the gradients of the parameters and of the inputs; the kNN
network (depth 2) loss and gradients; ``tp_hidden_multiple``'s padding,
which shards 4 ways; the streamed all-pairs layer and the fused kernels'
plain versions (``fused_pairs``, ``fused_knn``: the weights gathered whole)
against the replicated module; ``make_sharded_denoise_train_step`` on a
(data=2, model=2) mesh against the one-process step on the whole batch;
the sparse family at model = 2 (``EGNNSparse`` with fourier features, both
norms and the soft gate; ``uniform_degree`` with the mean and the clamp;
``fused_uniform`` through K10's plain version, the JAX side on its per-edge
path; an ``EGNNSparseNetwork`` with an embedding over the fused layers):
placements, output and every gradient against JAX's ``tp_param_sharding``
run and the replicated module; dropout in training mode (the dense layer
materialised, streamed and over kNN, the sparse layer) at model = 2 and 4
against the replicated module with the same generator state: each rank
draws the whole hidden width's masks and keeps its columns; the refusal of
a module without the hooks whose parameters the rule matches. A sharded
gradient is this rank's block of the replicated module's, and no gradient
is scaled by the axis size.

Float64 throughout, at 1e-9 times the tensor's largest magnitude where that
exceeds 1 (the products split in another order). One spawn of 4 ranks runs
every case: model = 2 on a (data=2, model=2) mesh, both pairs at once, and
model = 4 on a (1, 4) mesh. No JAX at this file's top: a spawned rank
imports it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_parallel import _np, run_ranks

F64 = dict(device="cpu", dtype=torch.float64)
ATOL = 1e-9
LAYER_KW = dict(dim=64, m_dim=32)
NET_KW = dict(depth=2, dim=32, num_tokens=7, layer_kwargs=dict(num_nearest_neighbors=4))
PAD_KW = dict(dim=32, tp_hidden_multiple=16)
EXTRA = {   # checked against the replicated module (and the JAX layer where it runs them)
    "streamed": dict(dim=16, stream_pairwise=True, pairwise_chunk=8, m_pool_method="mean",
                     norm_coors=True),
    "fused_pairs": dict(dim=16, num_nearest_neighbors=4, fused_pairs=True, norm_coors=True,
                        coor_weights_clamp_value=2.0),
    "fused_knn": dict(dim=16, num_nearest_neighbors=4, fused_knn=True, norm_coors=True),
}
STEP_KW = dict(depth=2, dim=16, num_tokens=7,
               layer_kwargs=dict(num_nearest_neighbors=4, norm_coors=True))
STEPS = 2
DROPOUT = {   # in training mode at rate 0.1, against the replicated module
    "dense_materialised": dict(dim=16, norm_coors=True, init_eps=0.1),
    "dense_streamed": dict(dim=16, stream_pairwise=True, pairwise_chunk=8, norm_coors=True,
                           init_eps=0.1),
    "dense_knn": dict(dim=16, num_nearest_neighbors=4, norm_coors=True, init_eps=0.1),
    "sparse": dict(feats_dim=8, fourier_features=2, norm_feats=True, norm_coors=True,
                   soft_edge=1),
}
SPARSE_K = 4
SPARSE = {   # (network?, options); the JAX side runs fused_uniform=False
    "sparse_fourier": (False, dict(feats_dim=8, fourier_features=2, norm_feats=True,
                                   norm_coors=True, soft_edge=1)),
    "sparse_uniform": (False, dict(feats_dim=8, uniform_degree=SPARSE_K, aggr="mean",
                                   norm_coors=True, coor_weights_clamp_value=2.0)),
    "sparse_fused": (False, dict(feats_dim=8, uniform_degree=SPARSE_K, fused_uniform=True,
                                 norm_coors=True, soft_edge=1)),
    "sparse_network": (True, dict(n_layers=2, feats_dim=1, embedding_nums=[5],
                                  embedding_dims=[8], fourier_features=2, norm_feats=True,
                                  norm_coors=True, uniform_degree=SPARSE_K,
                                  fused_uniform=True)),
}


def _close(actual, desired, atol=ATOL, name=""):
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max())) if desired.size else 1.0
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0, atol=atol * scale,
                               err_msg=name)


def _inputs(seed, b, n, d):
    rng = np.random.RandomState(seed)
    return rng.randn(b, n, d), rng.randn(b, n, 3), rng.rand(b, n) > 0.2


# ---------------------------------------------------------------------------
# rank-side cases (no JAX here)
# ---------------------------------------------------------------------------

def _placement(p):
    from torch.distributed.tensor import Shard

    return ("shard", p.dim) if isinstance(p, Shard) else ("replicate", None)


def _run(module, inputs, kwargs):
    """Output and the gradients of sum(c^2) + sum(f^2): the parameters'
    (this rank's shards) and the inputs' (tokens have none)."""
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t for t in inputs]
    f, c = module(*leaves, **kwargs)
    loss = (c ** 2).sum() + (f ** 2).sum()
    loss.backward()
    return dict(f=_np(f.detach()), c=_np(c.detach()), loss=loss.item(),
                input_grads=[_np(t.grad) for t in leaves if t.is_floating_point()],
                grads={k: _np(v.grad) for k, v in module.named_parameters()})


def tp_mesh_cases(mesh, p):
    from egnn_tpu_torch import EGNN, EGNNNetwork, parallel
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    out = {}
    for name, cls, kw in (("layer", EGNN, LAYER_KW), ("network", EGNNNetwork, NET_KW),
                          ("padded", EGNN, PAD_KW),
                          *[(k, EGNN, v) for k, v in EXTRA.items()]):
        case = p[name]
        inputs = [torch.from_numpy(a) for a in case["inputs"]]
        kwargs = {k: torch.from_numpy(v) for k, v in case.get("kwargs", {}).items()}
        module = cls(**kw, **F64)
        load_flax_params(module, case["params"])
        placements = {k: _placement(v)
                      for k, v in parallel.tp_param_sharding(module, mesh).items()}
        replicated = _run(module, inputs, kwargs)
        module.zero_grad(set_to_none=True)
        parallel.tp_shard_module(module, mesh)
        res = _run(module, inputs, kwargs)
        layer = module.egnn_0 if name == "network" else module
        res.update(placements=placements, replicated=replicated,
                   sharded=sorted(layer.tp_sharded))
        out[name] = res
    return out


def tp_step_case(mesh, p):
    """``make_sharded_denoise_train_step`` on a (data=2, model=2) mesh
    against ``make_denoise_train_step`` on the whole batch, in one rank."""
    from egnn_tpu_torch import EGNNNetwork, parallel, training
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    batch = [torch.from_numpy(a) for a in p["batch"]]
    nets = [EGNNNetwork(**STEP_KW, **F64) for _ in range(2)]
    for net in nets:
        load_flax_params(net, p["params"])
    ref = training.make_denoise_train_step(nets[0], training.make_adam(nets[0].parameters()))
    ref_losses = [ref(*batch).item() for _ in range(STEPS)]
    parallel.tp_shard_module(nets[1], mesh)
    step = training.make_sharded_denoise_train_step(
        nets[1], training.make_adam(nets[1].parameters()), mesh)
    block = [parallel.dense_batch_block(mesh, t) for t in batch[:3]] + [
        batch[3], parallel.dense_batch_block(mesh, batch[4])]
    losses = [step(*block).item() for _ in range(STEPS)]
    placements = {k: _placement(v) for k, v in parallel.tp_param_sharding(nets[0], mesh).items()}
    return dict(losses=losses, ref_losses=ref_losses, placements=placements,
                params={k: _np(v) for k, v in nets[1].named_parameters()},
                ref_params={k: _np(v) for k, v in nets[0].named_parameters()})


def sparse_tp_cases(mesh, p):
    """The sparse family's cases: output and the gradients of <out, cot>
    (the parameters', this rank's shards; x's) of the replicated module and
    of the sharded one."""
    from egnn_tpu_torch import EGNNSparse, EGNNSparseNetwork, parallel
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    out = {}
    for name, (network, kw) in SPARSE.items():
        case = p[name]
        module = (EGNNSparseNetwork if network else EGNNSparse)(**kw, **F64)
        load_flax_params(module, case["params"])
        args = [torch.from_numpy(case["edge_index"])]
        kwargs = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                  for k, v in case["kwargs"].items()}
        placements = {k: _placement(v)
                      for k, v in parallel.tp_param_sharding(module, mesh).items()}

        def run():
            x = torch.from_numpy(case["x"]).requires_grad_()
            y = module(x, *args, **kwargs)
            (y * torch.from_numpy(case["cot"])).sum().backward()
            res = dict(out=_np(y.detach()), x_grad=_np(x.grad),
                       grads={k: _np(v.grad) for k, v in module.named_parameters()})
            module.zero_grad(set_to_none=True)
            return res

        replicated = run()
        parallel.tp_shard_module(module, mesh)
        res = run()
        layer = module.mpnn_0 if network else module
        res.update(placements=placements, replicated=replicated,
                   sharded=sorted(layer.tp_sharded))
        out[name] = res
    return out


def tp_dropout_cases(mesh):
    """``DROPOUT``'s modules in training mode, replicated and then sharded,
    each called with a generator seeded alike: the outputs and the
    gradients of <out, cot> (the inputs', the parameters': this rank's
    shards), and the placements."""
    from egnn_tpu_torch import EGNN, EGNNSparse, parallel
    from egnn_tpu_torch.ops.graph import knn_graph

    rng = np.random.RandomState(31)
    out = {}
    for name, kw in DROPOUT.items():
        gen = torch.Generator().manual_seed(7)
        if name == "sparse":
            module = EGNNSparse(**kw, dropout=0.1, **F64, generator=gen)
            coors = torch.from_numpy(1.5 * rng.randn(24, 3))
            es = knn_graph(coors, SPARSE_K, graph_size=12)
            x = torch.cat([coors, torch.from_numpy(rng.randn(24, 8))], dim=-1)
            inputs, kwargs = [x], dict(edge_index=es.edge_index, edge_mask=es.mask,
                                       batch=torch.arange(24) // 12, num_graphs=2)
        else:
            module = EGNN(**kw, dropout=0.1, **F64, generator=gen)
            feats, coors, mask = _inputs(40, 2, 16, kw["dim"])
            inputs = [torch.from_numpy(feats), torch.from_numpy(coors)]
            kwargs = dict(mask=torch.from_numpy(mask))
        placements = {k: _placement(v)
                      for k, v in parallel.tp_param_sharding(module, mesh).items()}

        def run():
            leaves = [t.clone().requires_grad_() for t in inputs]
            res = module(*leaves, **kwargs, generator=torch.Generator().manual_seed(11))
            res = res if isinstance(res, tuple) else (res,)
            loss = sum((r * torch.from_numpy(np.random.RandomState(i).randn(*r.shape))).sum()
                       for i, r in enumerate(res))
            loss.backward()
            got = dict(outs=[_np(r.detach()) for r in res],
                       input_grads=[_np(t.grad) for t in leaves],
                       grads={k: _np(v.grad) for k, v in module.named_parameters()})
            module.zero_grad(set_to_none=True)
            return got

        replicated = run()
        parallel.tp_shard_module(module, mesh)
        res = run()
        res.update(placements=placements, replicated=replicated,
                   sharded=sorted(module.tp_sharded))
        out[name] = res
    return out


def tp_refusals(mesh):
    """What tensor parallelism runs and refuses: the sparse layer shards and
    runs (it was refused before its hooks); a module without the hooks
    raises."""
    from egnn_tpu_torch import EGNNSparse, parallel

    def outcome(fn):
        try:
            fn()
            return "runs"
        except (NotImplementedError, ValueError) as e:
            return type(e).__name__

    x, ei = torch.randn(4, 3 + 8, **F64), torch.tensor([[1, 2, 3, 0], [0, 1, 2, 3]])
    sparse = EGNNSparse(feats_dim=8, m_dim=16, **F64)
    other = torch.nn.Module()
    other.register_parameter("proj_0_w", torch.nn.Parameter(torch.zeros(4, 8, **F64)))
    return {
        "sparse": outcome(lambda: parallel.tp_shard_module(sparse, mesh)(x, ei)),
        "other": outcome(lambda: parallel.tp_shard_module(other, mesh)),
    }


def tp_cases(rank, world, p):
    from egnn_tpu_torch import parallel

    mesh2 = parallel.make_tp_mesh(2, 2, device="cpu")
    mesh4 = parallel.make_tp_mesh(1, 4, device="cpu")
    return {2: dict(cases=tp_mesh_cases(mesh2, p[2]), step=tp_step_case(mesh2, p["step"]),
                    sparse=sparse_tp_cases(mesh2, p["sparse"]),
                    dropout=tp_dropout_cases(mesh2)),
            4: dict(cases=tp_mesh_cases(mesh4, p[4]), refused=tp_refusals(mesh4),
                    dropout=tp_dropout_cases(mesh4))}


# ---------------------------------------------------------------------------
# the JAX side and the spawn
# ---------------------------------------------------------------------------

def _jax_case(name, model, seed):
    """The JAX module's parameters, inputs and, on a (1, model) mesh with
    ``tp_param_sharding``, its outputs and gradients."""
    import jax
    import jax.numpy as jnp

    from egnn_tpu import EGNN as JEGNN
    from egnn_tpu import EGNNNetwork as JNet
    from egnn_tpu.parallel.tp import make_tp_mesh, tp_param_sharding

    rng = np.random.RandomState(seed)
    if name == "network":
        module = JNet(**NET_KW)
        inputs = (rng.randint(0, 7, size=(1, 24)), rng.randn(1, 24, 3))
        kwargs = {}
    else:
        kw = {"layer": LAYER_KW, "padded": PAD_KW}.get(name) or {
            k: v for k, v in EXTRA[name].items() if k not in ("fused_pairs", "fused_knn")}
        module = JEGNN(**kw)
        feats, coors, mask = _inputs(seed, 2, 16 if name == "layer" else 24, kw["dim"])
        inputs = (feats, coors)
        kwargs = dict(mask=mask) if name != "layer" else {}
    params = module.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs),
                         **kwargs)["params"]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    if name in ("fused_pairs", "fused_knn"):   # held against the replicated module alone
        return dict(params=to_np(params), inputs=inputs, kwargs=kwargs), {}
    if name == "padded":
        # live weights in the padded hidden units' place too, as a trained
        # layer's would be: the padding must still shard and agree
        params = jax.tree_util.tree_map(
            lambda a: a + 0.01 * jnp.asarray(rng.randn(*a.shape)), params)

    def loss(prm, *floats):
        args = list(inputs)
        fi = iter(floats)
        args = [next(fi) if np.issubdtype(np.asarray(a).dtype, np.floating) else a
                for a in args]
        f, c = module.apply({"params": prm}, *args, **kwargs)
        return (c ** 2).sum() + (f ** 2).sum(), (f, c)

    floats = [a for a in inputs if np.issubdtype(np.asarray(a).dtype, np.floating)]
    argnums = tuple(range(len(floats) + 1))
    mesh = make_tp_mesh(data=1, model=model, devices=jax.devices()[:model])
    sharded = jax.device_put({"params": params}, tp_param_sharding({"params": params}, mesh))
    (value, (f, c)), grads = jax.jit(jax.value_and_grad(loss, argnums=argnums, has_aux=True))(
        sharded["params"], *floats)
    case = dict(params=to_np(params), inputs=inputs, kwargs=kwargs)
    ref = dict(f=np.asarray(f), c=np.asarray(c), loss=float(value),
               grads=_flat(to_np(grads[0])), input_grads=[np.asarray(g) for g in grads[1:]],
               specs=_flat(jax.tree_util.tree_map(lambda s: tuple(s.spec),
                                                  tp_param_sharding({"params": params},
                                                                    mesh)["params"])))
    return case, ref


def _jax_sparse_case(name, seed):
    """The sparse module's parameters, inputs and cotangent, and on a (1, 2)
    mesh with ``tp_param_sharding`` its output and gradients (the per-edge
    path: ``fused_uniform`` computes the same function)."""
    import jax
    import jax.numpy as jnp

    import egnn_tpu
    from egnn_tpu.parallel.tp import make_tp_mesh, tp_param_sharding

    from test_torch_sparse import G, _molecules

    network, kw = SPARSE[name]
    jkw = {**kw, "fused_uniform": False} if "fused_uniform" in kw else kw
    module = (egnn_tpu.EGNNSparseNetwork if network else egnn_tpu.EGNNSparse)(**jkw)
    mol = _molecules(seed, 0 if network else kw["feats_dim"])
    x = mol["x"]
    if network:
        x = np.concatenate([x, np.random.RandomState(seed).randint(0, 5, (x.shape[0], 1))],
                           axis=-1).astype(np.float64)
    kwargs = dict(batch=mol["batch"], edge_mask=mol["edge_mask"], num_graphs=G,
                  node_mask=mol["node_mask"])
    jkwargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    ei = jnp.asarray(mol["edge_index"])
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), ei, **jkwargs)["params"]
    out0 = module.apply({"params": params}, jnp.asarray(x), ei, **jkwargs)
    cot = np.random.RandomState(seed + 1).randn(*out0.shape)

    def loss(prm, xx):
        out = module.apply({"params": prm}, xx, ei, **jkwargs)
        return (out * jnp.asarray(cot)).sum(), out

    mesh = make_tp_mesh(data=1, model=2, devices=jax.devices()[:2])
    placed = jax.device_put({"params": params}, tp_param_sharding({"params": params}, mesh))
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        placed["params"], jnp.asarray(x))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    case = dict(params=to_np(params), x=x, edge_index=mol["edge_index"], kwargs=kwargs, cot=cot)
    ref = dict(out=np.asarray(out), x_grad=np.asarray(gx), grads=_flat(to_np(gp)),
               specs=_flat(jax.tree_util.tree_map(lambda s: tuple(s.spec),
                                                  tp_param_sharding({"params": params},
                                                                    mesh)["params"])))
    return case, ref


def _step_payload():
    import jax
    import jax.numpy as jnp

    from egnn_tpu import EGNNNetwork as JNet

    rng = np.random.RandomState(11)
    b, n = 4, 16
    tokens = rng.randint(0, 7, size=(b, n))
    clean = np.cumsum(rng.randn(b, n, 3), axis=1)
    noised = clean + rng.randn(b, n, 3)
    mask = np.arange(n)[None, :] < np.array([[16], [13], [9], [12]])
    adj = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1
    params = JNet(**STEP_KW).init(jax.random.PRNGKey(5), jnp.asarray(tokens),
                                  jnp.asarray(noised))["params"]
    return dict(params=jax.tree_util.tree_map(np.asarray, params),
                batch=(tokens, noised, clean, adj, mask))


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


CASES = ["layer", "network", "padded", *EXTRA]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    payload, refs = {"step": _step_payload(), "sparse": {}}, {}
    sparse_refs = {}
    for i, name in enumerate(SPARSE):
        payload["sparse"][name], sparse_refs[name] = _jax_sparse_case(name, 20 + i)
    for model in (2, 4):
        payload[model], refs[model] = {}, {}
        for i, name in enumerate(CASES):
            payload[model][name], refs[model][name] = _jax_case(name, model, i)
    ranks = run_ranks(tp_cases, 4, tmp_path_factory.mktemp("tp"), payload)
    # model = 2: ranks 0 and 1 form one model group (ranks 2 and 3 the other)
    return {2: dict(ranks=[r[2] for r in ranks[:2]], refs=refs[2], sparse_refs=sparse_refs),
            4: dict(ranks=[r[4] for r in ranks], refs=refs[4])}


def _whole(ranks, name, key, param, placement):
    """A parameter's tensor whole: the model ranks' shards concatenated
    along the sharded dimension, or (replicated) rank 0's, after checking
    every rank holds the same."""
    parts = [r["cases"][name][key][param] for r in ranks]
    kind, dim = placement
    if kind == "shard":
        return np.concatenate(parts, axis=dim)
    for part in parts[1:]:
        np.testing.assert_array_equal(part, parts[0], err_msg=param)
    return parts[0]


def test_spec_rules():
    from torch.distributed.tensor import Replicate, Shard

    from egnn_tpu_torch.parallel import tp_param_spec

    assert tp_param_spec("edge_mlp_0_w") == Shard(1)
    assert tp_param_spec("edge_mlp_0_b") == Shard(0)
    assert tp_param_spec("coors_mlp_1_w") == Shard(0)
    assert tp_param_spec("egnn_1.node_mlp_0_w") == Shard(1)
    for name in ("coors_mlp_1_b", "node_norm_gamma", "token_emb", "edge_gate_w",
                 "global_attn_0.attn1.to_q_w", "coors_norm_scale"):
        assert tp_param_spec(name) == Replicate(), name


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", ["layer", "network", "padded"])
def test_placements_match_jax(tp_runs, model, name):
    """``tp_param_sharding``: the JAX rule, indivisible widths replicated
    (at model 4 dim 64's edge hidden 258 and dim 32's 130); the padded
    hidden (144) shards 4 ways."""
    jspecs = tp_runs[model]["refs"][name]["specs"]
    placements = tp_runs[model]["ranks"][0]["cases"][name]["placements"]
    assert sorted(placements) == sorted(jspecs)
    for k, spec in jspecs.items():
        dims = [i for i, ax in enumerate(spec) if ax == "model"]
        assert placements[k] == (("shard", dims[0]) if dims else ("replicate", None)), k
    if name == "layer":
        assert placements["node_mlp_0_w"] == ("shard", 1)
        assert placements["edge_mlp_0_w"] == (("shard", 1) if model == 2 else
                                              ("replicate", None))
    if name == "padded":
        assert placements["edge_mlp_0_w"] == ("shard", 1)
        assert placements["edge_mlp_1_w"] == ("shard", 0)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", ["layer", "network", "padded"])
def test_tp_matches_jax_and_replicated(tp_runs, model, name):
    ranks, ref = tp_runs[model]["ranks"], tp_runs[model]["refs"][name]
    for r in ranks:
        res = r["cases"][name]
        for field in ("f", "c"):
            _close(res[field], ref[field], name=field)
            _close(res[field], res["replicated"][field], name=f"replicated {field}")
        np.testing.assert_allclose(res["loss"], ref["loss"], rtol=1e-12)
        for got, want, mine in zip(res["input_grads"], ref["input_grads"],
                                   res["replicated"]["input_grads"]):
            _close(got, want, name="input gradient")
            _close(got, mine, name="replicated input gradient")
    placements = ranks[0]["cases"][name]["placements"]
    for k, g in ref["grads"].items():
        whole = _whole(ranks, name, "grads", k, placements[k])
        _close(whole, g, name=k)
        _close(whole, ranks[0]["cases"][name]["replicated"]["grads"][k], name=f"replicated {k}")


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", list(EXTRA))
def test_tp_paths_match_replicated(tp_runs, model, name):
    """The streamed all-pairs path (its chunks' products split inside the
    recomputed blocks) and the fused kernels' plain versions (the sharded
    weights gathered whole, the node MLP split) against the replicated
    module, and the streamed layer against the JAX layer."""
    ranks, ref = tp_runs[model]["ranks"], tp_runs[model]["refs"][name]
    res0 = ranks[0]["cases"][name]
    assert res0["sharded"] == (["coors_mlp", "edge_mlp", "node_mlp"] if model == 2
                               else ["coors_mlp", "node_mlp"])
    for r in ranks:
        res = r["cases"][name]
        for field in ("f", "c"):
            _close(res[field], res["replicated"][field], name=field)
            if name == "streamed":
                _close(res[field], ref[field], name=f"jax {field}")
        for got, mine in zip(res["input_grads"], res["replicated"]["input_grads"]):
            _close(got, mine, name="input gradient")
    placements = res0["placements"]
    for k, g in res0["replicated"]["grads"].items():
        _close(_whole(ranks, name, "grads", k, placements[k]), g, name=k)


def test_tp_data_parallel_step_matches_one_process(tp_runs):
    """(data=2, model=2): each data pair on its half of the batch, each
    model pair on shards; the losses and, after 2 Adam steps, the
    parameters (the shards concatenated) of the one-process step on the
    whole batch."""
    ranks = [r["step"] for r in tp_runs[2]["ranks"]]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], res["ref_losses"], rtol=1e-10)
    for k, want in ranks[0]["ref_params"].items():
        kind, dim = ranks[0]["placements"][k]
        parts = [res["params"][k] for res in ranks]
        got = np.concatenate(parts, axis=dim) if kind == "shard" else parts[0]
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10, err_msg=k)


def test_tp_refusals(tp_runs):
    """The sparse layer, refused before it had the hooks, now shards and
    runs; a module without the hooks is refused."""
    assert tp_runs[4]["ranks"][0]["refused"] == {"sparse": "runs",
                                                 "other": "NotImplementedError"}


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", list(DROPOUT))
def test_tp_dropout_matches_replicated(tp_runs, model, name):
    """Dropout in training mode under tensor parallelism: a sharded MLP's
    hidden mask is the replicated module's, drawn at the whole width and
    cut to the rank's columns, so that the outputs and every gradient (the
    shards concatenated) equal the replicated module's with the same
    generator state at 1e-9 of the largest value. At model = 4 the edge
    MLP (hidden 66 dense, 42 sparse) stays replicated and draws as
    before."""
    ranks = [r["dropout"][name] for r in tp_runs[model]["ranks"]]
    res0 = ranks[0]
    assert res0["sharded"] == (["coors_mlp", "edge_mlp", "node_mlp"] if model == 2
                               else ["coors_mlp", "node_mlp"])
    for res in ranks:
        for got, want in zip(res["outs"] + res["input_grads"],
                             res["replicated"]["outs"] + res["replicated"]["input_grads"]):
            _close(got, want)
    for k, want in res0["replicated"]["grads"].items():
        kind, dim = res0["placements"][k]
        parts = [r["grads"][k] for r in ranks]
        _close(np.concatenate(parts, axis=dim) if kind == "shard" else parts[0], want, name=k)


@pytest.mark.parametrize("name", list(SPARSE))
def test_sparse_placements_match_jax(tp_runs, name):
    """``tp_param_sharding`` on the sparse family: the edge, coordinate and
    node MLPs' first weights by columns, their biases and second weights by
    rows, everything else replicated, as JAX places them."""
    jspecs = tp_runs[2]["sparse_refs"][name]["specs"]
    res = tp_runs[2]["ranks"][0]["sparse"][name]
    assert sorted(res["placements"]) == sorted(jspecs)
    for k, spec in jspecs.items():
        dims = [i for i, ax in enumerate(spec) if ax == "model"]
        assert res["placements"][k] == (("shard", dims[0]) if dims else ("replicate", None)), k
    assert res["sharded"] == ["coors_mlp", "edge_mlp", "node_mlp"]


@pytest.mark.parametrize("name", list(SPARSE))
def test_sparse_tp_matches_jax_and_replicated(tp_runs, name):
    """Output and the gradients of x and of every parameter (the shards
    concatenated) at model = 2 against JAX's sharded run and the replicated
    module, at 1e-9 of the largest value."""
    ranks, ref = tp_runs[2]["ranks"], tp_runs[2]["sparse_refs"][name]
    res0 = ranks[0]["sparse"][name]
    for r in ranks:
        res = r["sparse"][name]
        for field in ("out", "x_grad"):
            _close(res[field], ref[field], name=field)
            _close(res[field], res["replicated"][field], name=f"replicated {field}")
    assert sorted(res0["grads"]) == sorted(ref["grads"])
    for k, g in ref["grads"].items():
        kind, dim = res0["placements"][k]
        parts = [r["sparse"][name]["grads"][k] for r in ranks]
        if kind == "shard":
            whole = np.concatenate(parts, axis=dim)
        else:
            whole = parts[0]
            np.testing.assert_array_equal(parts[1], whole, err_msg=k)
        _close(whole, g, name=k)
        _close(whole, res0["replicated"]["grads"][k], name=f"replicated {k}")
