"""The port's ring (``egnn_tpu_torch/parallel/ring.py``,
``EGNN(ring_axis=group)``, ``training.make_ring_denoise_train_step``)
against ``egnn_tpu``'s on the CPU, ranks as processes under gloo
(``test_torch_parallel.run_ranks``), the JAX side on a mesh of the same
shard count over the first 2 or 4 of conftest's 8 virtual devices: the
cases of ``tests/test_ring.py``.

Held here: ``ring_permute`` forward and backward (wrap and no wrap, a
tuple of float and bool tensors in one message); the ring layer (sum and
mean pooling, with and without a mask) at 2 and 4 ranks against JAX's ring
layer and against the port's one-process streamed layer, gradients too;
the ring train step on a (data=2, graph=2) mesh against JAX's (loss and
parameters after 2 Adam steps; the ranks' parameters bitwise equal); bf16
against the streamed bf16 layer; the refusals (kNN, dense edges, dropout in
training mode, a string for a group).

Float64 throughout (bf16 case aside). Outputs and gradients agree at 1e-9
times the tensor's largest magnitude where that exceeds 1 (the same
arithmetic, the j-blocks summed in another order). One spawn of 4 ranks
runs every case, the 2-rank cases on two pairs of ranks at once. No JAX at
this file's top: a spawned rank imports it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_parallel import _named, _np, run_ranks

F64 = dict(device="cpu", dtype=torch.float64)
ATOL = 1e-9
B, N, D = 2, 32, 8
NET_KW = dict(depth=2, dim=D, num_tokens=7)
STEPS = 2


def _close(actual, desired, atol=ATOL, name=""):
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max())) if desired.size else 1.0
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0, atol=atol * scale,
                               err_msg=name)


def _layer_inputs(seed, b=B, n=N, d=D):
    rng = np.random.RandomState(seed)
    return rng.randn(b, n, d), rng.randn(b, n, 3), rng.rand(b, n) > 0.2


LAYER_CASES = [(pool, with_mask) for pool in ("sum", "mean") for with_mask in (True, False)]


# ---------------------------------------------------------------------------
# rank-side cases (no JAX here)
# ---------------------------------------------------------------------------

def _block(t, rank, world, dim=1):
    step = t.shape[dim] // world
    return t.narrow(dim, rank * step, step)


def permute_cases(group):
    from egnn_tpu_torch.parallel.collectives import ring_permute

    rank = dist.get_rank(group)
    out = {}
    for wrap in (True, False):
        x = torch.full((2, 3), float(rank + 1), dtype=torch.float64, requires_grad=True)
        m = torch.arange(4) % (rank + 2) == 0
        y, ym = ring_permute((x, m), group, wrap=wrap)
        (y * (rank + 1) * torch.arange(6.0, dtype=torch.float64).reshape(2, 3)).sum().backward()
        out[wrap] = dict(y=_np(y), mask=_np(ym), x_grad=_np(x.grad),
                         mask_grad=ym.requires_grad)
    return out


def ring_layer_cases(group, cases):
    """The ring layer on this rank's node block, each case's output and the
    gradients of <output, cot> (this rank's share of the parameters', its
    rows of the inputs'); the one-process streamed layer on the whole
    inputs for the same weights, on the group's rank 0."""
    from egnn_tpu_torch import EGNN
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    out = {}
    for case in cases:
        pool, with_mask = case["key"]
        dtype = torch.float64 if case.get("dtype", "f64") == "f64" else torch.float32
        compute = torch.bfloat16 if case.get("bf16") else None
        kw = dict(dim=D, m_pool_method=pool, norm_coors=True, compute_dtype=compute,
                  device="cpu", dtype=dtype)
        ring = EGNN(**kw, ring_axis=group)
        load_flax_params(ring, case["params"])
        feats, coors = (torch.from_numpy(a).to(dtype) for a in case["inputs"][:2])
        mask = torch.from_numpy(case["inputs"][2]) if with_mask else None
        f = _block(feats, rank, world).clone().requires_grad_()
        c = _block(coors, rank, world).clone().requires_grad_()
        fo, co = ring(f, c, mask=None if mask is None else _block(mask, rank, world))
        cf, cc = (_block(torch.from_numpy(a).to(dtype), rank, world) for a in case["cot"])
        ((fo * cf).sum() + (co * cc).sum()).backward()
        res = dict(f=_np(fo.detach()), c=_np(co.detach()), f_grad=_np(f.grad),
                   c_grad=_np(c.grad),
                   grads={k: _np(v.grad) for k, v in ring.named_parameters()})
        if rank == 0:
            ref = EGNN(**kw, stream_pairwise=True, pairwise_chunk=8)
            load_flax_params(ref, case["params"])
            f, c = feats.clone().requires_grad_(), coors.clone().requires_grad_()
            fo, co = ref(f, c, mask=mask)
            cf, cc = (torch.from_numpy(a).to(dtype) for a in case["cot"])
            ((fo * cf).sum() + (co * cc).sum()).backward()
            res["streamed"] = dict(f=_np(fo.detach()), c=_np(co.detach()), f_grad=_np(f.grad),
                                   c_grad=_np(c.grad),
                                   grads={k: _np(v.grad) for k, v in ref.named_parameters()})
        out[case["name"]] = res
    return out


def ring_step_case(rank, world, p):
    """``make_ring_denoise_train_step`` on a (data=2, graph=world/2) mesh,
    each rank on its block; also the refusals of the ring's options."""
    from egnn_tpu_torch import EGNN, EGNNNetwork, parallel, training
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    mesh = parallel.make_mesh(2, world // 2, device="cpu")
    ring = mesh.get_group("graph")
    net = EGNNNetwork(**NET_KW, layer_kwargs=dict(ring_axis=ring), **F64)
    load_flax_params(net, p["params"])
    opt = training.make_adam(net.parameters(), 1e-3)
    step = training.make_ring_denoise_train_step(net, opt, mesh)
    tokens, noised, clean, mask = (parallel.dense_batch_block(mesh, torch.from_numpy(a))
                                   for a in p["batch"])
    losses = [step(tokens, noised, clean, mask).item() for _ in range(STEPS)]
    refused = {}
    for name, make in (
            ("knn", lambda: EGNN(dim=4, num_nearest_neighbors=2, ring_axis=ring, **F64)),
            ("sparse", lambda: EGNN(dim=4, only_sparse_neighbors=True, ring_axis=ring, **F64)),
            ("string", lambda: EGNN(dim=4, ring_axis="graph", **F64)),
            ("edges", lambda: EGNN(dim=4, edge_dim=2, ring_axis=ring, **F64)(
                torch.zeros(1, 4, 4, **F64), torch.zeros(1, 4, 3, **F64),
                edges=torch.zeros(1, 4, 4, 2, **F64))),
            ("dropout", lambda: EGNN(dim=4, dropout=0.1, ring_axis=ring, **F64)(
                torch.zeros(1, 4, 4, **F64), torch.zeros(1, 4, 3, **F64),
                generator=torch.Generator())),
            ("positions", lambda: training.make_ring_denoise_train_step(
                EGNNNetwork(depth=1, dim=4, num_positions=8,
                            layer_kwargs=dict(ring_axis=ring), **F64), opt, mesh)),
            ("no ring", lambda: training.make_ring_denoise_train_step(
                EGNNNetwork(depth=1, dim=4, **F64), opt, mesh))):
        try:
            make()
            refused[name] = None
        except (ValueError, TypeError) as e:
            refused[name] = type(e).__name__
    return dict(losses=losses, params=_named(net), refused=refused)


def ring_cases(rank, world, p):
    """Every case in one spawn of 4 ranks: the 2-rank cases on the groups
    {0, 1} and {2, 3} at once, then the 4-rank cases and the step."""
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[rank // 2]
    out = {2: dict(permute=permute_cases(pair), layer=ring_layer_cases(pair, p["cases"][2]))}
    group = dist.group.WORLD
    out[4] = dict(permute=permute_cases(group), layer=ring_layer_cases(group, p["cases"][4]),
                  step=ring_step_case(rank, world, p["step"]))
    return out


# ---------------------------------------------------------------------------
# the JAX side and the spawns
# ---------------------------------------------------------------------------

def _jax_ring_layer(G, pool, mask_np, feats, coors, params, compute_dtype=None):
    import jax
    from jax.sharding import PartitionSpec as P

    from egnn_tpu import EGNN as JEGNN
    from egnn_tpu.parallel import make_mesh

    mesh = make_mesh(data=1, graph=G, devices=jax.devices()[:G])
    layer = JEGNN(dim=D, ring_axis="graph", m_pool_method=pool, norm_coors=True,
                  compute_dtype=compute_dtype)
    node, row = P(None, "graph", None), P(None, "graph")

    def fwd(prm, f, c, *m):
        return layer.apply({"params": prm}, f, c, mask=m[0] if m else None)

    args = (params, feats, coors) + ((mask_np,) if mask_np is not None else ())
    specs = (P(), node, node) + ((row,) if mask_np is not None else ())
    run = jax.shard_map(fwd, mesh=mesh, in_specs=specs, out_specs=(node, node),
                        check_vma=False)

    def loss(prm, f, c, cf, cc):
        fo, co = run(prm, f, c, *args[3:])
        return (fo * cf).sum() + (co * cc).sum(), (fo, co)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))


def _layer_payload(G):
    import jax
    import jax.numpy as jnp

    from egnn_tpu import EGNN as JEGNN

    cases, refs = [], {}
    for i, (pool, with_mask) in enumerate(LAYER_CASES):
        feats, coors, mask = _layer_inputs(i)
        cot = _layer_inputs(100 + i)[:2]
        params = JEGNN(dim=D, stream_pairwise=True, pairwise_chunk=8, m_pool_method=pool,
                       norm_coors=True).init(jax.random.PRNGKey(i), jnp.asarray(feats),
                                             jnp.asarray(coors))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        (_, (fo, co)), (gp, gf, gc) = _jax_ring_layer(G, pool, mask if with_mask else None,
                                                      feats, coors, params)(
            params, feats, coors, *cot)
        name = f"{pool}_{'mask' if with_mask else 'none'}"
        cases.append(dict(name=name, key=(pool, with_mask), params=params,
                          inputs=(feats, coors, mask), cot=cot))
        refs[name] = dict(f=np.asarray(fo), c=np.asarray(co), f_grad=np.asarray(gf),
                          c_grad=np.asarray(gc),
                          grads=jax.tree_util.tree_map(np.asarray, gp))
    return cases, refs


def _bf16_payload():
    """The bf16 case: the ring against the streamed bf16 layer, f32 weights
    and inputs."""
    import jax
    import jax.numpy as jnp

    from egnn_tpu import EGNN as JEGNN

    feats, coors, mask = (a.astype(np.float32) if a.dtype == np.float64 else a
                          for a in _layer_inputs(2))
    layer = JEGNN(dim=D, stream_pairwise=True, pairwise_chunk=8, norm_coors=True,
                  compute_dtype=jnp.bfloat16)
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(feats), jnp.asarray(coors),
                        mask=jnp.asarray(mask))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params["params"])
    fo, co = jax.jit(layer.apply)({"params": params}, feats, coors, mask=mask)
    case = dict(name="bf16", key=("sum", True), params=params, inputs=(feats, coors, mask),
                cot=(np.zeros_like(feats), np.zeros_like(coors)), dtype="f32", bf16=True)
    return case, dict(f=np.asarray(fo, np.float32), c=np.asarray(co, np.float32))


def _step_payload():
    """The JAX ring step on a (data=2, graph=2) mesh of 4 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from egnn_tpu import EGNNNetwork as JNet
    from egnn_tpu import training as jtrain
    from egnn_tpu.parallel import make_mesh
    from egnn_tpu.training.state import make_ring_denoise_train_step

    rng = np.random.RandomState(7)
    b = 4
    tokens = rng.randint(0, 7, size=(b, N))
    clean = rng.randn(b, N, 3)
    noised = clean + 0.1 * rng.randn(b, N, 3)
    mask = rng.rand(b, N) > 0.2
    mesh = make_mesh(data=2, graph=2, devices=jax.devices()[:4])
    jnet = JNet(**NET_KW, layer_kwargs=dict(ring_axis="graph"))
    params = JNet(**NET_KW, layer_kwargs=dict(stream_pairwise=True, pairwise_chunk=8)).init(
        jax.random.PRNGKey(1), jnp.asarray(tokens), jnp.asarray(noised),
        mask=jnp.asarray(mask))["params"]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    state = jtrain.TrainState.create(params, jtrain.make_adam(1e-3))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = make_ring_denoise_train_step(jnet, mesh)

    def put(x, spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

    args = (put(tokens, P("data", "graph")), put(noised, P("data", "graph", None)),
            put(clean, P("data", "graph", None)), put(mask, P("data", "graph")))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, *args)
        losses.append(float(loss))
    return (dict(params=params_np, batch=(tokens, noised, clean, mask)),
            dict(losses=losses, params=_flat(jax.tree_util.tree_map(np.asarray, state.params))))


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """The JAX references at 2 and 4 shards and one spawn of 4 ranks."""
    bf16_case, bf16_ref = _bf16_payload()
    cases, refs = {}, {}
    for world in (2, 4):
        cases[world], refs[world] = _layer_payload(world)
        cases[world].append(bf16_case)
        refs[world]["bf16"] = bf16_ref
    step_payload, step_ref = _step_payload()
    ranks = run_ranks(ring_cases, 4, tmp_path_factory.mktemp("ring"),
                      dict(cases=cases, step=step_payload))
    return {2: dict(ranks=[r[2] for r in ranks[:2]], refs=refs[2]),
            4: dict(ranks=[r[4] for r in ranks], refs=refs[4], step_ref=step_ref)}


def _cat(ranks, key, name, field):
    return np.concatenate([r[key][name][field] for r in ranks], axis=1)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_permute_forward_and_backward(ring_runs, world):
    ranks = ring_runs[world]["ranks"]
    for wrap in (True, False):
        for r, res in enumerate(ranks):
            res = res["permute"][wrap]
            src = (r - 1) % world
            got = wrap or r > 0
            np.testing.assert_array_equal(res["y"], np.full((2, 3), src + 1.0) if got else 0.0)
            np.testing.assert_array_equal(
                res["mask"], (np.arange(4) % (src + 2) == 0) if got else False)
            assert not res["mask_grad"]
            # the cotangent of rank r + 1's output comes back to rank r
            dst = (r + 1) % world
            sent = wrap or r < world - 1
            np.testing.assert_array_equal(
                res["x_grad"], (dst + 1) * np.arange(6.0).reshape(2, 3) if sent else 0.0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("pool,with_mask", LAYER_CASES)
def test_ring_layer_matches_jax_and_streamed(ring_runs, world, pool, with_mask):
    name = f"{pool}_{'mask' if with_mask else 'none'}"
    ranks, ref = ring_runs[world]["ranks"], ring_runs[world]["refs"][name]
    streamed = ranks[0]["layer"][name]["streamed"]
    for field in ("f", "c", "f_grad", "c_grad"):
        got = _cat(ranks, "layer", name, field)
        _close(got, ref[field], name=field)
        _close(got, streamed[field], name=f"streamed {field}")
    for k, g in ref["grads"].items():
        total = sum(r["layer"][name]["grads"][k] for r in ranks)
        _close(total, g, name=k)
        _close(total, streamed["grads"][k], name=f"streamed {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_ring_bf16_matches_streamed_bf16(ring_runs, world):
    """``tests/test_ring.py:123``: the bf16 ring tracks the streamed bf16
    layer (JAX's, and the port's) at 3e-2."""
    ranks, ref = ring_runs[world]["ranks"], ring_runs[world]["refs"]["bf16"]
    streamed = ranks[0]["layer"]["bf16"]["streamed"]
    for field in ("f", "c"):
        got = _cat(ranks, "layer", "bf16", field)
        np.testing.assert_allclose(got, ref[field], rtol=0, atol=3e-2)
        np.testing.assert_allclose(got, streamed[field], rtol=0, atol=3e-2)


def test_ring_train_step_matches_jax(ring_runs):
    run = ring_runs[4]
    ref = run["step_ref"]
    for res in (r["step"] for r in run["ranks"]):
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-9, atol=0)
        assert sorted(res["params"]) == sorted(ref["params"])
        for name, value in ref["params"].items():
            np.testing.assert_allclose(res["params"][name], value, rtol=1e-8, atol=1e-10,
                                       err_msg=name)


def test_ring_train_step_ranks_bitwise_equal(ring_runs):
    ranks = [r["step"] for r in ring_runs[4]["ranks"]]
    for res in ranks[1:]:
        assert res["losses"] == ranks[0]["losses"]
        for name, value in ranks[0]["params"].items():
            np.testing.assert_array_equal(res["params"][name], value, err_msg=name)


def test_ring_refusals(ring_runs):
    """What would compute shard-local neighbourhoods is refused: kNN and
    ``only_sparse_neighbors`` at construction, dense edges and dropout in
    training mode at the call, a network with positions or without the
    mesh's ring at the step; an axis name in place of a group raises
    ``TypeError``."""
    refused = ring_runs[4]["ranks"][0]["step"]["refused"]
    assert refused == {"knn": "ValueError", "sparse": "ValueError", "string": "TypeError",
                       "edges": "ValueError", "dropout": "ValueError",
                       "positions": "ValueError", "no ring": "ValueError"}
