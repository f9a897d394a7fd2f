"""The dense step sharded over nodes (the mesh's ``graph`` axis) on the CPU:
the row-block mode of the selection kernels K1, K3 and K4, and
``make_sharded_denoise_train_step`` on (data, graph) meshes against
``egnn_tpu``'s on the same meshes of virtual devices.

Held here:

- the row block of the plain versions and of ``knn_select_block_model``
  (the kernel's traversal), for g = 2 and 4 blocks, bitwise against the
  whole selection's rows (indices and values, tie order included): a
  mask, a chain adjacency, a batched (b, n, n) adjacency, and tie pile-ups
  whose self column falls in another block's half of the table; the same
  rows against ``egnn_tpu.ops.neighbors.knn_select``;
- ``knn_select_gather_rows`` and its backward (into the whole table)
  against the whole ``knn_select_gather``'s rows and gradient;
- the sharded step on (data, graph) = (1, 2), (2, 2) and (1, 4) against
  JAX's ``make_sharded_denoise_train_step`` (losses rtol 1e-10, parameters
  rtol 1e-8 / atol 1e-10, the ranks' parameters bitwise equal) for the kNN
  network of ``test_torch_parallel.DENSE_KW``, with ``num_adj_degrees=2,
  adj_dim=4``, with global attention, as an all-pairs network (the ring
  over the graph group), as an all-pairs network with the degrees' dense
  edges (each rank's rows against the gathered cloud) and with
  ``only_sparse_neighbors`` over the degrees;
- ``fused_pairs`` (K10 on the rank's rows) and ``fused_knn`` (K11 with a
  j table: the gathered cloud) under the graph axis against the port's
  one-process fused step and JAX's unfused sharded step (1e-9 of the
  largest value); K11's j-table form in its plain versions against the
  whole-table form and its backward against autograd;
- a network with dense ``edges`` (each rank its rows' block), kNN and
  all-pairs, against the JAX network, outputs and every gradient;
- dropout in training mode on the kNN, dense-edge and ring routes at g = 2
  and 4: outputs and every gradient against the port's one-process network
  with the same generator state (the ring's against the streamed layer at
  ``pairwise_chunk = n / g``), at 1e-9 of the largest value.

Ranks are spawned processes under gloo (``test_torch_parallel.run_ranks``):
one spawn of two ranks, one of four. Float64 throughout with explicit
dtypes. No JAX at this file's top: a spawned rank imports it.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_parallel import DENSE_KW, _dense_batch, _named, _np, run_ranks

F64 = dict(device="cpu", dtype=torch.float64)
STEPS = 2
ATOL = 1e-9
CONFIGS = {
    "knn": DENSE_KW,
    "degrees": {**DENSE_KW, "num_adj_degrees": 2, "adj_dim": 4},
    "attention": {**DENSE_KW, "global_linear_attn_every": 1, "global_linear_attn_heads": 2,
                  "global_linear_attn_dim_head": 4, "num_global_tokens": 2},
    "all_pairs": {**DENSE_KW, "layer_kwargs": dict(norm_coors=True, coor_weights_clamp_value=2.0,
                                                   init_eps=0.1)},
    # the degrees' (b, n, n, adj_dim) edges reach every all-pairs layer
    "all_pairs_degrees": {**DENSE_KW, "num_adj_degrees": 2, "adj_dim": 4,
                          "layer_kwargs": dict(norm_coors=True, coor_weights_clamp_value=2.0,
                                               init_eps=0.1)},
    # k: JAX's jitted step takes num_nearest_neighbors (its adjacency is
    # traced), the port the expanded adjacency's largest row degree; on the
    # 2-degree chain that is 3 (each node, i - 2 and i + 2), so both take 3
    "sparse_neighbors": {**DENSE_KW, "num_adj_degrees": 2, "adj_dim": 4,
                         "layer_kwargs": dict(only_sparse_neighbors=True, num_nearest_neighbors=3,
                                              norm_coors=True, coor_weights_clamp_value=2.0,
                                              init_eps=0.1)},
}
SPARSE_NEIGHBORS_K = 3
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
FUSED = {flag: {**DENSE_KW, "layer_kwargs": {**DENSE_KW["layer_kwargs"], flag: True}}
         for flag in ("fused_pairs", "fused_knn")}
EDGES_KW = dict(depth=2, dim=8, edge_dim=2, layer_kwargs=dict(num_nearest_neighbors=4,
                                                              norm_coors=True, init_eps=0.1))
EDGES_ALL_PAIRS_KW = dict(depth=2, dim=8, edge_dim=2, layer_kwargs=dict(norm_coors=True,
                                                                        init_eps=0.1))
DROPOUT = 0.1
DROPOUT_ROUTES = {   # the graph axis's routes of a network in training mode
    "knn": {**CONFIGS["knn"], "layer_kwargs": {**CONFIGS["knn"]["layer_kwargs"],
                                               "dropout": DROPOUT}},
    "edges": {**CONFIGS["all_pairs_degrees"],
              "layer_kwargs": {**CONFIGS["all_pairs_degrees"]["layer_kwargs"],
                               "dropout": DROPOUT}},
    "ring": {**CONFIGS["all_pairs"], "layer_kwargs": {**CONFIGS["all_pairs"]["layer_kwargs"],
                                                      "dropout": DROPOUT}},
}


def _close(actual, desired, atol=ATOL, name=""):
    if isinstance(actual, torch.Tensor):
        actual, desired = actual.detach().numpy(), desired.detach().numpy()
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max())) if desired.size else 1.0
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0, atol=atol * scale,
                               err_msg=name)


# ---------------------------------------------------------------------------
# the row block of the selection
# ---------------------------------------------------------------------------

def _selection_case(name, seed=0, b=2, n=48):
    """coors (float32), mask, adjacency of a case: ``mask``, ``chain`` (an
    (n, n) chain expanded over b), ``batched`` (a (b, n, n) adjacency of its
    own per cloud) and ``ties`` (coordinates on a coarse lattice, pairs of
    duplicate nodes, one in each half of the table, a mask and the chain)."""
    rng = np.random.RandomState(seed)
    coors = rng.randn(b, n, 3).astype(np.float32)
    mask = adj = None
    if name == "mask":
        mask = rng.rand(b, n) > 0.3
    elif name == "chain":
        adj = np.broadcast_to(np.abs(np.arange(n)[:, None] - np.arange(n)[None]) == 1,
                              (b, n, n))
    elif name == "batched":
        adj = rng.rand(b, n, n) > 0.85
        mask = rng.rand(b, n) > 0.2
    elif name == "ties":
        coors = np.round(coors * 1.5).astype(np.float32)
        coors[:, n // 2:] = coors[:, :n // 2]
        mask = rng.rand(b, n) > 0.25
        adj = np.broadcast_to(np.abs(np.arange(n)[:, None] - np.arange(n)[None]) == 1,
                              (b, n, n))
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return t(coors), t(mask), t(adj)


SELECTION_CASES = ["mask", "chain", "batched", "ties"]
K = 6


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("case", SELECTION_CASES)
def test_row_block_plain_equals_whole_rows(case, g):
    from egnn_tpu_torch.ops.cuda import knn as kk

    coors, mask, adj = _selection_case(case)
    n = coors.shape[1]
    vals, idx = kk.knn_select_plain(coors, K, mask, adj)
    table = torch.randn(*coors.shape[:2], 5, generator=torch.Generator().manual_seed(1))
    R = n // g
    for r in range(g):
        block = (r * R, R)
        bv, bi = kk.knn_select_plain(coors, K, mask, adj, row_chunk=5, rows=block)
        assert torch.equal(bv, vals[:, r * R:(r + 1) * R]) and torch.equal(
            bi, idx[:, r * R:(r + 1) * R]), (case, g, r)
        # the wrappers' CPU paths: K1 (its rows from the whole table), K3, K4
        gv, gi, grows = kk.knn_select_gather(coors, K, table, mask, adj, rows=block)
        assert torch.equal(gv, bv) and torch.equal(gi, bi)
        assert torch.equal(grows, table[torch.arange(2)[:, None, None], bi])
        for fn in (kk.knn_select, kk.knn_select_tiled):
            fv, fi = fn(coors, K, mask, adj, rows=block)
            assert torch.equal(fv, bv) and torch.equal(fi, bi), fn.__name__


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("case", SELECTION_CASES)
def test_row_block_model_equals_whole_rows(case, g):
    """The kernel's traversal over a row block, at two plans (4 rows a warp
    over tiles of 128 columns; one row a warp, two stripes a row, K1's
    table), bitwise the whole rows."""
    from egnn_tpu_torch.ops.cuda import knn as kk

    coors, mask, adj = _selection_case(case, n=256)
    n = coors.shape[1]
    vals, idx = kk.knn_select_plain(coors, K, mask, adj)
    table = torch.randn(*coors.shape[:2], 5, generator=torch.Generator().manual_seed(2))
    R = n // g
    for r in range(g):
        rows = slice(r * R, (r + 1) * R)
        mv, mi, _ = kk.knn_select_block_model(coors, K, mask, adj, rows=4, tile=128,
                                              row_block=(r * R, R))
        assert torch.equal(mv, vals[:, rows]) and torch.equal(mi, idx[:, rows]), (case, g, r)
        mv, mi, mrows, _ = kk.knn_select_block_model(coors, K, mask, adj, rows=1, stripes=2,
                                                     table=table, row_block=(r * R, R))
        assert torch.equal(mv, vals[:, rows]) and torch.equal(mi, idx[:, rows])
        assert torch.equal(mrows, table[torch.arange(2)[:, None, None], mi])


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("case", SELECTION_CASES)
def test_row_block_matches_jax_knn_select(case, g):
    import jax.numpy as jnp

    from egnn_tpu.ops import neighbors as jnb
    from egnn_tpu_torch.ops.cuda import knn as kk

    coors, mask, adj = _selection_case(case)
    n = coors.shape[1]
    j = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    ref = jnb.knn_select(j(coors), K, math.inf, mask=j(mask), adj_mat=j(adj))
    R = n // g
    for r in range(g):
        bv, bi = kk.knn_select_plain(coors, K, mask, adj, rows=(r * R, R))
        np.testing.assert_array_equal(bi.numpy(), np.asarray(ref.indices)[:, r * R:(r + 1) * R])
        np.testing.assert_allclose(bv.numpy(), np.asarray(ref.ranking)[:, r * R:(r + 1) * R],
                                   rtol=1e-6, atol=1e-6)


def test_row_block_rejects_a_block_outside_the_points():
    from egnn_tpu_torch.ops.cuda import knn as kk

    coors, _, _ = _selection_case("mask")
    for rows in ((-1, 4), (40, 9), (0, 0)):
        with pytest.raises(ValueError, match="row block"):
            kk.knn_select(coors, K, rows=rows)


@pytest.mark.parametrize("n,tiled", [(48, False), (48, True)])
def test_select_gather_rows_and_backward_match_the_whole_call(n, tiled, monkeypatch):
    """``knn_select_gather_rows`` (K1's route; K4's where the full-band reach
    is lowered below n) against the whole call's rows; the gathered rows'
    gradient lands in the whole table's rows, and the blocks' gradients sum
    to the whole call's."""
    from egnn_tpu_torch.ops import neighbors as tnb
    from egnn_tpu_torch.ops.cuda import knn as kk

    if tiled:
        monkeypatch.setattr(kk, "FULL_BAND_MAX_N", 16)
    coors, mask, adj = _selection_case("ties", n=n)
    coors = coors.double().requires_grad_()
    feats = torch.randn(2, n, 4, dtype=torch.float64, requires_grad=True)
    cot = torch.randn(2, n, K, 3 + 1 + 4, dtype=torch.float64)
    whole, gw = tnb.knn_select_gather(coors, K, 100.0, mask=mask, adj_mat=adj, payload=feats,
                                      backend="tiled" if tiled else "auto")
    (gw * cot).sum().backward()
    want_c, want_f = coors.grad.clone(), feats.grad.clone()
    coors.grad = feats.grad = None
    R = n // 2
    for r in range(2):
        nb_r, g_r = tnb.knn_select_gather_rows(coors, K, 100.0, (r * R, R), mask=mask,
                                               adj_mat=adj, payload=feats)
        rows = slice(r * R, (r + 1) * R)
        assert torch.equal(nb_r.indices, whole.indices[:, rows])
        assert torch.equal(nb_r.ranking, whole.ranking[:, rows])
        assert torch.equal(nb_r.valid, whole.valid[:, rows])
        assert torch.equal(g_r, gw[:, rows])
        (g_r * cot[:, rows]).sum().backward()
    torch.testing.assert_close(coors.grad, want_c, rtol=0, atol=1e-12)
    torch.testing.assert_close(feats.grad, want_f, rtol=0, atol=1e-12)


@pytest.mark.parametrize("g", [2, 4])
def test_k11_j_table_plain_versions(g):
    """K11 with a j table (the rank's rows against the whole cloud): each
    block's forward equals the whole-table form's rows, the blocks' j-table
    gradients sum to the whole-table form's, and the hand-derived backward
    agrees with autograd of the forward (float64, at 1e-10 of each tensor's
    largest value)."""
    from egnn_tpu_torch.ops.cuda import pair_messages as PM

    rng = np.random.RandomState(g)
    b, n, k, c, h, m = 2, 16, 4, 3, 10, 6
    t = lambda *s: torch.from_numpy(rng.randn(*s))  # noqa: E731
    coors, proj_i, proj_j = t(b, n, c), t(b, n, h), t(b, n, h)
    # no slot holds its row's own node, whose norm_coors term (1/eps times
    # the others) cancels between the i and j sides only to rounding
    idx = torch.from_numpy((np.arange(n)[None, :, None] + rng.randint(1, n, (b, n, k))) % n)
    pv = torch.from_numpy(rng.rand(b, n, k) > 0.2)
    weights = (t(1, h), t(h, m), t(m), t(m, 1), t(1), t(m, 4 * m), t(4 * m), t(4 * m, 1), t(1),
               t(1).abs())
    opts = PM.PairOptions(0, True, True, 2.0, 1e-8, False)
    g_mi, g_cd = t(b, n, m), t(b, n, c)
    m_w, cd_w = PM.fused_knn_messages_plain(coors, proj_i, proj_j, idx, pv, weights, opts)
    d_c, d_pi, d_pj, d_w = PM.fused_knn_messages_backward_plain(
        coors, proj_i, proj_j, idx, pv, weights, g_mi, g_cd, opts)
    R = n // g
    d_table, d_ci, d_pjs, d_ws = torch.zeros_like(coors), [], torch.zeros_like(proj_j), []
    for r in range(g):
        rows = slice(r * R, (r + 1) * R)
        args = (coors[:, rows], proj_i[:, rows], proj_j, idx[:, rows], pv[:, rows], weights)
        m_b, cd_b = PM.fused_knn_messages_plain(*args, opts, coors_j=coors)
        torch.testing.assert_close(m_b, m_w[:, rows], rtol=0, atol=1e-12)
        torch.testing.assert_close(cd_b, cd_w[:, rows], rtol=0, atol=1e-12)
        bi, bpi, bpj, bw, bt = PM.fused_knn_messages_backward_plain(
            *args, g_mi[:, rows], g_cd[:, rows], opts, coors_j=coors)
        d_ci.append(bi)
        torch.testing.assert_close(bpi, d_pi[:, rows], rtol=0, atol=1e-12)
        d_table, d_pjs = d_table + bt, d_pjs + bpj
        d_ws.append(bw)
        # autograd of the block's forward against the hand-derived backward
        leaves = [a.clone().requires_grad_() for a in (args[0], args[1], proj_j, coors)]
        outs = PM.fused_knn_messages_plain(leaves[0], leaves[1], leaves[2], idx[:, rows],
                                           pv[:, rows], weights, opts, coors_j=leaves[3])
        ag = torch.autograd.grad(outs, leaves, (g_mi[:, rows], g_cd[:, rows]))
        for got, want in zip((bi, bpi, bpj, bt), ag):
            _close(got, want, 1e-10)
    whole_c = torch.cat(d_ci, dim=1) + d_table
    _close(whole_c, d_c, 1e-10)
    _close(d_pjs, d_pj, 1e-10)
    for got, want in zip(map(sum, zip(*d_ws)), d_w):
        _close(got, want, 1e-10)


# ---------------------------------------------------------------------------
# rank-side cases (no JAX here)
# ---------------------------------------------------------------------------

def _step(net, mesh, batch, steps):
    from egnn_tpu_torch import parallel, training

    opt = training.make_adam(net.parameters(), 1e-3)
    step = training.make_sharded_denoise_train_step(net, opt, mesh)
    tokens, noised, clean, adj, mask = (torch.from_numpy(a) for a in batch)

    def block(t):
        return parallel.dense_batch_block(mesh, t)

    losses = [step(block(tokens), block(noised), block(clean), adj, block(mask)).item()
              for _ in range(steps)]
    return losses, step


def _edges_case(mesh, p, kw=EDGES_KW):
    """The network with dense edges on the graph axis: each rank its block
    of nodes and its rows of the edges; the output rows and the gradients of
    sum(f^2) + sum(c^2) (the parameters', this rank's share; the inputs',
    this rank's rows)."""
    from egnn_tpu_torch import EGNNNetwork, parallel
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    net = EGNNNetwork(**kw, **F64)
    load_flax_params(net, p["params"])
    parallel.shard_nodes(net, mesh.get_group("graph"))
    feats, coors, edges, mask, adj = (torch.from_numpy(a) for a in p["inputs"])
    g = mesh.get_group("graph")
    n = feats.shape[1] // dist.get_world_size(g)
    rows = slice(dist.get_rank(g) * n, (dist.get_rank(g) + 1) * n)
    leaves = [feats[:, rows].clone().requires_grad_(), coors[:, rows].clone().requires_grad_(),
              edges[:, rows].clone().requires_grad_()]
    f, c = net(leaves[0], leaves[1], adj_mat=adj, edges=leaves[2], mask=mask[:, rows])
    ((f ** 2).sum() + (c ** 2).sum()).backward()
    return dict(f=_np(f), c=_np(c), input_grads=[_np(t.grad) for t in leaves],
                grads={k: _np(v.grad) for k, v in net.named_parameters()})


def _dropout_case(mesh, p, route):
    """A network of ``DROPOUT_ROUTES[route]`` in training mode, in one
    process on the whole batch and on the graph axis on this rank's block,
    each with a generator seeded alike: the outputs (the sharded call's
    rows) and the gradients of sum(f^2) + sum(c^2) (the parameters', the
    sharded call's share). The ring is held against the streamed layer at
    ``pairwise_chunk = n / g``, whose masks it draws."""
    from egnn_tpu_torch import EGNNNetwork, parallel
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    group = mesh.get_group("graph")
    tokens, coors, _, adj, mask = (torch.from_numpy(a) for a in p["batch"])
    n = tokens.shape[1]
    kw = DROPOUT_ROUTES[route]
    if route == "ring":
        kw = {**kw, "layer_kwargs": {**kw["layer_kwargs"], "stream_pairwise": True,
                                     "pairwise_chunk": n // dist.get_world_size(group)}}

    def run(sharded):
        net = EGNNNetwork(**kw, **F64)
        load_flax_params(net, p["params"][{"knn": "knn", "edges": "all_pairs_degrees",
                                           "ring": "all_pairs"}[route]])
        args = (tokens, coors, mask)
        if sharded:
            parallel.shard_nodes(net, group)
            args = tuple(parallel.dense_batch_block(mesh, t) for t in args)
        c0 = args[1].clone().requires_grad_()
        f, c = net(args[0], c0, adj_mat=adj, mask=args[2],
                   generator=torch.Generator().manual_seed(17))
        ((f ** 2).sum() + (c ** 2).sum()).backward()
        return dict(f=_np(f), c=_np(c), coors_grad=_np(c0.grad),
                    grads={k: _np(v.grad) for k, v in net.named_parameters()})

    return dict(sharded=run(True), one=run(False))


def graph_cases(rank, world, p):
    from egnn_tpu_torch import EGNNNetwork, parallel, training
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    out = {}
    for data, graph in MESHES[world]:
        mesh = parallel.make_mesh(data, graph, device="cpu")
        for name, kw in CONFIGS.items():
            net = EGNNNetwork(**kw, **F64)
            load_flax_params(net, p["params"][name])
            losses, step = _step(net, mesh, p["batch"], STEPS)
            out[(name, data, graph)] = dict(losses=losses, params=_named(net),
                                            steps=step.state.step)
        for flag, kw in FUSED.items():
            net = EGNNNetwork(**kw, **F64)
            load_flax_params(net, p["params"]["knn"])
            losses, _ = _step(net, mesh, p["batch"], STEPS)
            out[(flag, data, graph)] = dict(losses=losses, params=_named(net))
    if world == 2:
        # one process: each fused step on the whole batch
        batch = [torch.from_numpy(a) for a in p["batch"]]
        for flag, kw in FUSED.items():
            net = EGNNNetwork(**kw, **F64)
            load_flax_params(net, p["params"]["knn"])
            step = training.make_denoise_train_step(net, training.make_adam(net.parameters(),
                                                                            1e-3))
            out[(flag, "one_process")] = dict(losses=[step(*batch).item() for _ in range(STEPS)],
                                              params=_named(net))
        mesh = parallel.make_mesh(1, 2, device="cpu")
        out["edges"] = _edges_case(mesh, p["edges"])
        out["edges_all_pairs"] = _edges_case(mesh, p["edges_all_pairs"], EDGES_ALL_PAIRS_KW)
    mesh = parallel.make_mesh(1, world, device="cpu")
    for route in DROPOUT_ROUTES:
        out[("dropout", route)] = _dropout_case(mesh, p, route)
    return out


# ---------------------------------------------------------------------------
# the JAX side and the spawns
# ---------------------------------------------------------------------------

def _jax_params(kw, batch):
    import jax
    import jax.numpy as jnp

    import egnn_tpu

    jnet = egnn_tpu.EGNNNetwork(**kw)
    tokens, noised, _, adj, mask = (jnp.asarray(a) for a in batch)
    params = jnet.init(jax.random.PRNGKey(0), tokens, noised, adj_mat=adj, mask=mask)["params"]
    return jnet, jax.tree_util.tree_map(np.asarray, params)


def _jax_steps(jnet, params_np, batch, data, graph):
    """JAX's sharded step on a (data, graph) mesh of virtual devices, from a
    fresh state (the step donates it)."""
    import jax
    import jax.numpy as jnp

    from egnn_tpu import training as jtrain
    from egnn_tpu.parallel import make_mesh

    from test_torch_parallel import _flat

    mesh = make_mesh(data=data, graph=graph, devices=jax.devices()[:data * graph])
    step = jtrain.make_sharded_denoise_train_step(jnet, mesh)
    state = jtrain.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params_np),
                                     jtrain.make_adam(1e-3))
    args = [jnp.asarray(a) for a in batch]
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, *args)
        losses.append(float(loss))
    return losses, _flat(jax.tree_util.tree_map(np.asarray, state.params))


def _jax_edges(params_np, inputs, kw=EDGES_KW):
    """The JAX network with dense edges on the whole input: outputs, the
    gradients of sum(f^2) + sum(c^2) wrt the parameters and the inputs."""
    import jax
    import jax.numpy as jnp

    import egnn_tpu

    from test_torch_parallel import _flat

    jnet = egnn_tpu.EGNNNetwork(**kw)
    feats, coors, edges, mask, adj = (jnp.asarray(a) for a in inputs)

    def loss(prm, f0, c0, e0):
        f, c = jnet.apply({"params": prm}, f0, c0, adj_mat=adj, edges=e0, mask=mask)
        return (f ** 2).sum() + (c ** 2).sum(), (f, c)

    (_, (f, c)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params_np), feats, coors, edges)
    return dict(f=np.asarray(f), c=np.asarray(c), input_grads=[np.asarray(g) for g in grads[1:]],
                grads=_flat(jax.tree_util.tree_map(np.asarray, grads[0])))


def _edges_payload(kw=EDGES_KW, seed=12):
    import jax
    import jax.numpy as jnp

    import egnn_tpu

    rng = np.random.RandomState(seed)
    b, n = 2, 16
    inputs = (rng.randn(b, n, 8), np.cumsum(rng.randn(b, n, 3), axis=1), rng.randn(b, n, n, 2),
              rng.rand(b, n) > 0.2, np.abs(np.arange(n)[:, None] - np.arange(n)[None]) == 1)
    params = egnn_tpu.EGNNNetwork(**kw).init(
        jax.random.PRNGKey(3), *map(jnp.asarray, inputs[:2]), adj_mat=jnp.asarray(inputs[4]),
        edges=jnp.asarray(inputs[2]), mask=jnp.asarray(inputs[3]))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return dict(params=params, inputs=inputs), _jax_edges(params, inputs, kw)


@pytest.fixture(scope="module")
def graph_runs(tmp_path_factory):
    batch = _dense_batch()
    jnets, params = {}, {}
    for name, kw in CONFIGS.items():
        jnets[name], params[name] = _jax_params(kw, batch)
    refs = {(name, d, g): _jax_steps(jnets[name], params[name], batch, d, g)
            for name in CONFIGS for world in MESHES for d, g in MESHES[world]}
    edges_payload, edges_ref = _edges_payload()
    all_pairs_payload, all_pairs_ref = _edges_payload(EDGES_ALL_PAIRS_KW, 13)
    payload = dict(params=params, batch=batch, edges=edges_payload,
                   edges_all_pairs=all_pairs_payload)
    tmp = tmp_path_factory.mktemp("graph")
    ranks = {world: run_ranks(graph_cases, world, tmp, payload) for world in MESHES}
    return dict(refs=refs, ranks=ranks, edges_ref=edges_ref, all_pairs_ref=all_pairs_ref)


STEP_CASES = [(name, d, g) for name in CONFIGS for w in MESHES for d, g in MESHES[w]]


def _ranks_of(graph_runs, d, g):
    return graph_runs["ranks"][d * g]


@pytest.mark.parametrize("name,d,g", STEP_CASES)
def test_graph_step_loss_matches_jax(graph_runs, name, d, g):
    want, _ = graph_runs["refs"][(name, d, g)]
    for res in _ranks_of(graph_runs, d, g):
        np.testing.assert_allclose(res[(name, d, g)]["losses"], want, rtol=1e-10, atol=0)
        assert res[(name, d, g)]["steps"] == STEPS


@pytest.mark.parametrize("name,d,g", STEP_CASES)
def test_graph_step_params_match_jax(graph_runs, name, d, g):
    _, want = graph_runs["refs"][(name, d, g)]
    params = _ranks_of(graph_runs, d, g)[0][(name, d, g)]["params"]
    assert sorted(params) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(params[key], value, rtol=1e-8, atol=1e-10, err_msg=key)


@pytest.mark.parametrize("name,d,g", STEP_CASES)
def test_graph_step_ranks_bitwise_equal(graph_runs, name, d, g):
    ranks = [r[(name, d, g)] for r in _ranks_of(graph_runs, d, g)]
    for res in ranks[1:]:
        assert res["losses"] == ranks[0]["losses"]
        for key in ranks[0]["params"]:
            np.testing.assert_array_equal(res["params"][key], ranks[0]["params"][key],
                                          err_msg=key)


@pytest.mark.parametrize("d,g", [m for w in MESHES for m in MESHES[w]])
@pytest.mark.parametrize("flag", list(FUSED))
def test_graph_step_fused_matches_one_process_and_jax(graph_runs, flag, d, g):
    """``fused_pairs`` (K10's plain version on the rank's rows) and
    ``fused_knn`` (K11's, with the gathered cloud as its j table) against
    the port's one-process fused step on the whole batch and JAX's unfused
    sharded step on the same mesh."""
    one = graph_runs["ranks"][2][0][(flag, "one_process")]
    jlosses, jparams = graph_runs["refs"][("knn", d, g)]
    for res in _ranks_of(graph_runs, d, g):
        got = res[(flag, d, g)]
        _close(got["losses"], one["losses"], name="one-process losses")
        _close(got["losses"], jlosses, name="jax losses")
        for key, value in jparams.items():
            _close(got["params"][key], one["params"][key], name=f"one-process {key}")
            _close(got["params"][key], value, name=f"jax {key}")


def _edges_match(ref, ranks):
    for field in ("f", "c"):
        _close(np.concatenate([r[field] for r in ranks], axis=1), ref[field], name=field)
    for i, want in enumerate(ref["input_grads"]):
        _close(np.concatenate([r["input_grads"][i] for r in ranks], axis=1), want,
               name=f"input gradient {i}")
    assert sorted(ranks[0]["grads"]) == sorted(ref["grads"])
    for key, want in ref["grads"].items():
        _close(sum(r["grads"][key] for r in ranks), want, name=key)


def test_graph_axis_dense_edges_match_jax(graph_runs):
    """The network with dense edges (each rank its rows' block of them):
    outputs, the inputs' gradients (this rank's rows) and the parameters'
    (summed over the ranks) against the JAX network on the whole input."""
    _edges_match(graph_runs["edges_ref"], [r["edges"] for r in graph_runs["ranks"][2]])


def test_graph_axis_all_pairs_dense_edges_match_jax(graph_runs):
    """An all-pairs network with dense edges: each rank's rows against the
    gathered cloud (the materialised route), outputs and every gradient
    against the JAX network on the whole input."""
    _edges_match(graph_runs["all_pairs_ref"],
                 [r["edges_all_pairs"] for r in graph_runs["ranks"][2]])


def test_sparse_neighbors_k_agrees_with_jax():
    """The ``sparse_neighbors`` config's num_nearest_neighbors (JAX's k under
    jit) is the port's k, the expanded adjacency's largest row degree."""
    from egnn_tpu_torch.ops import neighbors as tnb

    adj = torch.from_numpy(_dense_batch()[3])[None]
    expanded, _ = tnb.expand_adjacency_degrees(adj, CONFIGS["sparse_neighbors"]["num_adj_degrees"])
    assert tnb.max_degree(expanded) == SPARSE_NEIGHBORS_K == \
        CONFIGS["sparse_neighbors"]["layer_kwargs"]["num_nearest_neighbors"]


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("route", list(DROPOUT_ROUTES))
def test_graph_axis_dropout_matches_one_process(graph_runs, route, world):
    """Dropout in training mode on the graph axis (g = world): every rank
    draws the whole tensor's masks and keeps its rows, so that the output
    rows and the gradients (the parameters' summed over the ranks, the
    coordinates' rows) equal the one-process network's with the same
    generator state, at 1e-9 of the largest value."""
    ranks = [r[("dropout", route)] for r in graph_runs["ranks"][world]]
    one = ranks[0]["one"]
    for res in ranks[1:]:
        for field in ("f", "c"):
            np.testing.assert_array_equal(res["one"][field], one[field])
    for field in ("f", "c", "coors_grad"):
        _close(np.concatenate([r["sharded"][field] for r in ranks], axis=1), one[field],
               name=field)
    assert sorted(ranks[0]["sharded"]["grads"]) == sorted(one["grads"])
    for key, want in one["grads"].items():
        _close(sum(r["sharded"]["grads"][key] for r in ranks), want, name=key)
