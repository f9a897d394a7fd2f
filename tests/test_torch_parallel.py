"""The port's multi-process runtime (``egnn_tpu_torch/parallel``) and its
data-parallel dense step on the CPU, ranks as processes under gloo.

Ranks run in spawned processes (``run_ranks``), each process several cases,
their results sent back as numpy arrays; every wait has a timeout, so a hung
rank fails its test. The rank-side functions live here, in a module that
imports no JAX at its top (a spawned process imports it), and
``test_torch_sparse_partition.py`` uses them too; the tests that compare
with ``egnn_tpu`` import it inside. Process groups meet in a file under
``tmp_path`` (``init_method="file://..."``), so that parallel test workers
never share a port. Everything is float64 with explicit dtypes.

Held here: the collectives' forwards and backwards; ``make_sharded_denoise
_train_step`` at 2 ranks against ``egnn_tpu``'s on a (data=2, graph=1)
mesh (loss and parameters, with masks whose counts differ between the
ranks' halves), the ranks' parameters and optimizer state bitwise equal,
and at 1 rank bitwise equal to ``make_denoise_train_step``; the step on a
(data=1, graph=2) mesh (``test_torch_graph_axis.py`` holds that axis in
full); ``MetricLogger``, ``initialize``,
``is_coordinator``, ``log0`` as ``tests/test_utils_subsystems.py`` holds
the JAX ones; ``PrefetchLoader(shard=...)``; and the two examples,
``migrate_from_torch`` (on a stand-in with the reference's layout) and
``export_serving`` (at n = 64), and the denoise trainer's ``--metrics``.
"""
from __future__ import annotations

import json
import pickle
import queue as queues
import time
import traceback
from collections import namedtuple

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

F64 = dict(device="cpu", dtype=torch.float64)
RANK_TIMEOUT = 150   # seconds for every rank of a spawn to report


# ---------------------------------------------------------------------------
# running ranks
# ---------------------------------------------------------------------------

def _rank_entry(fn, rank, world, init_method, payload_path, queue):
    try:
        torch.set_num_threads(1)
        from egnn_tpu_torch import parallel

        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        parallel.initialize(init_method=init_method, world_size=world, rank=rank, device="cpu")
        queue.put((rank, True, fn(rank, world, payload)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, payload):
    """``fn(rank, world, payload)`` in ``world`` spawned processes joined in
    one gloo group; returns the results by rank. A rank that raises fails
    the call with its traceback, and one that does not report within
    ``RANK_TIMEOUT`` seconds fails it too; every process is gone on
    return. The payload goes through a file: passed as an argument, a large
    one would hold ``start()`` until each child had booted and read it."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    stem = tmp_path / f"pg_{fn.__name__}_{time.monotonic_ns()}"
    init = f"file://{stem}"
    payload_path = f"{stem}.payload"
    with open(payload_path, "wb") as f:
        pickle.dump(payload, f)
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, init, payload_path, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.monotonic() + RANK_TIMEOUT
        while len(results) < world:
            try:
                rank, ok, value = queue.get(timeout=max(0.1, deadline - time.monotonic()))
            except queues.Empty as e:
                raise AssertionError(f"ranks {sorted(set(range(world)) - set(results))} did "
                                     f"not report within {RANK_TIMEOUT} s") from e
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


def _np(t):
    return t.detach().cpu().numpy()


def _named(module):
    return {name: _np(p) for name, p in module.named_parameters()}


def _optimizer_state(opt):
    return np.concatenate([_np(v).reshape(-1) for st in opt.state.values()
                           for v in st.values() if isinstance(v, torch.Tensor)])


# ---------------------------------------------------------------------------
# rank-side cases (no JAX here)
# ---------------------------------------------------------------------------

def collective_cases(rank, world, payload):
    from egnn_tpu_torch.parallel.collectives import (all_gather_rows, all_reduce_max,
                                                     all_reduce_sum)

    group = dist.group.WORLD
    x = (torch.arange(6, dtype=torch.float64).reshape(3, 2) + 10 * rank).requires_grad_()
    gathered = all_gather_rows(x, group)
    w = torch.arange(gathered.numel(), dtype=torch.float64).reshape(gathered.shape) * (rank + 1)
    (gathered * w).sum().backward()
    y = torch.full((4,), float(rank + 1), dtype=torch.float64, requires_grad=True)
    summed = all_reduce_sum(y * (rank + 2), group)
    (summed * (rank + 1)).sum().backward()
    m = all_reduce_max(torch.tensor([float(rank), -float(rank), -np.inf], dtype=torch.float64),
                       group)
    return dict(gathered=_np(gathered), x_grad=_np(x.grad), summed=_np(summed),
                y_grad=_np(y.grad), max=_np(m), max_requires_grad=m.requires_grad)


def dense_dp_cases(rank, world, p):
    """``make_sharded_denoise_train_step`` on a (world, 1) mesh, each rank on
    its block of the batch; also on a (1, world) mesh, the nodes sharded
    over the graph axis, from the same weights."""
    from egnn_tpu_torch import EGNNNetwork, parallel, training
    from egnn_tpu_torch.utils import finite_or_skip_step
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    mesh = parallel.make_mesh(world, 1, device="cpu")
    net = EGNNNetwork(**p["net_kw"], **F64)
    load_flax_params(net, p["params"])
    opt = training.make_adam(net.parameters(), 1e-3)
    step = finite_or_skip_step(training.make_sharded_denoise_train_step(net, opt, mesh))
    tokens, noised, clean, adj, mask = (torch.from_numpy(a) for a in p["batch"])

    def block(t):
        return parallel.dense_batch_block(mesh, t)

    losses = [step(block(tokens), block(noised), block(clean), adj, block(mask)).item()
              for _ in range(p["steps"])]
    graph_mesh = parallel.make_mesh(1, world, device="cpu")
    graph_net = EGNNNetwork(**p["net_kw"], **F64)
    load_flax_params(graph_net, p["params"])
    graph_step = training.make_sharded_denoise_train_step(
        graph_net, training.make_adam(graph_net.parameters(), 1e-3), graph_mesh)
    graph_losses = [graph_step(*(parallel.dense_batch_block(graph_mesh, t)
                                 for t in (tokens, noised, clean)), adj,
                               parallel.dense_batch_block(graph_mesh, mask)).item()
                    for _ in range(p["steps"])]
    return dict(losses=losses, params=_named(net), opt_state=_optimizer_state(opt),
                steps=step.state.step, graph_losses=graph_losses,
                graph_params=_named(graph_net))


Batch = namedtuple("Batch", "tokens coors adj_mat")


def loader_cases(rank, world, p):
    """``PrefetchLoader(shard=...)`` with a mesh and with a process group:
    the blocks each rank receives."""
    from egnn_tpu_torch import parallel
    from egnn_tpu_torch.training import PrefetchLoader

    def batches():
        rng = np.random.RandomState(p["seed"])
        return lambda: Batch(rng.randint(0, 9, (4, 6)), rng.randn(4, 6, 3), rng.rand(6, 6) > 0.5)

    out = {}
    for name, shard in (("mesh", parallel.make_mesh(world, 1, device="cpu")),
                        ("group", dist.group.WORLD)):
        loader = PrefetchLoader(batches(), depth=2, num_batches=2, device="cpu", shard=shard)
        out[name] = [tuple(_np(t) for t in b) for b in loader]
        loader.close()
    return out


def sparse_cases(rank, world, p):
    """The sharded sparse modules on each rank's block of the inputs: for
    each case the output and the gradients of <output, cot> (the
    parameters', this rank's share; x's, this rank's rows), or for a
    ``step`` case the loss and parameters after ``make_partitioned_sparse_
    train_step``."""
    from egnn_tpu_torch import EGNNSparse, EGNNSparseNetwork, parallel, training
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    mesh = parallel.make_mesh(1, world, device="cpu")
    group = mesh.get_group("graph")
    out = {}
    for name, case in p.items():
        g = case["inputs"]
        n = g["x"].shape[0]
        snd, rcv = (torch.from_numpy(a) for a in g["edge_index"])
        attr = None if g.get("edge_attr") is None else torch.from_numpy(g["edge_attr"])
        emask = torch.from_numpy(g["edge_mask"])
        if case.get("uniform"):
            pe = parallel.partition_uniform_edges(snd, n, world, case["uniform"],
                                                  edge_attr=attr, edge_mask=emask)
        else:
            pe = parallel.partition_edges(snd, rcv, n, world, edge_attr=attr, edge_mask=emask)

        def block(a):
            return None if a is None else parallel.sparse_node_block(
                mesh, a if isinstance(a, torch.Tensor) else torch.from_numpy(a))

        cls = EGNNSparseNetwork if case["kind"] != "layer" else EGNNSparse
        module = cls(**case["kw"], shard_axis=group, **F64)
        load_flax_params(module, case["params"])
        kwargs = dict(edge_attr=block(pe.edge_attr), batch=block(g["batch"]),
                      edge_mask=block(pe.mask), num_graphs=g["num_graphs"],
                      node_mask=block(g.get("node_mask")))
        if case["kind"] == "step":
            step = training.make_partitioned_sparse_train_step(
                module, training.make_adam(module.parameters(), 1e-3), mesh, g["num_graphs"])
            loss = step(block(g["x"]), block(pe.senders), block(pe.receivers), kwargs["edge_mask"],
                        kwargs["edge_attr"], kwargs["batch"], block(case["clean"]),
                        kwargs["node_mask"])
            out[name] = dict(loss=loss.item(), params=_named(module))
            continue
        x = block(g["x"]).clone().requires_grad_()
        y = module(x, torch.stack([block(pe.senders), block(pe.receivers)]), **kwargs)
        (y * block(case["cot"])).sum().backward()
        out[name] = dict(out=_np(y), x_grad=_np(x.grad),
                         grads={k: _np(v.grad) for k, v in module.named_parameters()
                                if v.grad is not None})
    return out


def two_rank_cases(rank, world, p):
    """This file's cases on two ranks, in one spawn."""
    return dict(collectives=collective_cases(rank, world, None),
                loader=loader_cases(rank, world, p["loader"]),
                dense=dense_dp_cases(rank, world, p["dense"]))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collectives(two_ranks):
    return [r["collectives"] for r in two_ranks]


def test_all_gather_rows_forward_and_backward(collectives):
    x = [np.arange(6.0).reshape(3, 2) + 10 * r for r in range(2)]
    w = [np.arange(12.0).reshape(6, 2) * (r + 1) for r in range(2)]
    for r, res in enumerate(collectives):
        np.testing.assert_array_equal(res["gathered"], np.concatenate(x))
        # the cotangents of both ranks summed, this rank's block kept
        np.testing.assert_array_equal(res["x_grad"], (w[0] + w[1])[3 * r:3 * (r + 1)])


def test_all_reduce_sum_forward_and_backward(collectives):
    for res in collectives:
        np.testing.assert_array_equal(res["summed"], np.full(4, 1.0 * 2 + 2.0 * 3))
    # d/dy_r of sum_q (summed * (q + 1)) = (rank + 2) * sum_q (q + 1)
    for r, res in enumerate(collectives):
        np.testing.assert_array_equal(res["y_grad"], np.full(4, (r + 2) * 3.0))


def test_all_reduce_max_carries_no_gradient(collectives):
    for res in collectives:
        np.testing.assert_array_equal(res["max"], [1.0, 0.0, -np.inf])
        assert not res["max_requires_grad"]


DENSE_KW = dict(depth=2, dim=8, num_tokens=21, num_positions=16,
                layer_kwargs=dict(num_nearest_neighbors=4, norm_coors=True,
                                  coor_weights_clamp_value=2.0, init_eps=0.1))
DENSE_STEPS = 2


def _dense_batch(b=4, n=16):
    """tokens, noised, clean, adj, mask: the mask counts differ between the
    two ranks' halves of the batch (16 + 14 against 9 + 12 valid nodes)."""
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, 21, size=(b, n))
    clean = np.cumsum(rng.randn(b, n, 3), axis=1)
    noised = clean + rng.randn(b, n, 3)
    mask = np.arange(n)[None, :] < np.array([[16], [14], [9], [12]])
    adj = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1
    return tokens, noised, clean, adj, mask


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The JAX sharded step on a (data=2, graph=1) mesh of two devices, and
    one spawn of two ranks for the collectives, the loader and the port's
    sharded step from the same weights on the same batch."""
    import jax
    import jax.numpy as jnp

    import egnn_tpu
    from egnn_tpu import training as jtrain
    from egnn_tpu.parallel import make_mesh

    batch = _dense_batch()
    jnet = egnn_tpu.EGNNNetwork(**DENSE_KW)
    jargs = tuple(jnp.asarray(a) for a in batch)
    params = jnet.init(jax.random.PRNGKey(0), jargs[0], jargs[1], adj_mat=jargs[3],
                       mask=jargs[4])["params"]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    mesh = make_mesh(data=2, graph=1, devices=jax.devices()[:2])
    jstep = jtrain.make_sharded_denoise_train_step(jnet, mesh)
    state = jtrain.TrainState.create(params, jtrain.make_adam(1e-3))
    jlosses = []
    for _ in range(DENSE_STEPS):
        state, loss = jstep(state, jargs[0], jargs[1], jargs[2], jargs[3], jargs[4])
        jlosses.append(float(loss))
    ranks = run_ranks(two_rank_cases, 2, tmp_path_factory.mktemp("ranks"), dict(
        loader=dict(seed=3),
        dense=dict(net_kw=DENSE_KW, params=params_np, batch=batch, steps=DENSE_STEPS)))
    for r in ranks:
        r["jlosses"] = jlosses
        r["jparams"] = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    return ranks


@pytest.fixture(scope="module")
def dense_dp(two_ranks):
    return dict(jlosses=two_ranks[0]["jlosses"], jparams=two_ranks[0]["jparams"],
                ranks=[r["dense"] for r in two_ranks])


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def test_sharded_denoise_step_loss_matches_jax(dense_dp):
    for res in dense_dp["ranks"]:
        np.testing.assert_allclose(res["losses"], dense_dp["jlosses"], rtol=1e-10, atol=0)
        assert res["steps"] == DENSE_STEPS


def test_sharded_denoise_step_params_match_jax(dense_dp):
    params = dense_dp["ranks"][0]["params"]
    assert sorted(params) == sorted(dense_dp["jparams"])
    for name, value in dense_dp["jparams"].items():
        np.testing.assert_allclose(params[name], value, rtol=1e-8, atol=1e-10, err_msg=name)


def test_sharded_denoise_step_ranks_bitwise_equal(dense_dp):
    r0, r1 = dense_dp["ranks"]
    assert r0["losses"] == r1["losses"]
    for name in r0["params"]:
        np.testing.assert_array_equal(r0["params"][name], r1["params"][name], err_msg=name)
    np.testing.assert_array_equal(r0["opt_state"], r1["opt_state"])


def test_sharded_denoise_step_refuses_a_graph_axis(dense_dp):
    """A graph axis was refused until the node-sharded kNN route was ported;
    now the step on a (data=1, graph=2) mesh runs and gives the losses and
    parameters of JAX's data-parallel step (the same function)."""
    for res in dense_dp["ranks"]:
        np.testing.assert_allclose(res["graph_losses"], dense_dp["jlosses"], rtol=1e-10, atol=0)
        for name, value in dense_dp["jparams"].items():
            np.testing.assert_allclose(res["graph_params"][name], value, rtol=1e-8, atol=1e-10,
                                       err_msg=name)


@pytest.fixture
def one_rank_group(tmp_path):
    from egnn_tpu_torch import parallel

    parallel.initialize(init_method=f"file://{tmp_path / 'pg1'}", world_size=1, rank=0,
                        device="cpu")
    yield parallel.make_mesh(1, 1, device="cpu")
    dist.destroy_process_group()


def test_sharded_denoise_step_one_rank_bitwise_equals_the_plain_step(one_rank_group):
    from egnn_tpu_torch import EGNNNetwork, training

    batch = tuple(torch.from_numpy(a) for a in _dense_batch())
    nets = [EGNNNetwork(**DENSE_KW, **F64, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    plain = training.make_denoise_train_step(
        nets[0], training.make_fused_adam(nets[0].parameters(), 1e-3))
    sharded = training.make_sharded_denoise_train_step(
        nets[1], training.make_fused_adam(nets[1].parameters(), 1e-3), one_rank_group)
    for _ in range(3):
        a, b = plain(*batch), sharded(*batch)
        assert torch.equal(a, b)
    for (name, p), q in zip(nets[0].named_parameters(), nets[1].parameters()):
        assert torch.equal(p, q), name


def test_partitioned_step_one_rank_matches_an_unsharded_step(one_rank_group):
    """S = 1: the sharded network (an all-gather of one block, the graph
    LayerNorm's and the attention's sums through a one-rank group) and its
    step against the unsharded network under the same objective: the losses
    bitwise (the forward's ops are the same), the parameters at 1e-12. The
    collectives' backward nodes change the order in which autograd adds the
    gradients that meet at a tensor, so the gradients differ in their last
    bits."""
    from egnn_tpu_torch import EGNNSparseNetwork, parallel, training
    from egnn_tpu_torch.ops.graph import knn_graph

    rng = np.random.RandomState(8)
    n, d = 24, 5
    x = torch.from_numpy(np.concatenate([rng.randn(n, 3), rng.randn(n, d)], axis=1))
    es = knn_graph(x[:, :3], 4, graph_size=12)
    batch = torch.arange(2).repeat_interleave(12)
    node_mask = torch.from_numpy(rng.rand(n) > 0.2)
    clean = x[:, :3] + 0.1
    kw = dict(n_layers=2, feats_dim=d, fourier_features=2, norm_feats=True, norm_coors=True,
              global_linear_attn_every=1, global_linear_attn_heads=2,
              global_linear_attn_dim_head=4, num_global_tokens=2)
    group = one_rank_group.get_group("graph")
    nets = [EGNNSparseNetwork(**kw, shard_axis=axis, **F64,
                              generator=torch.Generator().manual_seed(4)) for axis in (None, group)]
    opts = [training.make_adam(net.parameters(), 1e-3) for net in nets]
    step = training.make_partitioned_sparse_train_step(nets[1], opts[1], one_rank_group, 2)
    pe = parallel.partition_edges(es.senders, es.receivers, n, 1, edge_mask=es.mask)
    for _ in range(2):
        opts[0].zero_grad()
        out = nets[0](x, es.edge_index, batch=batch, edge_mask=es.mask, num_graphs=2,
                      node_mask=node_mask)
        err = (out[:, :3] - clean) ** 2 * node_mask[:, None].to(out.dtype)
        loss = err.sum() / (node_mask.sum().to(err.dtype) * 3).clamp(min=1.0)
        loss.backward()
        opts[0].step()
        loss_s = step(x, pe.senders, pe.receivers, pe.mask, None, batch, clean, node_mask)
        assert torch.equal(loss.detach(), loss_s)
    for (name, p), q in zip(nets[0].named_parameters(), nets[1].parameters()):
        np.testing.assert_allclose(_np(q), _np(p), rtol=0, atol=1e-12, err_msg=name)


def test_initialize_and_coordinator_without_a_group(tmp_path, monkeypatch, capsys):
    """``tests/test_utils_subsystems.py::test_metric_logger``'s runtime half:
    with nothing configured ``initialize`` does nothing, this process is the
    coordinator and ``log0`` prints."""
    from egnn_tpu_torch import parallel

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.initialize(device="cpu") is None
    assert not dist.is_initialized()
    assert parallel.is_coordinator()
    parallel.log0("coordinator log line works")
    assert "coordinator log line works" in capsys.readouterr().out
    parallel.sync_global_devices()     # no group: nothing to wait for


def test_initialize_is_idempotent(one_rank_group, tmp_path):
    from egnn_tpu_torch import parallel

    group = dist.group.WORLD
    assert parallel.initialize(init_method=f"file://{tmp_path / 'other'}", world_size=1,
                               rank=0, device="cpu") == torch.device("cpu")
    assert dist.group.WORLD is group and parallel.is_coordinator()
    parallel.sync_global_devices()


def test_metric_logger(tmp_path):
    """``tests/test_utils_subsystems.py::test_metric_logger``: host scalars
    written at once, tensor records buffered and read in one batch."""
    from egnn_tpu_torch.parallel import MetricLogger

    path = tmp_path / "metrics.jsonl"
    ml = MetricLogger(str(path))
    ml.log(0, loss=1.5, edges_per_s=1e6)
    ml.log(1, loss=torch.tensor(0.5))
    assert len(ml._pending) == 1
    assert len(path.read_text().splitlines()) == 1
    ml.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0]["loss"] == 1.5 and recs[1]["step"] == 1
    assert recs[1]["loss"] == 0.5


def test_metric_logger_flushes_every_so_many_records(tmp_path):
    from egnn_tpu_torch.parallel import MetricLogger

    path = tmp_path / "m.jsonl"
    ml = MetricLogger(str(path), flush_every=3)
    for i in range(7):
        ml.log(i, loss=torch.tensor(float(i), dtype=torch.float32), lr=1e-3)
    assert len(path.read_text().splitlines()) == 6 and len(ml._pending) == 1
    ml.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["loss"] for r in recs] == [float(i) for i in range(7)]
    assert all(r["lr"] == 1e-3 for r in recs)


def test_metric_logger_writes_on_the_coordinator_only(tmp_path, monkeypatch):
    from egnn_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "is_coordinator", lambda: False)
    ml = distributed.MetricLogger(str(tmp_path / "m.jsonl"))
    ml.log(0, loss=1.0)
    ml.close()
    assert not (tmp_path / "m.jsonl").exists()


@pytest.fixture(scope="module")
def loader_blocks(two_ranks):
    return [r["loader"] for r in two_ranks]


@pytest.mark.parametrize("shard", ["mesh", "group"])
def test_prefetch_loader_delivers_each_ranks_block(loader_blocks, shard):
    rng = np.random.RandomState(3)
    whole = [(rng.randint(0, 9, (4, 6)), rng.randn(4, 6, 3), rng.rand(6, 6) > 0.5)
             for _ in range(2)]
    for r, res in enumerate(loader_blocks):
        got = res[shard]
        assert len(got) == 2
        for (tokens, coors, adj), (wt, wc, wa) in zip(got, whole):
            np.testing.assert_array_equal(tokens, wt[2 * r:2 * (r + 1)])
            # floats become float32, as to_tensors makes them
            np.testing.assert_array_equal(coors, wc[2 * r:2 * (r + 1)].astype(np.float32))
            np.testing.assert_array_equal(adj, wa)       # left whole


def test_dense_batch_and_sparse_node_blocks(one_rank_group):
    from egnn_tpu_torch import parallel
    from egnn_tpu_torch.parallel.mesh import rank_block_index

    t = torch.arange(24).reshape(2, 4, 3)
    assert torch.equal(parallel.dense_batch_block(one_rank_group, t), t)
    assert torch.equal(parallel.sparse_node_block(one_rank_group, t), t)
    assert rank_block_index(one_rank_group) == (0, 1)
    with pytest.raises(ValueError, match="process count"):
        parallel.make_mesh(2, 1, device="cpu")


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def test_migrate_from_torch_on_a_reference_standin(tmp_path):
    """The migration example on a stand-in with the reference's attribute
    layout (``test_torch_port_weights.py``'s), called as the reference is:
    its forward is ``egnn_tpu``'s network under the JAX package's own
    converter's tree, so the float64 check holds the port's converter and
    network against the JAX package's."""
    import jax
    import jax.numpy as jnp

    import egnn_tpu
    from egnn_tpu import utils as ju
    from egnn_tpu_torch.examples import migrate_from_torch as mig
    from test_torch_port_weights import _Fill, _network_standin

    cfg = mig.CONFIG
    standin = _network_standin(_Fill(11), mig.port_network(cfg, "cpu"))
    jnet = egnn_tpu.EGNNNetwork(
        depth=cfg["depth"], dim=cfg["dim"], num_tokens=cfg["num_tokens"],
        num_positions=cfg["num_positions"],
        layer_kwargs={k: cfg[k] for k in ("num_nearest_neighbors", "norm_coors",
                                          "coor_weights_clamp_value")})
    jparams = ju.egnn_network_params_from_torch(standin)

    class Reference:
        def __getattr__(self, name):
            return getattr(standin, name)

        def __call__(self, tokens, coors, mask=None):
            f, c = jnet.apply({"params": jparams}, jnp.asarray(tokens.numpy()),
                              jnp.asarray(coors.numpy()), mask=jnp.asarray(mask.numpy()))
            return torch.from_numpy(np.array(f)), torch.from_numpy(np.array(c))

    summary = mig.migrate(Reference(), cfg, str(tmp_path / "ckpt"), device="cpu")
    assert summary["err_feats"] < mig.TOL and summary["err_coors"] < mig.TOL
    assert (tmp_path / "ckpt" / "ckpt_000000000.pt").exists()
    assert jax.default_backend() == "cpu"


def test_migrate_from_torch_without_the_reference(capsys):
    from egnn_tpu_torch.examples import migrate_from_torch as mig

    assert mig.main(["--device", "cpu"]) is None
    assert "nothing to migrate" in capsys.readouterr().out


def test_export_serving_round_trip_on_the_cpu(tmp_path):
    from egnn_tpu_torch.examples import export_serving

    summary = export_serving.main(["--device", "cpu", "--nodes", "64",
                                   "--out", str(tmp_path / "fwd.pt2")])
    assert summary["bitwise"] and summary["op_calls"] == 3
    assert (tmp_path / "fwd.pt2").stat().st_size == summary["bytes"]


def test_export_serving_refuses_the_large_n_routes():
    from egnn_tpu_torch.examples import export_serving

    assert export_serving.exportable(4096)
    with pytest.raises(SystemExit, match="large-n selection route"):
        export_serving.main(["--device", "cpu", "--nodes", "20000"])


def test_denoise_trainer_writes_metrics(tmp_path):
    from egnn_tpu_torch.examples import denoise

    path = tmp_path / "m.jsonl"
    summary = denoise.main(["--device", "cpu", "--steps", "6", "--nodes", "48", "--depth", "1",
                            "--dim", "8", "--knn", "4", "--metrics", str(path)])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == list(range(6))
    np.testing.assert_array_equal([r["loss"] for r in recs], summary["losses"])
    assert all(np.isfinite(r["loss"]) and r["edges_per_s"] > 0 for r in recs)
