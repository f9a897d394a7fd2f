"""The trainers' blocks and what makes them capturable, on the CPU in float64
against ``egnn_tpu``:

- the train step's static k (F8): under ``make_denoise_train_step`` a layer
  with ``only_sparse_neighbors`` takes its given ``num_nearest_neighbors``,
  as the JAX package's jitted step does, while a direct call of the network
  keeps the adjacency's largest row degree, as JAX's eager call does; with
  ``num_nearest_neighbors=0`` both steps raise ``ValueError``;
- the finite-step guard and ``optax.MultiSteps`` on the device: the port's
  guarded step with ``make_adam(grad_accum=3)`` against
  ``egnn_tpu.utils.finite_or_skip_step`` over 7 micro-steps, through a NaN
  target on a window's last micro-step and a micro-step whose loss and
  gradients are finite but whose update is not (a learning rate of
  infinity, at a window's last micro-step and inside a window);
- the trainers' ``--block``: blocks of 3 against blocks of 1 and eager
  calls, bitwise (losses, final parameters and optimizer state), the denoise
  trainer also across a checkpoint inside an accumulation window and a run
  stopped there and resumed;
- ``--from-sidechainnet`` without the optional package: the port's trainer
  and the JAX example raise alike.

On the CPU ``capture_step`` runs the step as calls, so a block is a
grouping of calls and reads; the card replays a CUDA graph
(``chip_smoke.py`` phase 46).
"""
import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
from egnn_tpu import training as jtrain
from egnn_tpu import utils as ju
from egnn_tpu_torch import EGNNNetwork
from egnn_tpu_torch.examples import denoise
from egnn_tpu_torch.examples import molecule_regression as mr
from egnn_tpu_torch.training import capture_step, make_adam, make_denoise_train_step
from egnn_tpu_torch.utils import finite_or_skip_step
from egnn_tpu_torch.utils.port_weights import load_flax_params

F64 = dict(device="cpu", dtype=torch.float64)
ATOL = 1e-9
N = 32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (the suite runs several workers on the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    """A Flax tree by torch parameter name ("egnn_0.edge_mlp_0_w")."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _adam_state(tree):
    """optax's ScaleByAdamState, inside a chain or a MultiSteps state."""
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    if hasattr(tree, "inner_opt_state"):
        return _adam_state(tree.inner_opt_state)
    for child in (tree if isinstance(tree, tuple) else ()):
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def _assert_state(tnet, opt, jstate, atol=ATOL):
    """Parameters, Adam's moments and count, and (under MultiSteps) the
    accumulator and its counter against the JAX state."""
    names = dict(tnet.named_parameters())
    inner = _adam_state(jstate.opt_state)
    trees = [("param", jstate.params), ("m", inner.mu), ("v", inner.nu)]
    if hasattr(jstate.opt_state, "acc_grads"):
        trees.append(("acc", jstate.opt_state.acc_grads))
        assert opt.mini_step == int(jstate.opt_state.mini_step)
    for key, tree in trees:
        jflat = _flat(tree)
        assert sorted(jflat) == sorted(names)
        for name, value in jflat.items():
            p = names[name]
            got = p if key == "param" else opt.state[p][key]
            np.testing.assert_allclose(got.detach().numpy(), value, rtol=0, atol=atol,
                                       err_msg=f"{key} {name}")
    assert {int(opt.state[p]["count"]) for p in names.values()} == {int(inner.count)}


# ---------------------------------------------------------------------------
# F8: the train step's static k
# ---------------------------------------------------------------------------

def _anchor4_like(k):
    """Anchor 4's network cut to size: 3 adjacency degrees (the expanded
    chain's rows hold at most 5 nodes), ``only_sparse_neighbors`` with
    ``num_nearest_neighbors=k``, no mask; weights from JAX's init."""
    net_kw = dict(depth=2, dim=8, num_tokens=21, num_adj_degrees=3, adj_dim=4,
                  layer_kwargs=dict(only_sparse_neighbors=True, num_nearest_neighbors=k,
                                    init_eps=0.1))
    rng = np.random.RandomState(24)
    tokens = rng.randint(0, 21, size=(1, N))
    clean = np.cumsum(rng.randn(1, N, 3), axis=1)
    noised = clean + rng.randn(1, N, 3)
    adj = np.abs(np.arange(N)[:, None] - np.arange(N)[None, :]) == 1
    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(noised),
                       adj_mat=jnp.asarray(adj))["params"]
    tnet = EGNNNetwork(**net_kw, **F64)
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    return jnet, params, tnet, (tokens, noised, clean, adj)


def test_static_k_step_matches_the_jitted_jax_step():
    jnet, params, tnet, batch = _anchor4_like(7)
    jstate = jtrain.TrainState.create(params, jtrain.make_adam(1e-3))
    jstep = jtrain.make_denoise_train_step(jnet, donate=False)
    opt = make_adam(tnet.parameters(), 1e-3)
    tstep = make_denoise_train_step(tnet, opt)
    jargs = tuple(jnp.asarray(a) for a in batch) + (None,)
    targs = tuple(torch.from_numpy(a) for a in batch) + (None,)
    for _ in range(2):
        jstate, jloss = jstep(jstate, *jargs)
        tloss = tstep(*targs)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=0, atol=ATOL)
    _assert_state(tnet, opt, jstate)
    assert tstep.state.step == int(jstate.step) == 2


def test_direct_call_keeps_the_largest_row_degree():
    """Outside a step the port takes k = 5 (the expanded chain's largest row
    degree), as JAX's eager call on a concrete adjacency does; the jitted
    call (k = 7) differs."""
    jnet, params, tnet, (tokens, noised, _, adj) = _anchor4_like(7)
    jf, jc = jnet.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(noised),
                        adj_mat=jnp.asarray(adj))
    with torch.no_grad():
        tf, tc = tnet(torch.from_numpy(tokens), torch.from_numpy(noised),
                      adj_mat=torch.from_numpy(adj))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    _, jc_jit = jax.jit(lambda t, c, a: jnet.apply({"params": params}, t, c, adj_mat=a))(
        jnp.asarray(tokens), jnp.asarray(noised), jnp.asarray(adj))
    assert np.abs(np.asarray(jc_jit) - tc.numpy()).max() > 1e-6


def test_step_without_a_static_k_raises_as_jax():
    jnet, params, tnet, batch = _anchor4_like(0)
    jstate = jtrain.TrainState.create(params, jtrain.make_adam(1e-3))
    with pytest.raises(ValueError, match="static k"):
        jtrain.make_denoise_train_step(jnet, donate=False)(
            jstate, *(jnp.asarray(a) for a in batch), None)
    tstep = make_denoise_train_step(tnet, make_adam(tnet.parameters(), 1e-3))
    with pytest.raises(ValueError, match="static k"):
        tstep(*(torch.from_numpy(a) for a in batch), None)
    with torch.no_grad():   # a direct call still reads the degree
        tnet(*(torch.from_numpy(a) for a in batch[:2]), adj_mat=torch.from_numpy(batch[3]))


def test_pipelined_apply_takes_the_static_k(tmp_path):
    """``make_pipelined_apply`` (JAX: a jitted apply) at one stage on a
    one-rank group: the layers under ``static_k``, bitwise, and not their
    direct call (k = 3 on the chain against the given 6, no mask)."""
    import torch.distributed as dist

    from egnn_tpu_torch import EGNN, parallel
    from egnn_tpu_torch.ops.neighbors import static_k

    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.randn(2, 20, 8))
    coors = torch.from_numpy(rng.randn(2, 20, 3))
    adj = torch.from_numpy(np.abs(np.arange(20)[:, None] - np.arange(20)[None, :]) == 1)
    layers = [EGNN(dim=8, only_sparse_neighbors=True, num_nearest_neighbors=6, init_eps=0.1,
                   generator=torch.Generator().manual_seed(i), **F64) for i in range(2)]

    def sequential():
        f, c = feats, coors
        for layer in layers:
            f, c = layer(f, c, adj_mat=adj)
        return f, c

    parallel.initialize(init_method=f"file://{tmp_path / 'pg'}", world_size=1, rank=0,
                        device="cpu")
    try:
        group = dist.group.WORLD
        block = parallel.stage_block(parallel.to_stages(parallel.stack_layer_params(layers), 1),
                                     group)
        with torch.no_grad():
            f, c = parallel.make_pipelined_apply(layers[0], group, 1)(block, feats, coors,
                                                                     adj_mat=adj)
    finally:
        dist.destroy_process_group()
    with torch.no_grad():
        with static_k():
            f_static, c_static = sequential()
        _, c_direct = sequential()
    assert torch.equal(f, f_static) and torch.equal(c, c_static)
    assert not torch.allclose(c, c_direct)


# ---------------------------------------------------------------------------
# the device guard and MultiSteps
# ---------------------------------------------------------------------------

NAN_AT = 2                                   # the first window's last micro-step
INF_AT = {"window_end": 6, "inside_window": 4}


@pytest.mark.parametrize("where", sorted(INF_AT))
def test_device_guard_and_accumulation_match_jax(where):
    """Windows of 3 over 7 micro-steps: the NaN target and the step with a
    learning rate of infinity (finite loss and gradients, a new state that
    is not finite: ±inf, or NaN where the update is 0, and 0 * inf under
    MultiSteps' ``emit * update`` inside a window) are skipped on both
    sides, each rolling the window's counter back; the other losses, the
    parameters and the whole optimizer state agree at 1e-9."""
    n = 16
    net_kw = dict(depth=1, dim=8, num_tokens=21, num_positions=n,
                  layer_kwargs=dict(num_nearest_neighbors=4, norm_coors=True, init_eps=0.1))
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, 21, size=(1, n))
    clean = np.cumsum(rng.randn(1, n, 3), axis=1)
    mask = np.ones((1, n), bool)
    batches = []
    for i in range(7):
        target = clean.copy()
        if i == NAN_AT:
            target[0, 0, 0] = math.nan
        batches.append((tokens, clean + rng.randn(1, n, 3), target, None, mask))

    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(tokens), jnp.asarray(clean),
                       mask=jnp.asarray(mask))["params"]
    tx, tx_inf = jtrain.make_adam(1e-2, grad_accum=3), jtrain.make_adam(math.inf, grad_accum=3)
    jstate = jtrain.TrainState.create(params, tx)
    jstep = ju.finite_or_skip_step(jtrain.make_denoise_train_step(jnet, donate=False))

    tnet = EGNNNetwork(**net_kw, **F64)
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    opt = make_adam(tnet.parameters(), 1e-2, grad_accum=3)
    tstep = finite_or_skip_step(make_denoise_train_step(tnet, opt))
    skipped = {NAN_AT, INF_AT[where]}
    for i, batch in enumerate(batches):
        inf = i == INF_AT[where]
        jstate = jstate.replace(tx=tx_inf if inf else tx)
        opt.param_groups[0]["lr"] = math.inf if inf else 1e-2
        jstate, jloss = jstep(jstate, *(None if a is None else jnp.asarray(a) for a in batch))
        tloss = tstep(*(None if a is None else torch.from_numpy(a) for a in batch))
        assert math.isnan(float(jloss)) == math.isnan(float(tloss)) == (i in skipped), i
        if i not in skipped:
            np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=0, atol=ATOL)
    assert tstep.state.step == int(jstate.step) == 7 - len(skipped)
    _assert_state(tnet, opt, jstate)


def test_guard_rolls_back_a_finite_step_whose_update_overflows():
    """A learning rate of infinity at a window's end: the state, the
    counters included, bitwise as before; a later finite step moves it."""
    net = EGNNNetwork(depth=1, dim=8, num_tokens=21, layer_kwargs=dict(num_nearest_neighbors=4),
                      **F64)
    opt = make_adam(net.parameters(), math.inf)
    step = finite_or_skip_step(make_denoise_train_step(net, opt))
    rng = np.random.RandomState(3)
    batch = (torch.from_numpy(rng.randint(0, 21, size=(1, 12))),
             torch.from_numpy(rng.randn(1, 12, 3)), torch.from_numpy(rng.randn(1, 12, 3)),
             None, None)
    before = [t.clone() for t in step.state.tensors()]
    assert math.isnan(float(step(*batch)))
    assert all(torch.equal(a, b) for a, b in zip(before, step.state.tensors()))
    opt.param_groups[0]["lr"] = 1e-3
    assert math.isfinite(float(step(*batch))) and step.state.step == 1


def test_capture_step_runs_calls_on_the_cpu():
    net = EGNNNetwork(depth=1, dim=8, num_tokens=21, layer_kwargs=dict(num_nearest_neighbors=4),
                      **F64)
    step = make_denoise_train_step(net, make_adam(net.parameters(), 1e-3))
    assert capture_step(step, step.state) is step


# ---------------------------------------------------------------------------
# the trainers' --block
# ---------------------------------------------------------------------------

SMALL_DENOISE = ["--device", "cpu", "--steps", "8", "--nodes", "24", "--depth", "1", "--dim",
                 "8", "--knn", "4", "--grad-accum", "4", "--lr", "1e-2"]


def _ckpts(directory):
    return {p.name: torch.load(p, weights_only=True) for p in sorted(Path(directory).glob("*.pt"))}


def _assert_bitwise(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_bitwise(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


class _Stop(Exception):
    pass


@pytest.mark.parametrize("data", [False, True], ids=["synthetic", "file"])
def test_denoise_blocks_equal_blocks_of_one(tmp_path, data):
    """Blocks of 3 against blocks of 1 and eager calls, checkpoints every 2
    micro-steps inside windows of 4 (a block ends at each); then a run
    stopped at the checkpoint of micro-step 2 and resumed in blocks of 3:
    every checkpoint and the losses bitwise."""
    argv = SMALL_DENOISE + ["--ckpt-every", "2"]
    if data:
        argv += ["--make-data", str(tmp_path / "bb.npz"), "--data-proteins", "4"]
    runs = {b: denoise.main(argv + ["--block", str(b), "--ckpt-dir", str(tmp_path / f"b{b}")])
            for b in (3, 1, 0)}
    assert runs[3]["losses"] == runs[1]["losses"] == runs[0]["losses"]
    assert all(math.isfinite(v) for v in runs[3]["losses"])
    ref = _ckpts(tmp_path / "b1")
    assert sorted(ref) == [f"ckpt_{s:09d}.pt" for s in (4, 6, 8)]   # max_to_keep 3
    for b in (3, 0):
        _assert_bitwise(_ckpts(tmp_path / f"b{b}"), ref, f"block {b}")

    def stop(step):
        if step == 2:
            raise _Stop

    stopped = tmp_path / "stopped"
    with pytest.raises(_Stop):
        denoise.main(argv + ["--block", "3", "--ckpt-dir", str(stopped)], on_checkpoint=stop)
    resumed = denoise.main(argv + ["--block", "3", "--ckpt-dir", str(stopped), "--resume"])
    assert resumed["start"] == 2 and resumed["losses"] == runs[1]["losses"][2:]
    _assert_bitwise(_ckpts(stopped), ref, "resumed")
    assert ref["ckpt_000000006.pt"]["optimizer"]["mini_step"] == 2


def test_molecule_blocks_equal_blocks_of_one():
    argv = ["--device", "cpu", "--steps", "7", "--graphs", "2", "--na", "12", "--knn", "4",
            "--dim", "8", "--layers", "1", "--lr", "3e-3"]
    runs = {b: mr.main(argv + ["--block", str(b)]) for b in (3, 1, 0)}
    for b in (3, 0):
        assert runs[b]["losses"] == runs[1]["losses"] and runs[b]["maes"] == runs[1]["maes"]
    assert len(runs[3]["losses"]) == 7 and all(math.isfinite(v) for v in runs[3]["losses"])
    assert runs[3]["block"] == 3 and runs[3]["first_block_steps"] == 3
    host = mr.main(argv + ["--block", "3", "--host-graphs"])   # ignores --block, as JAX's
    assert host["block"] is None and len(host["losses"]) == 7


# ---------------------------------------------------------------------------
# --from-sidechainnet without the package
# ---------------------------------------------------------------------------

def test_from_sidechainnet_raises_as_the_jax_example(tmp_path, monkeypatch):
    if importlib.util.find_spec("sidechainnet") is not None:
        pytest.skip("sidechainnet is installed: the export would download")
    out = str(tmp_path / "casp.npz")
    with pytest.raises(ImportError, match="sidechainnet") as port:
        denoise.main(["--device", "cpu", "--from-sidechainnet", out])
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("jax_denoise_example",
                                                  root / "examples" / "denoise.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cache = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(sys, "argv", ["denoise.py", "--from-sidechainnet", out])
    try:
        with pytest.raises(ImportError, match="sidechainnet") as ref:
            example.main()
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    assert type(port.value) is type(ref.value) and str(port.value) == str(ref.value)
    assert not Path(out).exists()
