"""The port's helpers (``egnn_tpu_torch/utils``: rotations, checks,
profiling) against ``egnn_tpu.utils``, as ``tests/test_utils_subsystems.py``
holds the JAX package. Rotations at 1e-12 in float64 and 1e-6 in float32
(sin/cos of two libraries); ``Roofline``'s arithmetic exactly, with the same
peaks on both sides; a step that makes NaN leaves the parameters and the
optimizer state bitwise unchanged."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu import utils as ju
from egnn_tpu_torch import EGNN
from egnn_tpu_torch.training import make_adam, make_denoise_train_step, make_fused_adam
from egnn_tpu_torch.training.data import synthetic_chain_batch
from egnn_tpu_torch.utils import checks, profiling, rotations


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
def test_rotations_match(dtype, tol):
    rng = np.random.RandomState(0)
    for a, b, c in rng.uniform(-math.pi, math.pi, size=(5, 3)):
        args = [torch.tensor(v, dtype=dtype) for v in (a, b, c)]
        got = rotations.rot(*args)
        ref = np.asarray(ju.rot(*(jnp.asarray(v, dtype=jnp.float64 if dtype == torch.float64
                                              else jnp.float32) for v in (a, b, c))))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
        np.testing.assert_allclose(rotations.rot_y(args[1]).numpy(),
                                   np.asarray(ju.rot_y(float(b))), rtol=0, atol=tol)
        np.testing.assert_allclose(rotations.rot_z(args[2]).numpy(),
                                   np.asarray(ju.rot_z(float(c))), rtol=0, atol=tol)
    r = rotations.rot(0.3, 0.7, 1.1, device="cpu")
    assert r.dtype == torch.float64
    np.testing.assert_allclose((r @ r.T).numpy(), np.eye(3), atol=1e-12)
    # a batch of angles gives a batch of matrices
    assert rotations.rot_z(torch.zeros(4, dtype=torch.float64)).shape == (4, 3, 3)


def test_guard_finite_raises():
    checks.guard_finite({"a": torch.ones(3), "n": torch.tensor([1, 2])}, "y")
    with pytest.raises(ValueError, match=r"non-finite values in y\[leaf 1\]"):
        checks.guard_finite([torch.ones(3), torch.tensor([0.0, math.nan])], "y")
    f = checks.checked(lambda x: x + 1)
    assert f(1) == 2


def test_assert_in_bounds():
    checks.assert_in_bounds(torch.tensor([0, 9]), 10, "edge")
    for bad in ([0, 10], [-1, 3]):
        with pytest.raises(ValueError, match="edge out of bounds for size 10"):
            checks.assert_in_bounds(torch.tensor(bad), 10, "edge")


def test_tree_all_finite():
    ok = checks.tree_all_finite({"a": torch.ones(3), "b": torch.zeros(2)})
    assert isinstance(ok, torch.Tensor) and ok.dim() == 0 and bool(ok)
    assert not bool(checks.tree_all_finite({"a": torch.tensor([1.0, math.inf])}))
    assert bool(checks.tree_all_finite({"i": torch.tensor([1, 2])}))
    assert bool(ju.tree_all_finite({"a": jnp.ones(3)})) == bool(
        checks.tree_all_finite({"a": torch.ones(3)}))


def _snapshot(net, opt):
    return ([p.detach().clone() for p in net.parameters()],
            [t.clone() for t in checks._leaves(opt)])


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("make_opt", [lambda ps: make_adam(ps, 1e-2, grad_accum=2),
                                      lambda ps: make_fused_adam(ps, 1e-2)],
                         ids=["adam_accum", "fused_adam"])
def test_finite_or_skip_step(make_opt):
    """A step whose targets hold NaN leaves every parameter and optimizer
    tensor as it was, bit for bit, and returns NaN; a finite step moves
    them and returns its loss (as egnn_tpu's finite_or_skip_step)."""
    net = EGNN(dim=8, num_nearest_neighbors=4, device="cpu",
               generator=torch.Generator().manual_seed(0))
    opt = make_opt(net.parameters())
    inner = make_denoise_train_step(_FeatsNet(net), opt)
    step = checks.finite_or_skip_step(inner)
    b = synthetic_chain_batch(np.random.default_rng(0), 1, 12, device="cpu")
    feats = torch.randn(1, 12, 8, generator=torch.Generator().manual_seed(1), dtype=torch.float32)
    for _ in range(3):   # two updates and one accumulation inside a window
        loss = step(feats, b.noised_coors, b.clean_coors, None, b.mask)
        assert torch.isfinite(loss)
    before = _snapshot(net, opt)
    bad = b.clean_coors.clone()
    bad[0, 0, 0] = math.nan
    loss = step(feats, b.noised_coors, bad, None, b.mask)
    assert torch.isnan(loss)
    after = _snapshot(net, opt)
    assert _same(before[0], after[0]) and _same(before[1], after[1])
    for shift in (1.0, 2.0):   # finite steps move them again, a window's update included
        good = step(feats + shift, b.noised_coors, b.clean_coors, None, b.mask)
        assert torch.isfinite(good)
    moved = _snapshot(net, opt)
    assert not _same(before[0], moved[0]) and not _same(before[1], moved[1])


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
    """optax's ScaleByAdamState inside a MultiSteps state."""
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    for child in (tree if isinstance(tree, tuple) else ()):
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def test_finite_or_skip_step_matches_jax():
    """The guarded denoise step with Adam over windows of 2 micro-steps
    against egnn_tpu's, float64: a NaN on a window's last micro-step is
    skipped on both sides, and after the next two finite micro-steps (one
    completes the window, one opens the next) the parameters and the whole
    optimizer state (count, moments, accumulator, window counter) agree at
    atol 1e-9, as the train step's own parity test holds them."""
    import jax

    import egnn_tpu
    from egnn_tpu import training as jtrain
    from egnn_tpu_torch import EGNNNetwork
    from egnn_tpu_torch.utils.port_weights import load_flax_params

    n = 16
    net_kw = dict(depth=1, dim=8, num_tokens=21, num_positions=n,
                  layer_kwargs=dict(num_nearest_neighbors=4, norm_coors=True, init_eps=0.1))
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, 21, size=(1, n))
    clean = np.cumsum(rng.randn(1, n, 3), axis=1)
    mask = np.ones((1, n), bool)
    batches = []
    for i in range(6):
        target = clean.copy()
        if i == 3:   # the last micro-step of the second window
            target[0, 0, 0] = math.nan
        batches.append((tokens, clean + rng.randn(1, n, 3), target, None, mask))

    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(clean),
                       mask=jnp.asarray(mask))["params"]
    jstate = jtrain.TrainState.create(params, jtrain.make_adam(1e-2, grad_accum=2))
    jstep = ju.finite_or_skip_step(jtrain.make_denoise_train_step(jnet, donate=False))

    tnet = EGNNNetwork(**net_kw, device="cpu", dtype=torch.float64)
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    opt = make_adam(tnet.parameters(), 1e-2, grad_accum=2)
    tstep = checks.finite_or_skip_step(make_denoise_train_step(tnet, opt))
    for i, batch in enumerate(batches):
        jstate, jloss = jstep(jstate, *(None if a is None else jnp.asarray(a) for a in batch))
        tloss = tstep(*(None if a is None else torch.from_numpy(a) for a in batch))
        assert math.isnan(float(jloss)) == math.isnan(float(tloss)) == (i == 3), i
        if i != 3:
            np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=0, atol=1e-9)
    assert tstep.state.step == int(jstate.step) == 5

    ms = jstate.opt_state
    inner = _adam_state(ms.inner_opt_state)
    assert opt.mini_step == int(ms.mini_step) == 1
    names = dict(tnet.named_parameters())
    for key, jtree in (("param", jstate.params), ("acc", ms.acc_grads), ("m", inner.mu),
                       ("v", inner.nu)):
        jflat = _flat(jtree)
        assert sorted(jflat) == sorted(names)
        for name, value in jflat.items():
            p = names[name]
            got = p if key == "param" else opt.state[p][key]
            np.testing.assert_allclose(got.detach().numpy(), value, rtol=0, atol=1e-9,
                                       err_msg=f"{key} {name}")
    assert {int(opt.state[p]["count"]) for p in names.values()} == {int(inner.count)} == {2}


class _FeatsNet(torch.nn.Module):
    """An EGNN layer behind the network's call signature
    (tokens -> feats)."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, feats, coors, adj_mat=None, mask=None):
        return self.layer(feats, coors, mask=mask)


def test_roofline_matches_jax_with_equal_peaks():
    kw = dict(flops=3.1e9, bytes_accessed=7.7e8, peak_flops=5e13, peak_bw=2e12)
    for seconds in (1.3e-4, 2e-3, 0.0):
        a = profiling.Roofline("op", seconds, **kw)
        b = ju.Roofline("op", seconds, **kw)
        for name in ("achieved_flops", "achieved_bw", "compute_fraction",
                     "bandwidth_fraction", "bound"):
            assert getattr(a, name) == getattr(b, name), name
        assert a.report() == b.report()
    r = profiling.Roofline("k", 1e-3, flops=67e9, bytes_accessed=6.7e9)
    assert (r.peak_flops, r.peak_bw) == (67e12, 3.35e12) and "H100" in r.card
    assert r.bytes_seconds == 6.7e9 / 3.35e12 and r.flops_seconds == 67e9 / 67e12
    assert r.bound_seconds == max(r.bytes_seconds, r.flops_seconds)


def test_timers_on_the_cpu():
    x = torch.randn(64, 64, dtype=torch.float32)
    t = profiling.time_fn(lambda: x @ x, reps=3, warmup=1, device="cpu")
    assert math.isfinite(t) and t > 0
    t = profiling.time_fn(lambda a: a @ a, lambda i: (x + i,), reps=5, stat="median",
                          device="cpu")
    assert math.isfinite(t) and t > 0
    t = profiling.measure_op(lambda a: torch.tanh(a @ a), x, reps_lo=4, reps_hi=24,
                             reps_outer=3, device="cpu")
    assert math.isfinite(t) and t > 0
    with pytest.raises(ValueError, match="CUDA"):
        profiling.time_fn(lambda: x, graph_reps=2, device="cpu")
    with pytest.raises(ValueError, match="stat"):
        profiling.time_fn(lambda: x, stat="mean", device="cpu")
    calls = []
    many = profiling.chain_calls(lambda a: calls.append(1) or (a * 2, a), 5)
    y = many(torch.ones(3, dtype=torch.float64))
    assert len(calls) == 5 and bool((y > 1).all())


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32, dtype=torch.float32)
    with profiling.trace(str(tmp_path / "tr"), device="cpu"):
        with profiling.annotate("egnn_block"):
            (x @ x).sum()
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "egnn_block" in text
