"""The port's training pieces against ``egnn_tpu.training``, on the CPU in
float64: ``masked_mse``, the flat-buffer Adam, optax's Adam with clipping
and accumulation, and the denoising train step of ``EGNNNetwork`` with the
weights carried across by ``load_flax_params``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import egnn_tpu
from egnn_tpu import training as jtrain
from egnn_tpu_torch import EGNNNetwork
from egnn_tpu_torch import training as ttrain
from egnn_tpu.ops import neighbors as jnb
from egnn_tpu_torch.ops.cuda import build
from egnn_tpu_torch.ops.cuda import knn as knn_kernels
from egnn_tpu_torch.utils.port_weights import load_flax_params

F64 = dict(device="cpu", dtype=torch.float64)


def _flat(tree, prefix=""):
    """A Flax parameter tree by torch parameter name ("egnn_0.edge_mlp_0_w")."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


@pytest.mark.parametrize("mask_kind", ["none", "ragged", "empty"])
def test_masked_mse_matches_jax(mask_kind):
    rng = np.random.RandomState(0)
    pred, target = rng.randn(2, 7, 3), rng.randn(2, 7, 3)
    mask = {"none": None, "ragged": rng.rand(2, 7) > 0.4,
            "empty": np.zeros((2, 7), bool)}[mask_kind]
    j = jtrain.masked_mse(jnp.asarray(pred), jnp.asarray(target),
                          None if mask is None else jnp.asarray(mask))
    t = ttrain.masked_mse(torch.from_numpy(pred), torch.from_numpy(target),
                          None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-14)


def _toy_params():
    return {"a": {"w": np.array([[0.5, -1.0], [2.0, 0.1]]), "b": np.zeros(2)},
            "c": np.array([3.0, -0.2, 0.7])}


def _toy_loss(w, b, c, scale=1.0, xp=jnp):
    """tests/test_utils_subsystems.py's loss, times a per-call scale."""
    return scale * ((w ** 2).sum() + xp.abs(b - 1.0).sum() + (xp.sin(c) ** 2).sum())


def test_fused_adam_matches_jax():
    params = _toy_params()
    tx = jtrain.make_fused_adam(3e-2)
    state = jtrain.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    grad = jax.jit(jax.grad(lambda p: _toy_loss(p["a"]["w"], p["a"]["b"], p["c"])))
    ts = [torch.from_numpy(params["a"]["w"].copy()).requires_grad_(),
          torch.from_numpy(params["a"]["b"].copy()).requires_grad_(),
          torch.from_numpy(params["c"].copy()).requires_grad_()]
    opt = ttrain.make_fused_adam(ts, 3e-2)
    for _ in range(25):
        state = state.apply_gradients(grad(state.params))
        opt.zero_grad()
        _toy_loss(*ts, xp=torch).backward()
        opt.step()
    for t, j in zip(ts, (state.params["a"]["w"], state.params["a"]["b"], state.params["c"])):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-10, atol=1e-14)
    assert int(opt.state_dict()["state"]["flat"]["count"]) == 25


@pytest.mark.parametrize("grad_accum,clip_norm", [(1, None), (1, 0.5), (4, 1.0)])
def test_adam_matches_optax(grad_accum, clip_norm):
    """optax.adam behind clip_by_global_norm, inside optax.MultiSteps: the
    gradients of grad_accum calls are averaged and the parameters move on
    every grad_accum-th call only."""
    params = jax.tree_util.tree_map(jnp.asarray, _toy_params())
    tx = jtrain.make_adam(3e-2, grad_accum=grad_accum, clip_norm=clip_norm)
    opt_state = tx.init(params)

    @jax.jit
    def jstep(p, s, scale):
        g = jax.grad(lambda q: _toy_loss(q["a"]["w"], q["a"]["b"], q["c"], scale))(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    np_params = _toy_params()
    ts = [torch.from_numpy(np_params["a"]["w"].copy()).requires_grad_(),
          torch.from_numpy(np_params["a"]["b"].copy()).requires_grad_(),
          torch.from_numpy(np_params["c"].copy()).requires_grad_()]
    opt = ttrain.make_adam(ts, 3e-2, grad_accum=grad_accum, clip_norm=clip_norm)
    for i in range(12):
        scale = 1.0 + 0.25 * i  # a different gradient on every call
        params, opt_state = jstep(params, opt_state, scale)
        opt.zero_grad()
        _toy_loss(*ts, scale=scale, xp=torch).backward()
        opt.step()
        for t, j in zip(ts, (params["a"]["w"], params["a"]["b"], params["c"])):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-10,
                                       atol=1e-14)


TRAIN_CASES = {
    "anchor_like": dict(net={}, n=64),
    "adj_degrees": dict(net=dict(num_adj_degrees=2, adj_dim=4), n=48),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_denoise_train_step_matches_jax(case):
    """Three steps of the port's train step with the flat-buffer Adam
    against three of egnn_tpu's, from the same weights on the same batch:
    losses and final parameters at atol 1e-9 (float64)."""
    spec = TRAIN_CASES[case]
    n = spec["n"]
    layer = dict(num_nearest_neighbors=8, norm_coors=True, coor_weights_clamp_value=2.0,
                 init_eps=0.1)
    net_kw = dict(depth=2, dim=16, num_tokens=21, num_positions=n, layer_kwargs=layer,
                  **spec["net"])
    rng = np.random.RandomState(21)
    tokens = rng.randint(0, 21, size=(2, n))
    clean = np.cumsum(rng.randn(2, n, 3), axis=1)
    noised = clean + rng.randn(2, n, 3)
    mask = np.arange(n)[None, :] < rng.randint(n // 2, n + 1, size=(2, 1))
    adj = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1

    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    jargs = (jnp.asarray(tokens), jnp.asarray(noised), jnp.asarray(clean), jnp.asarray(adj),
             jnp.asarray(mask))
    params = jnet.init(jax.random.PRNGKey(0), jargs[0], jargs[1], adj_mat=jargs[3],
                       mask=jargs[4])["params"]
    jstate = jtrain.TrainState.create(params, jtrain.make_fused_adam(1e-3))
    jstep = jtrain.make_denoise_train_step(jnet, donate=False)

    tnet = EGNNNetwork(**net_kw, **F64)
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    tstep = ttrain.make_denoise_train_step(tnet, ttrain.make_fused_adam(tnet.parameters(), 1e-3))
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in (tokens, noised, clean, adj, mask))
    for _ in range(3):
        jstate, jloss = jstep(jstate, *jargs)
        tloss = tstep(*targs)
        assert tloss.dim() == 0 and not tloss.requires_grad
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=0, atol=1e-9)
    assert tstep.state.step == 3
    jflat = _flat(jstate.params)
    tparams = dict(tnet.named_parameters())
    assert sorted(jflat) == sorted(tparams)
    for name, value in jflat.items():
        np.testing.assert_allclose(tparams[name].detach().numpy(), value, rtol=0, atol=1e-9,
                                   err_msg=name)


LARGE_N_TRAIN_CASES = {
    # benchmarks/net65k.py's network: features in, no mask, no adjacency; the
    # packed-tiled candidates, kc = k + 4 slots, the backward over n * kc rows
    "net65k_packed_tiled": dict(net={}, tokens=False, mask=False, adj=False),
    # the anchor-3 family: the exact tiled selection under the adjacency
    "anchor_tiled": dict(net=dict(num_tokens=21, num_positions=256), tokens=True, mask=True,
                         adj=True),
}


@pytest.mark.parametrize("case", sorted(LARGE_N_TRAIN_CASES))
def test_denoise_train_step_on_large_n_routes_matches_jax(case, monkeypatch):
    """The unchanged train step over the large-n selection routes: the JAX
    dispatcher forced onto its packed-tiled (or, with an adjacency, tiled)
    kernel in interpret mode, the port through ``auto`` with its full-band
    reach lowered. Three steps' losses and the final parameters at atol 1e-9
    (float64 modules; both sides select and re-rank in float32)."""
    spec = LARGE_N_TRAIN_CASES[case]
    n, dim = 256, 16
    real = jnb.knn_select_gather

    def forced(coors, k, radius, mask=None, adj_mat=None, **kw):
        kw.update(backend="tiled" if adj_mat is not None else "packed_tiled", interpret=True)
        return real(coors, k, radius, mask=mask, adj_mat=adj_mat, **kw)

    monkeypatch.setattr(jnb, "knn_select_gather", forced)
    monkeypatch.setattr(knn_kernels, "FULL_BAND_MAX_N", 128)
    layer = dict(num_nearest_neighbors=8, norm_coors=True, coor_weights_clamp_value=2.0,
                 init_eps=0.1)
    net_kw = dict(depth=2, dim=dim, layer_kwargs=layer, **spec["net"])
    rng = np.random.RandomState(33)
    tokens = rng.randint(0, 21, size=(2, n)) if spec["tokens"] else rng.randn(2, n, dim)
    clean = rng.rand(2, n, 3) * 6.0
    noised = clean + 0.3 * rng.randn(2, n, 3)
    mask = (np.arange(n)[None, :] < rng.randint(n // 2, n + 1, size=(2, 1))
            if spec["mask"] else None)
    adj = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1 if spec["adj"] else None

    def both(convert):
        return tuple(None if a is None else convert(a) for a in (tokens, noised, clean, adj, mask))

    jargs, targs = both(jnp.asarray), both(torch.from_numpy)
    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    params = jnet.init(jax.random.PRNGKey(0), jargs[0], jargs[1], adj_mat=jargs[3],
                       mask=jargs[4])["params"]
    jstate = jtrain.TrainState.create(params, jtrain.make_fused_adam(1e-3))
    jstep = jtrain.make_denoise_train_step(jnet, donate=False)
    tnet = EGNNNetwork(**net_kw, **F64)
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    tstep = ttrain.make_denoise_train_step(tnet, ttrain.make_fused_adam(tnet.parameters(), 1e-3))
    for _ in range(3):
        jstate, jloss = jstep(jstate, *jargs)
        tloss = tstep(*targs)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=0, atol=1e-9)
    jflat = _flat(jstate.params)
    tparams = dict(tnet.named_parameters())
    assert sorted(jflat) == sorted(tparams)
    for name, value in jflat.items():
        np.testing.assert_allclose(tparams[name].detach().numpy(), value, rtol=0, atol=1e-9,
                                   err_msg=name)


def test_cpu_train_step_never_builds(monkeypatch):
    """A train step on the CPU runs every kernel's plain version, forward
    and backward, and never invokes nvcc; the loss falls on a fixed batch."""
    from egnn_tpu_torch.training.data import synthetic_chain_batch

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not invoke nvcc")

    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "library", refuse)
    net = EGNNNetwork(depth=2, dim=8, num_tokens=21, num_positions=32,
                      layer_kwargs=dict(num_nearest_neighbors=4, norm_coors=True),
                      device="cpu", generator=torch.Generator().manual_seed(0))
    step = ttrain.make_denoise_train_step(net, ttrain.make_fused_adam(net.parameters(), 1e-2))
    rq = synthetic_chain_batch(np.random.default_rng(0), 2, 32, device="cpu")
    losses = [step(rq.tokens, rq.noised_coors, rq.clean_coors, rq.adj_mat, rq.mask)
              for _ in range(5)]
    assert all(torch.isfinite(x) for x in losses) and losses[-1] < losses[0]
