"""``EGNN(fused_pairs=True)`` and ``EGNN(fused_knn=True)`` of the port, on the
CPU (where the kernels' plain versions run): against ``egnn_tpu``'s layers
with the same flags and the weights carried by ``load_flax_params``, and
against the port's own unfused layer.

Tolerances. The port's modules are float64 here. ``egnn_tpu``'s
``fused_pairs`` runs its Pallas kernel in interpret mode, which computes in
float32 whatever it is given: outputs agree at rtol 2e-4 / atol 2e-5
(``tests/test_fused_pairs.py``'s). Its ``fused_knn`` gate asks for a TPU, so
off the TPU that flag takes the float64 unfused pipeline and agrees at 1e-9.
Against the port's own unfused layer everything is float64: outputs at
1e-12, parameter and feature gradients at 1e-9 of each tensor's largest
value. Coordinate gradients get 1e-5 of the largest value: every kNN row
holds its own node (dist = 0, or the adjacency's -1 fill), and under
``norm_coors`` that pair carries +-scale / eps = 1e6..1e8-sized terms in the
i-side and j-side gradients that cancel only when both are summed, in
another order on the fused path than on the unfused one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
from egnn_tpu import training as jtrain
from egnn_tpu.ops import neighbors as jnb
from egnn_tpu_torch import EGNN, EGNNNetwork
from egnn_tpu_torch import training as ttrain
from egnn_tpu_torch.ops import neighbors as tnb
from egnn_tpu_torch.ops.cuda import knn as K
from egnn_tpu_torch.ops.cuda import pair_messages as PM
from egnn_tpu_torch.utils.port_weights import load_flax_params

F64 = dict(device="cpu", dtype=torch.float64)
FLAGS = pytest.mark.parametrize("flag", ["fused_pairs", "fused_knn"])
# against egnn_tpu: its fused_pairs kernel is float32, its fused_knn falls to
# the float64 unfused pipeline off the TPU
JAX_TOL = {"fused_pairs": dict(rtol=2e-4, atol=2e-5), "fused_knn": dict(rtol=0, atol=1e-9)}


def _inputs(seed, b, n, dim, with_mask=True, with_adj=True, edge_dim=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, n, dim)
    coors = rng.randn(b, n, 3) * 2.0
    mask = np.arange(n)[None, :] < rng.randint(n // 2, n + 1, size=(b, 1)) if with_mask else None
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


@pytest.fixture
def count_fused(monkeypatch):
    """Counts the calls that reach the port's fused wrappers."""
    calls = {"fused_pairs": 0, "fused_knn": 0}
    for flag, name in (("fused_pairs", "fused_pair_messages"), ("fused_knn", "fused_knn_messages")):
        real = getattr(PM, name)

        def counted(*a, _real=real, _flag=flag, **kw):
            calls[_flag] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(PM, name, counted)
    return calls


LAYER_CASES = {
    # the anchor-3 arrangement: node mask, chain adjacency, CoorsNorm, clamp
    "mask_adj_norm_clamp": dict(kw=dict(num_nearest_neighbors=8, norm_coors=True,
                                        coor_weights_clamp_value=2.0, norm_feats=True)),
    "no_mask_radius": dict(kw=dict(num_nearest_neighbors=8, valid_radius=1.0), mask=False,
                           adj=False),
    "mean_soft_fourier": dict(kw=dict(num_nearest_neighbors=8, m_pool_method="mean",
                                      soft_edges=True, fourier_features=2, valid_radius=3.0),
                              adj=False),
    "mean_no_mask_k5": dict(kw=dict(num_nearest_neighbors=5, m_pool_method="mean",
                                    norm_coors=True), mask=False, adj=False),
}


def _layer_case(case):
    spec = LAYER_CASES[case]
    kw = dict(spec["kw"], init_eps=0.1)
    feats, coors, mask, adj, _ = _inputs(len(case), 2, 40, 16, spec.get("mask", True),
                                         spec.get("adj", True))
    return kw, feats, coors, mask, adj


@FLAGS
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_fused_layer_matches_jax(case, flag, count_fused):
    kw, feats, coors, mask, adj = _layer_case(case)
    jlayer = egnn_tpu.EGNN(dim=16, **kw, **{flag: True})
    jargs = (_j(feats), _j(coors), None, _j(mask), _j(adj))
    params = _flax_params(jlayer, *jargs)
    jf, jc = jlayer.apply({"params": params}, *jargs)
    tlayer = EGNN(dim=16, **kw, **{flag: True}, **F64)
    load_flax_params(tlayer, params)
    tf, tc = tlayer(_t(feats), _t(coors), None, _t(mask), _t(adj))
    assert count_fused[flag] == 1
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **JAX_TOL[flag])
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), **JAX_TOL[flag])


def _loss_and_grads(layer, feats, coors, **kw):
    feats, coors = feats.clone().requires_grad_(), coors.clone().requires_grad_()
    fo, co = layer(feats, coors, **kw)
    loss = (fo ** 2).mean() + (torch.tanh(co) ** 2).mean()
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(loss, [feats, coors] + list(params.values()), allow_unused=True)
    return (fo, co), dict(zip(["feats", "coors"] + list(params), grads))


def _assert_grads_close(fused, plain):
    assert fused.keys() == plain.keys()
    for name, ref in plain.items():
        got = fused[name]
        assert (got is None) == (ref is None), name
        if ref is None:
            continue
        tol = 1e-5 if name == "coors" else 1e-9   # see the module's docstring
        scale = max(ref.abs().max().item(), 1e-30)
        assert (got - ref).abs().max().item() <= tol * scale, name


@FLAGS
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_fused_layer_matches_the_unfused_layer(case, flag, count_fused):
    """Outputs and every gradient in float64; one set of weights feeds both
    layers (the fused paths add no parameter)."""
    kw, feats, coors, mask, adj = _layer_case(case)
    plain = EGNN(dim=16, **kw, **F64, generator=torch.Generator().manual_seed(4))
    fused = EGNN(dim=16, **kw, **{flag: True}, **F64)
    fused.load_state_dict(plain.state_dict())
    args = dict(mask=_t(mask), adj_mat=_t(adj))
    out_p, g_p = _loss_and_grads(plain, _t(feats), _t(coors), **args)
    assert count_fused[flag] == 0
    out_f, g_f = _loss_and_grads(fused, _t(feats), _t(coors), **args)
    assert count_fused[flag] == 1
    for a, b_ in zip(out_f, out_p):
        torch.testing.assert_close(a, b_, rtol=0, atol=1e-12)
    _assert_grads_close(g_f, g_p)


NETWORK_CASES = {
    # anchor-3 shape at depth 2, dim 16: tokens, positions, mask, chain adjacency;
    # no num_adj_degrees, so the layers get no edges and the flags engage
    "anchor_like": dict(net=dict(num_tokens=21, num_positions=64),
                        layer=dict(num_nearest_neighbors=8, norm_coors=True,
                                   coor_weights_clamp_value=2.0)),
    "no_mask_mean": dict(net=dict(num_tokens=21), mask=False, adj=False,
                         layer=dict(num_nearest_neighbors=6, m_pool_method="mean")),
}


@FLAGS
@pytest.mark.parametrize("case", sorted(NETWORK_CASES))
def test_fused_network_matches_jax(case, flag, count_fused):
    spec = NETWORK_CASES[case]
    n = 64
    layer = dict(spec["layer"], init_eps=0.1, **{flag: True})
    rng = np.random.RandomState(len(case))
    tokens = rng.randint(0, 21, size=(2, n))
    _, coors, mask, adj, _ = _inputs(7, 2, n, 1, spec.get("mask", True), spec.get("adj", True))
    jnet = egnn_tpu.EGNNNetwork(depth=2, dim=16, layer_kwargs=layer, **spec["net"])
    jkw = dict(adj_mat=_j(adj), mask=_j(mask))
    params = _flax_params(jnet, _j(tokens), _j(coors), **jkw)
    jf, jc = jnet.apply({"params": params}, _j(tokens), _j(coors), **jkw)
    tnet = EGNNNetwork(depth=2, dim=16, layer_kwargs=layer, **spec["net"], **F64)
    load_flax_params(tnet, params)
    tf, tc = tnet(_t(tokens), _t(coors), adj_mat=_t(adj), mask=_t(mask))
    assert count_fused[flag] == 2
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **JAX_TOL[flag])
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), **JAX_TOL[flag])


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "mask"])
def test_fused_pairs_over_the_wide_candidate_slots(with_mask, monkeypatch, count_fused):
    """The composition of ``wide=True`` with the fused kernel: beyond the
    full-band reach the layer gets kc = k + 4 slots and a winner mask, and
    K10 sums over all kc with pv = the winners (kc = 12, no multiple of 8:
    nothing is padded). Against egnn_tpu forced onto its packed-tiled kernel
    in interpret mode, and against the port's own unfused wide layer."""
    real = jnb.knn_select_gather
    slots = []

    def forced(coors, k, radius, mask=None, adj_mat=None, **kw):
        kw.update(backend="packed_tiled", interpret=True)
        return real(coors, k, radius, mask=mask, adj_mat=adj_mat, **kw)

    treal = tnb.knn_select_gather

    def watched(*a, **kw):
        out = treal(*a, **kw)
        slots.append((out[0].indices.shape[-1], out[0].winner is not None))
        return out

    monkeypatch.setattr(jnb, "knn_select_gather", forced)
    monkeypatch.setattr(tnb, "knn_select_gather", watched)
    monkeypatch.setattr(K, "FULL_BAND_MAX_N", 128)
    kw = dict(num_nearest_neighbors=8, norm_coors=True, coor_weights_clamp_value=2.0,
              m_pool_method="mean", init_eps=0.1)
    rng = np.random.RandomState(11)
    n = 256
    feats = rng.randn(1, n, 16).astype(np.float32)
    coors = (rng.rand(1, n, 3) * 6.0).astype(np.float32)
    mask = (np.arange(n)[None, :] < 200) if with_mask else None
    jlayer = egnn_tpu.EGNN(dim=16, fused_pairs=True, **kw)
    jargs = (_j(feats), _j(coors), None, _j(mask))
    params = _flax_params(jlayer, *jargs)
    jf, jc = jlayer.apply({"params": params}, *jargs)
    fused = EGNN(dim=16, fused_pairs=True, **kw, **F64)
    load_flax_params(fused, params)
    args = dict(mask=_t(mask))
    tfeats, tcoors = _t(feats).double(), _t(coors).double()
    out_f, g_f = _loss_and_grads(fused, tfeats, tcoors, **args)
    assert slots == [(12, True)] and count_fused["fused_pairs"] == 1
    np.testing.assert_allclose(out_f[0].detach().numpy(), np.asarray(jf), **JAX_TOL["fused_pairs"])
    np.testing.assert_allclose(out_f[1].detach().numpy(), np.asarray(jc), **JAX_TOL["fused_pairs"])
    plain = EGNN(dim=16, **kw, **F64)
    plain.load_state_dict(fused.state_dict())
    out_p, g_p = _loss_and_grads(plain, tfeats, tcoors, **args)
    for a, b_ in zip(out_f, out_p):
        torch.testing.assert_close(a, b_, rtol=0, atol=1e-12)
    _assert_grads_close(g_f, g_p)


UNFUSED_ROUTES = {
    # what the kernels do not take: the flag gives way silently, as in the reference
    "dense_edges": dict(kw=dict(num_nearest_neighbors=6, edge_dim=4), edge_dim=4),
    "update_coors_only": dict(kw=dict(num_nearest_neighbors=8, update_feats=False)),
    "update_feats_only": dict(kw=dict(num_nearest_neighbors=8, update_coors=False)),
    "all_pairs": dict(kw=dict(norm_coors=True)),
    # outside the kernel's gate: more slots than a tile holds
    "k_beyond_the_gate": dict(kw=dict(num_nearest_neighbors=70), n=96),
}


@FLAGS
@pytest.mark.parametrize("case", sorted(UNFUSED_ROUTES))
def test_flag_gives_way_to_the_unfused_layer_bitwise(case, flag, count_fused):
    spec = UNFUSED_ROUTES[case]
    n = spec.get("n", 40)
    feats, coors, mask, adj, edges = _inputs(3, 2, n, 16, edge_dim=spec.get("edge_dim", 0))
    plain = EGNN(dim=16, **spec["kw"], device="cpu", generator=torch.Generator().manual_seed(2))
    fused = EGNN(dim=16, **spec["kw"], **{flag: True}, device="cpu")
    fused.load_state_dict(plain.state_dict())
    args = (_t(feats).float(), _t(coors).float(), None if edges is None else _t(edges).float(),
            _t(mask), _t(adj))
    for a, b_ in zip(fused(*args), plain(*args)):
        assert torch.equal(a, b_)
    assert count_fused[flag] == 0


def test_fused_knn_is_tested_before_fused_pairs(count_fused):
    feats, coors, mask, adj, _ = _inputs(5, 1, 32, 8)
    layer = EGNN(dim=8, num_nearest_neighbors=4, fused_knn=True, fused_pairs=True, device="cpu")
    layer(_t(feats).float(), _t(coors).float(), None, _t(mask), _t(adj))
    assert count_fused == {"fused_pairs": 0, "fused_knn": 1}


def test_fused_paths_ignore_compute_dtype():
    """The reference's fused branches cast nothing through ``compute_dtype``:
    the layer equals the one without it."""
    feats, coors, mask, adj, _ = _inputs(6, 2, 40, 16)
    kw = dict(dim=16, num_nearest_neighbors=8, norm_coors=True, init_eps=0.1)
    for flag in ("fused_pairs", "fused_knn"):
        a = EGNN(**kw, **{flag: True}, **F64, generator=torch.Generator().manual_seed(1))
        b_ = EGNN(**kw, **{flag: True}, compute_dtype=torch.float32, **F64)
        b_.load_state_dict(a.state_dict())
        args = (_t(feats), _t(coors), None, _t(mask), _t(adj))
        for x, y in zip(a(*args), b_(*args)):
            assert torch.equal(x, y)


def test_fused_options_that_stay_refused(count_fused, tmp_path):
    """``ring_axis`` stays refused beside kNN (``ValueError``, with or
    without a fused flag) and as an axis name (``TypeError``); dropout in
    training mode runs, and the fused flag gives way to the unfused layer
    meanwhile."""
    import torch.distributed as dist

    with pytest.raises(TypeError, match="ring_axis"):
        EGNN(dim=4, num_nearest_neighbors=2, ring_axis="x", device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1,
                            rank=0)
    try:
        for flag in ("fused_pairs", "fused_knn"):
            with pytest.raises(ValueError, match="ring_axis"):
                EGNN(dim=4, num_nearest_neighbors=2, ring_axis=dist.group.WORLD, device="cpu",
                     **{flag: True})
    finally:
        dist.destroy_process_group()
    dropping = EGNN(dim=4, num_nearest_neighbors=2, dropout=0.1, fused_pairs=True, device="cpu")
    f, c = dropping(torch.randn(1, 6, 4, dtype=torch.float32),
                    torch.randn(1, 6, 3, dtype=torch.float32),
                    generator=torch.Generator().manual_seed(0))
    assert f.shape == (1, 6, 4) and count_fused == {"fused_pairs": 0, "fused_knn": 0}


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def test_fused_pairs_train_steps_match_jax():
    """Three denoising train steps with ``fused_pairs=True`` on the anchor-3
    arrangement against egnn_tpu's, whose kernel (interpret mode) computes in
    float32 where the port's plain version is float64 here. The first loss
    comes from equal weights: rtol 1e-5. Later losses and the final weights
    follow Adam updates of +-lr = 1e-3 a step whose direction a float32
    gradient can tip where the gradient is near zero: losses at rtol 1e-3,
    weights within two updates of lr (the largest difference seen is 6e-4)."""
    n = 64
    layer = dict(num_nearest_neighbors=8, norm_coors=True, coor_weights_clamp_value=2.0,
                 init_eps=0.1, fused_pairs=True)
    net_kw = dict(depth=2, dim=16, num_tokens=21, num_positions=n, layer_kwargs=layer)
    rng = np.random.RandomState(21)
    tokens = rng.randint(0, 21, size=(2, n))
    clean = np.cumsum(rng.randn(2, n, 3), axis=1)
    noised = clean + rng.randn(2, n, 3)
    mask = np.arange(n)[None, :] < rng.randint(n // 2, n + 1, size=(2, 1))
    adj = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1
    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    jargs = tuple(jnp.asarray(a) for a in (tokens, noised, clean, adj, mask))
    params = jnet.init(jax.random.PRNGKey(0), jargs[0], jargs[1], adj_mat=jargs[3],
                       mask=jargs[4])["params"]
    jstate = jtrain.TrainState.create(params, jtrain.make_fused_adam(1e-3))
    jstep = jtrain.make_denoise_train_step(jnet, donate=False)
    tnet = EGNNNetwork(**net_kw, **F64)
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    tstep = ttrain.make_denoise_train_step(tnet, ttrain.make_fused_adam(tnet.parameters(), 1e-3))
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in (tokens, noised, clean, adj, mask))
    for i in range(3):
        jstate, jloss = jstep(jstate, *jargs)
        tloss = tstep(*targs)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5 if i == 0 else 1e-3)
    jflat = _flat(jstate.params)
    tparams = dict(tnet.named_parameters())
    assert sorted(jflat) == sorted(tparams)
    for name, value in jflat.items():
        np.testing.assert_allclose(tparams[name].detach().numpy(), value, rtol=0, atol=2e-3,
                                   err_msg=name)


@FLAGS
def test_fused_train_steps_match_the_unfused_network(flag):
    """Three train steps through the fused path against the same steps
    through the unfused network, both float64: losses at 1e-9 relative.
    The weights are not compared: Adam moves each by about lr whatever its
    gradient's size, so where the fused path's float64 rounding tips a
    near-zero gradient the weights part by an update, not by a rounding."""
    n = 48
    layer = dict(num_nearest_neighbors=8, norm_coors=True, coor_weights_clamp_value=2.0,
                 init_eps=0.1)
    rng = np.random.RandomState(5)
    tokens = torch.from_numpy(rng.randint(0, 21, size=(2, n)))
    clean = torch.from_numpy(np.cumsum(rng.randn(2, n, 3), axis=1))
    noised = clean + torch.from_numpy(rng.randn(2, n, 3))
    mask = torch.from_numpy(np.arange(n)[None, :] < rng.randint(n // 2, n + 1, size=(2, 1)))
    adj = torch.from_numpy(np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1)
    losses = {}
    for fused in (False, True):
        net = EGNNNetwork(depth=2, dim=16, num_tokens=21, num_positions=n,
                          layer_kwargs=dict(layer, **({flag: True} if fused else {})), **F64,
                          generator=torch.Generator().manual_seed(9))
        step = ttrain.make_denoise_train_step(net, ttrain.make_fused_adam(net.parameters(), 1e-3))
        losses[fused] = torch.stack([step(tokens, noised, clean, adj, mask) for _ in range(3)])
    torch.testing.assert_close(losses[True], losses[False], rtol=1e-9, atol=0)
    assert losses[True][-1] < losses[True][0]
