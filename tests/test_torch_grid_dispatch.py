"""The port's grid route (``knn_select_gather(backend="grid")``, and ``auto``
where the grid kernel's gate takes the shape) against the JAX package's in
Pallas interpret mode and against the port's exact selection, on the CPU:
every arm of the repair ladder, the whole-call fallback, the payload gather
and its gradient, ``EGNNNetwork`` and the denoising train step on the route.

On the CPU each kernel's wrapper runs its plain version; a spy on the
wrappers shows which arm a call took, as the launch counts do on the card.

Tolerances. ``indices`` and ``valid`` are exact. ``ranking`` agrees with the
JAX package at rtol = atol = 1e-6 (XLA may contract an FMA) and with the
port's exact selection bit for bit: every arm sums its squares in one order.
Gathered rows are copies; payload gradients agree at 1e-6 (float32 sums in
other orders). Network outputs at atol 1e-5 in float32, train steps at 1e-9
in float64 modules over a float32 selection, as on the other large-n routes.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
from egnn_tpu import training as jtrain
from egnn_tpu.ops import neighbors as jnb
from egnn_tpu_torch import EGNNNetwork
from egnn_tpu_torch import training as ttrain
from egnn_tpu_torch.ops import neighbors as tnb
from egnn_tpu_torch.ops import spatial as ts
from egnn_tpu_torch.ops.cuda import grid_knn as G
from egnn_tpu_torch.ops.cuda import knn as K
from egnn_tpu_torch.utils.port_weights import load_flax_params

NET65K_LAYER = dict(norm_coors=True, coor_weights_clamp_value=2.0)
WRAPPERS = {K: ("knn_select_gather", "knn_select", "knn_select_tiled",
                "knn_candidates_packed_tiled", "knn_candidates_packed", "knn_select_queries",
                "knn_select_window"),
            G: ("grid_knn_cells",)}


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _cloud(seed, b, n, kind="gaussian", scale=10.0, with_mask=False):
    rng = np.random.RandomState(seed)
    draw = rng.randn if kind == "gaussian" else rng.rand
    coors = (draw(b, n, 3) * scale).astype(np.float32)
    return coors, (rng.rand(b, n) > 0.1 if with_mask else None)


@pytest.fixture
def calls(monkeypatch):
    """The kernel wrappers called, in order, with the rows K8 was given."""
    seen = []
    for module, names in WRAPPERS.items():
        for name in names:
            def spy(*a, _fn=getattr(module, name), _name=name, **kw):
                seen.append((_name, a[0].shape[1]) if _name == "knn_select_queries" else _name)
                return _fn(*a, **kw)
            monkeypatch.setattr(module, name, spy)
    return seen


def _grid_both(coors, k, radius, mask, payload=None):
    jn, jg = jnb.knn_select_gather(_j(coors), k, radius, mask=_j(mask), payload=_j(payload),
                                   backend="grid", interpret=True, wide=True)
    tn, tg = tnb.knn_select_gather(_t(coors), k, radius, mask=_t(mask), payload=_t(payload),
                                   backend="grid", wide=True)
    return jn, jg, tn, tg


def _assert_same(jn, jg, tn, tg):
    np.testing.assert_array_equal(tn.indices.numpy(), np.asarray(jn.indices))
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(jn.valid))
    np.testing.assert_allclose(tn.ranking.numpy(), np.asarray(jn.ranking), rtol=1e-6, atol=1e-6)
    assert tn.winner is None and jn.winner is None
    assert (tg is None) == (jg is None)
    if tg is not None:
        np.testing.assert_array_equal(tg.detach().numpy(), np.asarray(jg))


def _assert_exact(tn, coors, k, mask, radius=math.inf):
    ev, ei = K.knn_select_plain(_t(coors), k, _t(mask))
    assert torch.equal(tn.indices, ei) and torch.equal(tn.ranking, ev)
    assert torch.equal(tn.valid, ev <= radius)
    assert tn.winner is None and tn.indices.dtype == torch.int64


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window_min_n", [16384, 0])
@pytest.mark.parametrize("with_mask", [False, True])
def test_grid_route_matches_jax_on_gaussian_clouds(monkeypatch, with_mask, window_min_n):
    """A Gaussian cloud at n = 1024: most rows certify, the boundary sliver
    is repaired, and the result with its gathered rows equals the JAX
    package's, whatever the window gate."""
    monkeypatch.setattr(jnb, "_WINDOW_REPAIR_MIN_N", window_min_n)
    monkeypatch.setattr(tnb, "_WINDOW_REPAIR_MIN_N", window_min_n)
    b, n, k = 2, 1024, 8
    coors, mask = _cloud(11 + with_mask, b, n, with_mask=with_mask)
    payload = np.random.RandomState(5).randn(b, n, 6).astype(np.float32)
    _, _, ok, row_exact = ts.grid_knn_select(_t(coors), k, mask=_t(mask))
    assert not bool(ok) and 0 < int((~row_exact).sum(1).max()) <= 128, "repairs must happen"
    jn, jg, tn, tg = _grid_both(coors, k, 30.0, mask, payload)
    _assert_same(jn, jg, tn, tg)
    _assert_exact(tn, coors, k, mask, 30.0)
    assert tg.shape == (b, n, k, 3 + with_mask + 6)


@pytest.mark.parametrize("case", ["uniform_mask", "pileup", "masked_fill_regime", "mixed_batch",
                                  "lattice"])
def test_grid_route_matches_jax(case):
    k = 8
    mask = None
    if case == "uniform_mask":
        coors, mask = _cloud(7, 2, 1024, "uniform", 5.0, with_mask=True)
    elif case == "pileup":      # cell overflow: the whole-call fallback
        base = np.random.RandomState(3).rand(8, 3).astype(np.float32)
        coors, k = np.tile(base, (512, 1))[None], 4
    elif case == "masked_fill_regime":   # k-th distance beyond the 1e5 fill
        coors, mask = _cloud(11, 1, 1024, "uniform", 5000.0, with_mask=True)
    elif case == "mixed_batch":
        coors = np.concatenate([_cloud(21, 2, 1024, "uniform")[0], _cloud(22, 1, 1024)[0]])
    else:
        coors = np.random.RandomState(5).randint(0, 10, size=(1, 1024, 3)).astype(np.float32)
    jn, jg, tn, tg = _grid_both(coors, k, 2.0, mask)
    _assert_same(jn, jg, tn, tg)
    _assert_exact(tn, coors, k, mask, 2.0)


def test_grid_route_gradients_match_jax():
    """The gathered rows carry gradients to the coordinates and the payload
    through ``gather_nodes``; selection is not differentiated."""
    n, k = 1024, 8
    coors, mask = _cloud(41, 1, n, with_mask=True)
    payload = np.random.RandomState(42).randn(1, n, 4).astype(np.float32)
    w = np.random.RandomState(43).randn(1, n, k, 3 + 1 + 4).astype(np.float32)

    def jloss(c, p):
        _, g = jnb.knn_select_gather(c, k, math.inf, mask=_j(mask), payload=p, backend="grid",
                                     interpret=True)
        return (g * jnp.asarray(w)).sum()

    jc, jp = jax.grad(jloss, argnums=(0, 1))(_j(coors), _j(payload))
    tc, tp = _t(coors).requires_grad_(), _t(payload).requires_grad_()
    nbhd, g = tnb.knn_select_gather(tc, k, math.inf, mask=_t(mask), payload=tp, backend="grid")
    assert not nbhd.indices.requires_grad and not nbhd.ranking.requires_grad
    (g * _t(w)).sum().backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the ladder's arms, by the wrappers called
# ---------------------------------------------------------------------------


def _failing_rows(coors, k, mask=None, kernel=False):
    select = G.grid_knn_select if kernel else ts.grid_knn_select
    return int((~select(_t(coors), k, mask=_t(mask))[3]).sum(dim=1).max())


def test_arm_certified_whole(calls):
    coors, mask = _cloud(0, 1, 1024, "uniform", with_mask=True)
    tn, _ = tnb.knn_select_gather(_t(coors), 8, math.inf, mask=_t(mask), backend="grid")
    assert calls == []          # the plain-torch grid alone
    _assert_exact(tn, coors, 8, mask)


@pytest.mark.parametrize("with_mask", [False, True])
def test_arm_direct_repair(calls, with_mask):
    """Up to 3n/64 (at least 128) failing rows: K8 on exactly those rows."""
    coors, mask = _cloud(3, 1, 1024, with_mask=with_mask)
    nbad = _failing_rows(coors, 8, mask)
    assert 0 < nbad <= 128
    tn, _ = tnb.knn_select_gather(_t(coors), 8, math.inf, mask=_t(mask), backend="grid")
    assert calls == [("knn_select_queries", nbad)]
    _assert_exact(tn, coors, 8, mask)


@pytest.mark.parametrize("with_mask", [False, True])
def test_arm_window_tier(monkeypatch, calls, with_mask):
    """A failing share in (3n/64, n/16] with the window gate open: K9 on the
    failing rows, then K8 on the few whose margin did not certify."""
    monkeypatch.setattr(tnb, "_WINDOW_REPAIR_MIN_N", 0)
    n, k = 4096, 5
    coors, mask = _cloud(0, 1, n, with_mask=with_mask)
    nbad = _failing_rows(coors, k, mask)
    assert 3 * n // 64 < nbad <= n // 16
    tn, _ = tnb.knn_select_gather(_t(coors), k, math.inf, mask=_t(mask), backend="grid")
    assert calls[0] == "knn_select_window" and len(calls) <= 2
    if len(calls) == 2:
        assert calls[1][0] == "knn_select_queries" and 0 < calls[1][1] < nbad
    _assert_exact(tn, coors, k, mask)
    # with the gate shut the same share goes to K8 directly
    calls.clear()
    monkeypatch.setattr(tnb, "_WINDOW_REPAIR_MIN_N", 16384)
    tn, _ = tnb.knn_select_gather(_t(coors), k, math.inf, mask=_t(mask), backend="grid")
    assert calls == [("knn_select_queries", nbad)]
    _assert_exact(tn, coors, k, mask)


def test_window_tier_matches_jax(monkeypatch):
    monkeypatch.setattr(jnb, "_WINDOW_REPAIR_MIN_N", 0)
    monkeypatch.setattr(tnb, "_WINDOW_REPAIR_MIN_N", 0)
    coors, _ = _cloud(0, 1, 4096)
    jn, jg, tn, tg = _grid_both(coors, 5, math.inf, None)
    _assert_same(jn, jg, tn, tg)


def test_arm_quarter_bucket(calls):
    """Between n/16 and n/4 failing rows: K8, whatever the window gate."""
    n, k = 4096, 8
    coors, _ = _cloud(0, 1, n)
    nbad = _failing_rows(coors, k)
    assert n // 16 < nbad <= n // 4
    tn, _ = tnb.knn_select_gather(_t(coors), k, math.inf, backend="grid")
    assert calls == [("knn_select_queries", nbad)]
    _assert_exact(tn, coors, k, None)


def test_arm_batch_pads_with_certified_rows(calls):
    """With b > 1 the repair takes the largest failing count of the batch;
    the cloud with fewer failing rows pads with certified ones, whose
    repair rewrites what they hold."""
    coors = np.concatenate([_cloud(21, 1, 1024, "uniform")[0], _cloud(22, 1, 1024)[0]])
    rows = (~ts.grid_knn_select(_t(coors), 8)[3]).sum(dim=1)
    assert rows[0] == 0 < rows[1]
    tn, _ = tnb.knn_select_gather(_t(coors), 8, math.inf, backend="grid")
    assert calls == [("knn_select_queries", int(rows[1]))]
    _assert_exact(tn, coors, 8, None)


@pytest.mark.parametrize("reach,expected", [
    (16384, ["knn_select"]),                                   # K3 within the reach
    (128, ["knn_candidates_packed_tiled"]),                    # K5 and the refine beyond it
])
def test_arm_whole_call_fallback(monkeypatch, calls, reach, expected):
    """More than n/4 failing rows (here: a needle box, no row certified)
    takes the compact exact selection ``auto`` gives without the grid."""
    monkeypatch.setattr(K, "FULL_BAND_MAX_N", reach)
    n, k = 1024, 8
    coors, mask = _cloud(9, 1, n, "uniform", 1.0, with_mask=True)
    coors = coors * np.asarray([100.0, 1.0, 0.01], np.float32)
    assert _failing_rows(coors, k, mask) > n // 4
    tn, _ = tnb.knn_select_gather(_t(coors), k, math.inf, mask=_t(mask), backend="grid",
                                  wide=True)
    assert calls == expected
    _assert_exact(tn, coors, k, mask)


def test_arm_fallback_to_k4_where_the_packed_gate_refuses(monkeypatch, calls):
    """n = 1100 pads to 1152 = 9 * 128, which the packed-tiled gate takes; a
    k beyond its 32 candidates does not."""
    monkeypatch.setattr(K, "FULL_BAND_MAX_N", 128)
    n, k = 1100, 40
    coors, _ = _cloud(9, 1, n, "uniform", 1.0)
    coors = coors * np.asarray([100.0, 1.0, 0.01], np.float32)
    tn, _ = tnb.knn_select_gather(_t(coors), k, math.inf, backend="grid")
    assert calls == ["knn_select_tiled"]
    _assert_exact(tn, coors, k, None)


def test_grid_backend_outside_its_conditions_takes_the_exact_route(calls):
    """An adjacency, c != 3 or n < 128: ``backend="grid"`` is the exact
    route, as in the JAX dispatcher."""
    coors, mask = _cloud(2, 1, 160, with_mask=True)
    adj = np.abs(np.arange(160)[:, None] - np.arange(160)[None, :]) == 1
    ev, ei = K.knn_select_plain(_t(coors), 8, _t(mask), _t(adj)[None])
    nbhd, _ = tnb.knn_select_gather(_t(coors), 8, math.inf, mask=_t(mask), adj_mat=_t(adj)[None],
                                    backend="grid")
    assert torch.equal(nbhd.indices, ei)
    flat = tnb.knn_select_gather(torch.zeros(1, 200, 2, dtype=torch.float32), 4, math.inf, backend="grid")[0]
    small = tnb.knn_select_gather(_t(coors[:, :100]), 4, math.inf, backend="grid")[0]
    assert flat.indices.shape == (1, 200, 4) and small.indices.shape == (1, 100, 4)
    assert calls == ["knn_select"] * 3


# ---------------------------------------------------------------------------
# auto, through the grid kernel's plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def lowered_gate(monkeypatch):
    """The grid kernel's gate at n >= 1024 in place of 8192: ``auto`` then
    takes the grid and K7 (gdim 4 at n = 1024), as it does at net65k's size."""
    monkeypatch.setattr(G, "_MIN_N", 1024)


@pytest.mark.parametrize("with_mask", [False, True])
def test_auto_takes_the_grid_under_a_lowered_gate(monkeypatch, lowered_gate, calls, with_mask):
    n, k = 1024, 8
    coors, mask = _cloud(15, 1, n, with_mask=with_mask)
    payload = np.random.RandomState(1).randn(1, n, 4).astype(np.float32)
    nbad = _failing_rows(coors, k, mask, kernel=True)
    assert 0 < nbad <= 128
    calls.clear()
    tn, tg = tnb.knn_select_gather(_t(coors), k, math.inf, mask=_t(mask), payload=_t(payload),
                                   wide=True)
    assert calls == ["grid_knn_cells", ("knn_select_queries", nbad)]
    _assert_exact(tn, coors, k, mask)
    assert tg.shape == (1, n, k, 3 + with_mask + 4)
    jn, jg = jnb.knn_select_gather(_j(coors), k, math.inf, mask=_j(mask), payload=_j(payload),
                                   backend="grid", interpret=True, wide=True)
    _assert_same(jn, jg, tn, tg)
    # GRID_AUTO off: the route auto took before
    calls.clear()
    monkeypatch.setattr(tnb, "GRID_AUTO", False)
    off, _ = tnb.knn_select_gather(_t(coors), k, math.inf, mask=_t(mask), payload=_t(payload))
    assert calls == ["knn_select_gather"] and torch.equal(off.indices, tn.indices)


def test_auto_takes_the_grid_at_8192(calls):
    """The reference's gate itself: n = 8192 without an adjacency is the
    grid's, with one it is not."""
    n, k = 8192, 4
    coors, _ = _cloud(4, 1, n, "uniform", 20.0)
    assert tnb.GRID_AUTO and G.supports_grid_knn(n, k) and not G.supports_grid_knn(n - 1, k)
    tn, _ = tnb.knn_select_gather(_t(coors), k, math.inf)
    assert calls[0] == "grid_knn_cells" and "knn_select" not in calls
    assert tn.winner is None and tn.indices.shape == (1, n, k)
    ev, ei = K.knn_select_plain(_t(coors), k, row_chunk=512)
    assert torch.equal(tn.indices, ei) and torch.equal(tn.ranking, ev)


def _forced_grid(monkeypatch):
    """The JAX layer calls ``knn_select_gather`` with ``auto``, which is the
    grid only on a TPU: force ``backend="grid"`` in interpret mode."""
    real = jnb.knn_select_gather

    def forced(coors, k, radius, mask=None, adj_mat=None, **kw):
        kw.update(backend="grid", interpret=True)
        return real(coors, k, radius, mask=mask, adj_mat=adj_mat, **kw)

    monkeypatch.setattr(jnb, "knn_select_gather", forced)


NETWORK_CASES = {
    # benchmarks/net65k.py at depth 2, dim 8, n 1024: features in, no tokens
    "net65k": dict(net={}, layer=dict(num_nearest_neighbors=16, **NET65K_LAYER), tokens=False,
                   mask=False),
    "tokens_mask_radius": dict(net=dict(num_tokens=21),
                               layer=dict(num_nearest_neighbors=8, valid_radius=4.0,
                                          m_pool_method="mean"), tokens=True, mask=True),
}


@pytest.mark.parametrize("case", sorted(NETWORK_CASES))
def test_network_on_the_grid_route_matches_jax(monkeypatch, lowered_gate, calls, case):
    spec = NETWORK_CASES[case]
    n, dim = 1024, 8
    _forced_grid(monkeypatch)
    coors, mask = _cloud(31, 2, n, scale=3.0, with_mask=spec["mask"])
    rng = np.random.RandomState(5)
    feats = (rng.randint(0, 21, size=(2, n)) if spec["tokens"]
             else rng.randn(2, n, dim).astype(np.float32))
    net_kw = dict(depth=2, dim=dim, layer_kwargs=dict(spec["layer"], init_eps=0.1), **spec["net"])
    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    params = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(0), _j(feats), _j(coors), mask=_j(mask))["params"])
    jf, jc = jnet.apply({"params": params}, _j(feats), _j(coors), mask=_j(mask))
    tnet = EGNNNetwork(**net_kw, device="cpu", dtype=torch.float32)
    load_flax_params(tnet, params)
    tf, tc = tnet(_t(feats), _t(coors), mask=_t(mask))
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    # K7 once a layer, k slots: the kc-slot path is not taken
    assert [c for c in calls if c == "grid_knn_cells"] == ["grid_knn_cells"] * 2
    assert "knn_candidates_packed_tiled" not in calls and "knn_select_gather" not in calls


def test_denoise_train_step_on_the_grid_route_matches_jax(monkeypatch, lowered_gate):
    """Three steps of the unchanged train step over the grid route: losses
    and final parameters at atol 1e-9 (float64 modules; both sides select in
    float32). The backward is ``gather_nodes``' segment sum over k slots."""
    n, dim = 1024, 8
    _forced_grid(monkeypatch)
    layer = dict(num_nearest_neighbors=8, init_eps=0.1, **NET65K_LAYER)
    net_kw = dict(depth=2, dim=dim, layer_kwargs=layer)
    rng = np.random.RandomState(33)
    feats = rng.randn(1, n, dim)
    clean = rng.randn(1, n, 3) * 10.0
    noised = clean + 0.3 * rng.randn(1, n, 3)
    jargs = (_j(feats), _j(noised), _j(clean), None, None)
    targs = (_t(feats), _t(noised), _t(clean), None, None)
    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    params = jnet.init(jax.random.PRNGKey(0), jargs[0], jargs[1])["params"]
    jstate = jtrain.TrainState.create(params, jtrain.make_fused_adam(1e-3))
    jstep = jtrain.make_denoise_train_step(jnet, donate=False)
    tnet = EGNNNetwork(**net_kw, device="cpu", dtype=torch.float64)
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    tstep = ttrain.make_denoise_train_step(tnet, ttrain.make_fused_adam(tnet.parameters(), 1e-3))
    for _ in range(3):
        jstate, jloss = jstep(jstate, *jargs)
        tloss = tstep(*targs)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=0, atol=1e-9)
    tparams = dict(tnet.named_parameters())
    for layer_name, leaves in jstate.params.items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(tparams[f"{layer_name}.{leaf}"].detach().numpy(),
                                       np.asarray(value), rtol=0, atol=1e-9,
                                       err_msg=f"{layer_name}.{leaf}")
