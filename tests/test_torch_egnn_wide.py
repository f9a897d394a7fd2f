"""The port's EGNN layer and EGNN_Network on the large-n selection routes
against the JAX package's, on the CPU in float32.

The JAX layer always calls ``knn_select_gather(..., wide=True)`` with
``backend="auto"``, which reaches the packed-tiled and tiled kernels only on
a TPU; here that call is wrapped to force ``backend="packed_tiled"`` (or
``"tiled"`` with an adjacency) in Pallas interpret mode. The port takes the
same routes through ``auto`` with its full-band reach lowered below n.
Weights are carried across by ``load_flax_params``; outputs agree at atol
1e-5: the inputs, the selection and the candidates' re-rank are float32 on
both sides, the port's matmuls round in float32, and the values reach a few
units.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
from egnn_tpu.ops import neighbors as jnb
from egnn_tpu_torch import EGNN, EGNNNetwork
from egnn_tpu_torch.ops import neighbors as tnb
from egnn_tpu_torch.ops.cuda import knn as K
from egnn_tpu_torch.utils.port_weights import load_flax_params

ATOL = 1e-5
F32 = dict(device="cpu", dtype=torch.float32)
# benchmarks/net65k.py's layer options
NET65K_LAYER = dict(norm_coors=True, coor_weights_clamp_value=2.0)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def _inputs(seed, b, n, dim, with_mask, with_adj, edge_dim=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, n, dim).astype(np.float32)
    coors = (rng.rand(b, n, 3) * 6.0).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.arange(n)[None, :] < rng.randint(int(0.6 * n), n + 1, size=(b, 1))
    adj = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1 if with_adj else None
    edges = rng.randn(b, n, n, edge_dim).astype(np.float32) if edge_dim else None
    return feats, coors, mask, adj, edges


@pytest.fixture
def large_n_routes(monkeypatch):
    """Force the JAX dispatcher onto the large-n kernels (interpret mode) and
    lower the port's full-band reach; returns the slot counts both report."""
    real = jnb.knn_select_gather
    seen = {"jax": [], "torch": []}

    def forced(coors, k, radius, mask=None, adj_mat=None, **kw):
        kw.update(backend="tiled" if adj_mat is not None else "packed_tiled", interpret=True)
        out = real(coors, k, radius, mask=mask, adj_mat=adj_mat, **kw)
        seen["jax"].append((out[0].indices.shape[-1], out[0].winner is not None))
        return out

    treal = tnb.knn_select_gather

    def watched(*a, **kw):
        out = treal(*a, **kw)
        seen["torch"].append((out[0].indices.shape[-1], out[0].winner is not None))
        return out

    monkeypatch.setattr(jnb, "knn_select_gather", forced)
    monkeypatch.setattr(tnb, "knn_select_gather", watched)
    monkeypatch.setattr(K, "FULL_BAND_MAX_N", 128)
    return seen


LAYER_CASES = {
    # the net65k layer: no mask, no adjacency, kc = k + 4 slots under the winner mask
    "net65k": dict(kw=dict(num_nearest_neighbors=8, **NET65K_LAYER), mask=False),
    "mask_mean_soft_fourier_radius": dict(
        kw=dict(num_nearest_neighbors=8, m_pool_method="mean", soft_edges=True,
                fourier_features=2, valid_radius=1.5), mask=True),
    # without a mask the mean's divisor is the winner count, k
    "no_mask_mean": dict(kw=dict(num_nearest_neighbors=6, m_pool_method="mean"), mask=False),
    "dense_edges": dict(kw=dict(num_nearest_neighbors=8, edge_dim=4), mask=True, edge_dim=4),
    # with an adjacency the exact tiled kernel (K4): k slots, no winner mask
    "mask_adj_tiled": dict(kw=dict(num_nearest_neighbors=8, norm_feats=True, **NET65K_LAYER),
                           mask=True, adj=True),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_on_large_n_routes_matches_jax(case, large_n_routes):
    spec = LAYER_CASES[case]
    kw = dict(spec["kw"], init_eps=0.1)
    dim, n = 16, 256
    feats, coors, mask, adj, edges = _inputs(
        zlib.crc32(case.encode()), 2, n, dim, spec["mask"], spec.get("adj", False),
        spec.get("edge_dim", 0))
    jlayer = egnn_tpu.EGNN(dim=dim, **kw)
    jargs = (_j(feats), _j(coors), _j(edges), _j(mask), _j(adj))
    params = jax.tree_util.tree_map(
        np.asarray, jlayer.init(jax.random.PRNGKey(0), *jargs)["params"])
    large_n_routes["jax"].clear()
    jf, jc = jlayer.apply({"params": params}, *jargs)

    tlayer = EGNN(dim=dim, **kw, **F32)
    load_flax_params(tlayer, params)
    tf, tc = tlayer(_t(feats), _t(coors), _t(edges), _t(mask), _t(adj))
    _close(tf, jf)
    _close(tc, jc)
    k = kw["num_nearest_neighbors"]
    slots = (k, False) if spec.get("adj") else (k + tnb.CANDIDATE_SLACK, True)
    assert large_n_routes["torch"] == [slots] and large_n_routes["jax"] == [slots]


NETWORK_CASES = {
    # benchmarks/net65k.py at depth 2, dim 16, n 256: features in, no tokens
    "net65k": dict(net={}, layer=dict(num_nearest_neighbors=16, **NET65K_LAYER), tokens=False,
                   mask=False, adj=False),
    # the anchor-3 family beyond the reach: tokens, positions, mask, chain adjacency
    "anchor_tiled": dict(net=dict(num_tokens=21, num_positions=256),
                         layer=dict(num_nearest_neighbors=8, **NET65K_LAYER), tokens=True,
                         mask=True, adj=True),
    "tokens_mask_packed": dict(net=dict(num_tokens=21),
                               layer=dict(num_nearest_neighbors=8, valid_radius=2.0),
                               tokens=True, mask=True, adj=False),
}


def _network(case):
    spec = NETWORK_CASES[case]
    n, dim = 256, 16
    layer = dict(spec["layer"], init_eps=0.1)
    feats, coors, mask, adj, _ = _inputs(zlib.crc32(case.encode()), 2, n, dim, spec["mask"],
                                         spec["adj"])
    if spec["tokens"]:
        feats = np.random.RandomState(5).randint(0, 21, size=(2, n))
    net_kw = dict(depth=2, dim=dim, layer_kwargs=layer, **spec["net"])
    return net_kw, feats, coors, mask, adj


@pytest.mark.parametrize("case", sorted(NETWORK_CASES))
def test_network_on_large_n_routes_matches_jax(case, large_n_routes):
    net_kw, feats, coors, mask, adj = _network(case)
    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    jkw = dict(adj_mat=_j(adj), mask=_j(mask))
    params = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(0), _j(feats), _j(coors), **jkw)["params"])
    jf, jc = jnet.apply({"params": params}, _j(feats), _j(coors), **jkw)
    tnet = EGNNNetwork(**net_kw, **F32)
    load_flax_params(tnet, params)
    tf, tc = tnet(_t(feats), _t(coors), adj_mat=_t(adj), mask=_t(mask))
    _close(tf, jf)
    _close(tc, jc)
    wide = adj is None
    assert all(w == wide for _, w in large_n_routes["torch"])
    assert len(large_n_routes["torch"]) == 2


def test_load_flax_params_carries_the_net65k_network():
    """The net65k network has no token embedding; every Flax parameter finds
    its torch parameter and nothing is left over."""
    layer = dict(num_nearest_neighbors=16, **NET65K_LAYER)
    jnet = egnn_tpu.EGNNNetwork(depth=3, dim=32, layer_kwargs=layer)
    feats, coors = jnp.zeros((1, 64, 32), jnp.float32), jnp.ones((1, 64, 3), jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(3), feats, coors)["params"])
    tnet = EGNNNetwork(depth=3, dim=32, layer_kwargs=layer, **F32)
    load_flax_params(tnet, params)
    own = dict(tnet.named_parameters())
    assert "token_emb" not in own
    assert len(own) == sum(len(leaves) for leaves in params.values())
    for name, p in own.items():
        layer_name, leaf = name.split(".")
        np.testing.assert_array_equal(p.detach().numpy(),
                                      params[layer_name][leaf].astype(np.float32))


@pytest.mark.parametrize("with_mask", [False, True])
def test_wide_network_equivariance(monkeypatch, with_mask):
    """The kc-slot path is E(3)-equivariant like the k-slot one (float64
    module; the selection ranks in float32 on both sides of the rotation)."""
    monkeypatch.setattr(K, "FULL_BAND_MAX_N", 128)
    n = 256
    net = EGNNNetwork(depth=2, dim=16, layer_kwargs=dict(num_nearest_neighbors=8, init_eps=0.1,
                                                         **NET65K_LAYER),
                      device="cpu", dtype=torch.float64,
                      generator=torch.Generator().manual_seed(3))
    feats, coors, mask, _, _ = _inputs(8, 2, n, 16, with_mask, False)
    feats, coors = _t(feats).double(), _t(coors).double()
    q, _ = torch.linalg.qr(torch.randn(3, 3, dtype=torch.float64,
                                       generator=torch.Generator().manual_seed(2)))
    shift = torch.tensor([0.3, -1.2, 2.0], dtype=torch.float64)
    f0, c0 = net(feats, coors, mask=_t(mask))
    f1, c1 = net(feats, coors @ q + shift, mask=_t(mask))
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-9)
    torch.testing.assert_close(c1, c0 @ q + shift, rtol=0, atol=1e-9)


def test_wide_layer_equals_the_compact_layer(monkeypatch):
    """kc slots under the winner mask and the exact k slots are the same
    layer: the slack slots add nothing."""
    n = 256
    layer = EGNN(dim=16, num_nearest_neighbors=8, init_eps=0.1, m_pool_method="mean",
                 device="cpu", dtype=torch.float64, generator=torch.Generator().manual_seed(1),
                 **NET65K_LAYER)
    feats, coors, _, _, _ = _inputs(9, 2, n, 16, False, False)
    feats, coors = _t(feats).double(), _t(coors).double()
    f_exact, c_exact = layer(feats, coors)              # within the reach: K1's route
    monkeypatch.setattr(K, "FULL_BAND_MAX_N", 128)
    f_wide, c_wide = layer(feats, coors)                # beyond it: K5 and the refine
    torch.testing.assert_close(f_wide, f_exact, rtol=0, atol=1e-12)
    torch.testing.assert_close(c_wide, c_exact, rtol=0, atol=1e-12)
