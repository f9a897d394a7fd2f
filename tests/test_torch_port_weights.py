"""Weights of the reference torch package carried into the port
(``egnn_tpu_torch/utils/port_weights.py:*_params_from_torch``), against
``egnn_tpu.utils``'s converters. The reference package is no dependency of
the repo, so the tests build stand-ins with its attribute layout (``Linear`` at
``Sequential`` positions 0 and 3, (out, in) weights, ``LayerNorm`` or
``Identity`` norms, ``(gattn, egnn)`` layer pairs) from a seed: the JAX
converter's tree loaded by ``load_flax_params`` into port module A, the
port's converter's into port module B, and A and B hold bitwise equal
parameters and give bitwise equal outputs (float64)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from egnn_tpu import utils as ju
from egnn_tpu_torch import EGNN, EGNNNetwork, EGNNSparse, EGNNSparseNetwork
from egnn_tpu_torch.utils import port_weights as pw

F64 = dict(device="cpu", dtype=torch.float64)


class _Fill:
    """Random float64 values from one seed."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, *shape):
        return nn.Parameter(torch.randn(*shape, generator=self.gen, dtype=torch.float64))


def _linear(fill, d_in, d_out, bias=True):
    lin = nn.Linear(d_in, d_out, bias=bias, dtype=torch.float64)
    lin.weight = fill(d_out, d_in)
    if bias:
        lin.bias = fill(d_out)
    return lin


def _mlp(fill, params, prefix):
    if f"{prefix}_0_w" not in params:
        return None
    (i0, o0), (i1, o1) = params[f"{prefix}_0_w"].shape, params[f"{prefix}_1_w"].shape
    return nn.Sequential(_linear(fill, i0, o0), nn.Dropout(0.0), nn.SiLU(),
                         _linear(fill, i1, o1), nn.SiLU())


def _norm(fill, params, sparse):
    if "node_norm_gamma" not in params:
        return None if sparse else nn.Identity()
    ln = nn.LayerNorm(params["node_norm_gamma"].shape[0], dtype=torch.float64)
    ln.weight, ln.bias = fill(*ln.weight.shape), fill(*ln.bias.shape)
    return ln


def _layer_standin(fill, params, sparse):
    ns = SimpleNamespace(edge_mlp=_mlp(fill, params, "edge_mlp"),
                         coors_mlp=_mlp(fill, params, "coors_mlp"),
                         node_mlp=_mlp(fill, params, "node_mlp"),
                         node_norm=_norm(fill, params, sparse),
                         coors_norm=(SimpleNamespace(scale=fill(1))
                                     if "coors_norm_scale" in params else nn.Identity()))
    gate = "edge_weight" if sparse else "edge_gate"
    setattr(ns, gate, nn.Sequential(_linear(fill, params[f"{gate}_w"].shape[0], 1), nn.Sigmoid())
            if f"{gate}_w" in params else None)
    return ns


def _sub(params, prefix):
    return {k[len(prefix) + 1:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _attn(fill, d, inner):
    return SimpleNamespace(to_q=_linear(fill, d, inner, bias=False),
                           to_kv=_linear(fill, d, 2 * inner, bias=False),
                           to_out=_linear(fill, inner, d))


def _gattn_standin(fill, params):
    d = params["norm_seq_gamma"].shape[0]
    inner = params["attn1.to_q_w"].shape[1]
    ln = lambda: _norm(fill, {"node_norm_gamma": params["norm_seq_gamma"]}, False)  # noqa: E731
    hidden = params["ff_w1"].shape[1]
    return SimpleNamespace(norm_seq=ln(), norm_queries=ln(), attn1=_attn(fill, d, inner),
                           attn2=_attn(fill, d, inner),
                           ff=nn.Sequential(ln(), _linear(fill, d, hidden), nn.GELU(),
                                            _linear(fill, hidden, d)))


def _embedding(fill, shape):
    emb = nn.Embedding(*shape, dtype=torch.float64)
    emb.weight = fill(*shape)
    return emb


def _network_standin(fill, net):
    params = dict(net.named_parameters())
    ns = SimpleNamespace(**{name: (_embedding(fill, params[name].shape) if name in params else None)
                            for name in ("token_emb", "pos_emb", "edge_emb", "adj_emb")})
    ns.global_tokens = fill(*params["global_tokens"].shape) if "global_tokens" in params else None
    ns.layers = [(_gattn_standin(fill, _sub(params, f"global_attn_{i}"))
                  if f"global_attn_{i}.ff_w1" in params else None,
                  _layer_standin(fill, _sub(params, f"egnn_{i}"), sparse=False))
                 for i in range(net.depth)]
    return ns


def _sparse_network_standin(fill, net, n_layers):
    params = dict(net.named_parameters())

    def count(prefix):
        return sum(1 for k in params if k.startswith(prefix) and "." not in k)

    return SimpleNamespace(
        emb_layers=[_embedding(fill, params[f"emb_{i}"].shape) for i in range(count("emb_"))],
        edge_emb_layers=[_embedding(fill, params[f"edge_emb_{i}"].shape)
                         for i in range(count("edge_emb_"))],
        mpnn_layers=[_layer_standin(fill, _sub(params, f"mpnn_{i}"), sparse=True)
                     for i in range(n_layers)])


def _carry(make, standin, jax_convert, port_convert, run):
    a, b = make(), make()
    pw.load_flax_params(a, jax_convert(standin))
    pw.load_flax_params(b, port_convert(standin))
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
    with torch.no_grad():
        for x, y in zip(run(a), run(b)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(norm_feats=True, norm_coors=True, soft_edges=True),
    dict(update_coors=False, fourier_features=2),
    dict(update_feats=False, edge_dim=3),
], ids=["norms_soft", "no_coors_fourier", "no_feats_edges"])
def test_dense_layer(kw):
    make = lambda: EGNN(dim=8, num_nearest_neighbors=4, **kw, **F64)  # noqa: E731
    standin = _layer_standin(_Fill(0), dict(make().named_parameters()), sparse=False)
    rng = np.random.RandomState(1)
    feats, coors = torch.from_numpy(rng.randn(1, 9, 8)), torch.from_numpy(rng.randn(1, 9, 3))
    edges = torch.from_numpy(rng.randn(1, 9, 9, 3)) if kw.get("edge_dim") else None
    _carry(make, standin, ju.egnn_params_from_torch, pw.egnn_params_from_torch,
           lambda m: m(feats, coors, edges))


def test_sparse_layer():
    make = lambda: EGNNSparse(feats_dim=4, m_dim=8, soft_edge=1, norm_feats=True,  # noqa: E731
                              norm_coors=True, **F64)
    standin = _layer_standin(_Fill(2), dict(make().named_parameters()), sparse=True)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(6, 7))
    ei = torch.from_numpy(rng.randint(0, 6, (2, 14)))
    _carry(make, standin, ju.egnn_sparse_params_from_torch, pw.egnn_sparse_params_from_torch,
           lambda m: (m(x, ei),))


@pytest.mark.parametrize("attn_every", [0, 1], ids=["plain", "global_attention"])
def test_dense_network(attn_every):
    make = lambda: EGNNNetwork(  # noqa: E731
        depth=2, dim=8, num_tokens=5, num_positions=12, num_adj_degrees=2, adj_dim=2,
        global_linear_attn_every=attn_every, global_linear_attn_heads=2,
        global_linear_attn_dim_head=4, layer_kwargs=dict(num_nearest_neighbors=3,
                                                         norm_coors=True), **F64)
    standin = _network_standin(_Fill(4), make())
    rng = np.random.RandomState(5)
    tokens = torch.from_numpy(rng.randint(0, 5, (1, 12)))
    coors = torch.from_numpy(rng.randn(1, 12, 3))
    adj = torch.from_numpy(np.abs(np.arange(12)[:, None] - np.arange(12)[None]) == 1)
    _carry(make, standin, ju.egnn_network_params_from_torch, pw.egnn_network_params_from_torch,
           lambda m: m(tokens, coors, adj_mat=adj))


def test_sparse_network_and_its_refusal():
    make = lambda: EGNNSparseNetwork(  # noqa: E731
        n_layers=2, feats_dim=2, embedding_nums=[5], embedding_dims=[4], edge_attr_dim=1,
        edge_embedding_nums=[3], edge_embedding_dims=[2], **F64)
    standin = _sparse_network_standin(_Fill(6), make(), 2)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(np.concatenate([rng.randn(8, 4), rng.randint(0, 5, (8, 1))], axis=1))
    ei = torch.from_numpy(rng.randint(0, 8, (2, 20)))
    ea = torch.from_numpy(rng.randint(0, 3, (20, 1)).astype(np.float64))
    _carry(make, standin, ju.egnn_sparse_network_params_from_torch,
           pw.egnn_sparse_network_params_from_torch, lambda m: (m(x, ei, edge_attr=ea),))
    standin.mpnn_layers[1] = nn.ModuleList([nn.Identity()])
    for convert in (ju.egnn_sparse_network_params_from_torch,
                    pw.egnn_sparse_network_params_from_torch):
        with pytest.raises(ValueError, match="mpnn_layers\\[1\\]"):
            convert(standin)
