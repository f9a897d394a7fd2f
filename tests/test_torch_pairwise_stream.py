"""The port's streamed all-pairs path (``ops/pairwise_stream.py`` and the
layer's streamed branch) against the JAX package's, on the CPU in float64:
the same numpy inputs and weights through ``pairwise_block``,
``streamed_pairwise`` and the layer on both sides, at 1e-9 (outputs) and
1e-8 (gradients), over the option cases of ``tests/test_pairwise_stream.py``
with and without a mask; n = 40 in chunks of 16 leaves a padded last chunk.
The bfloat16 cases hold the port to its own float32 and to JAX's bfloat16."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
from egnn_tpu.ops import pairwise_stream as jps
from egnn_tpu.utils import rot
from egnn_tpu_torch import EGNN
from egnn_tpu_torch.ops import pairwise_stream as tps
from egnn_tpu_torch.utils.port_weights import load_flax_params

F64 = dict(device="cpu", dtype=torch.float64)
N, DIM, CHUNK = 40, 16, 16

CASES = [
    dict(),
    dict(fourier_features=2),
    dict(soft_edges=True),
    dict(norm_coors=True),
    dict(coor_weights_clamp_value=1.5),
    dict(m_pool_method="mean"),
    dict(update_coors=False),
    dict(update_feats=False),
    dict(norm_feats=True, fourier_features=4, soft_edges=True, norm_coors=True,
         coor_weights_clamp_value=2.0, m_pool_method="mean"),
]
# the options that the functions take; the rest belong to the layer
BLOCK_OPTS = ("fourier_features", "soft_edges", "norm_coors", "coor_weights_clamp_value",
              "update_coors", "update_feats")


def _inputs(seed, b=2, n=N, d=DIM, with_mask=True):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, n, d)
    coors = rng.randn(b, n, 3)
    mask = rng.uniform(size=(b, n)) > 0.2 if with_mask else None
    return feats, coors, mask


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _jax_layer(kw, feats, coors, mask):
    jlayer = egnn_tpu.EGNN(dim=feats.shape[-1], **kw)
    variables = jlayer.init(jax.random.PRNGKey(1), _j(feats), _j(coors), mask=_j(mask))
    return jlayer, jax.tree_util.tree_map(np.asarray, variables["params"])


def _layers(case, stream=True, chunk=CHUNK, feats=None, coors=None, mask=None):
    """The JAX layer with its Flax parameters (init_eps 0.1, so that the
    messages matter) and the port's layer carrying them."""
    kw = dict(case, init_eps=0.1, stream_pairwise=stream, pairwise_chunk=chunk)
    jlayer, params = _jax_layer(kw, feats, coors, mask)
    tlayer = EGNN(dim=feats.shape[-1], **kw, **F64)
    load_flax_params(tlayer, params)
    return jlayer, params, tlayer


def _pair_params(params, case, mod, conv):
    """PairwiseParams of either package from a layer's Flax parameters."""
    d = DIM
    dist_dim = 2 * case.get("fourier_features", 0) + 1
    soft, upd = case.get("soft_edges", False), case.get("update_coors", True)
    norm = case.get("norm_coors", False)
    return mod.PairwiseParams(
        w_d=conv(params["edge_mlp_0_w"][2 * d:2 * d + dist_dim]),
        edge_w2=conv(params["edge_mlp_1_w"]), edge_b2=conv(params["edge_mlp_1_b"]),
        gate_w=conv(params["edge_gate_w"]) if soft else None,
        gate_b=conv(params["edge_gate_b"]) if soft else None,
        coors_w1=conv(params["coors_mlp_0_w"]) if upd else None,
        coors_b1=conv(params["coors_mlp_0_b"]) if upd else None,
        coors_w2=conv(params["coors_mlp_1_w"]) if upd else None,
        coors_b2=conv(params["coors_mlp_1_b"]) if upd else None,
        cn_scale=conv(params["coors_norm_scale"]) if norm else None)


def _close(t, j, tol):
    if t is None or j is None:
        assert t is None and j is None
        return
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_stream_matches_jax(case, with_mask):
    feats, coors, mask = _inputs(zlib.crc32(repr((case, with_mask)).encode()),
                                 with_mask=with_mask)
    jlayer, params, tlayer = _layers(case, feats=feats, coors=coors, mask=mask)
    opts = {k: v for k, v in case.items() if k in BLOCK_OPTS}
    d = DIM
    w1 = params["edge_mlp_0_w"]
    proj_i = feats @ w1[:d] + params["edge_mlp_0_b"]
    proj_j = feats @ w1[d:2 * d]
    pv = None if mask is None else mask[:, :, None] & mask[:, None, :]

    jpp = _pair_params(params, case, jps, jnp.asarray)
    tpp = _pair_params(params, case, tps, torch.tensor)
    jb = jps.pairwise_block(_j(coors), _j(proj_i), _j(coors), _j(proj_j), _j(pv), jpp, **opts)
    tb = tps.pairwise_block(_t(coors), _t(proj_i), _t(coors), _t(proj_j), _t(pv), tpp, **opts)
    for t, j in zip(tb, jb):
        _close(t, j, 1e-9)
    jr = jps.streamed_pairwise(_j(coors), _j(proj_i), _j(proj_j), jpp, mask=_j(mask),
                               chunk=CHUNK, **opts)
    tr = tps.streamed_pairwise(_t(coors), _t(proj_i), _t(proj_j), tpp, mask=_t(mask),
                               chunk=CHUNK, **opts)
    for t, j in zip(tr, jr):
        _close(t, j, 1e-9)

    jf, jc = jlayer.apply({"params": params}, _j(feats), _j(coors), mask=_j(mask))
    tf, tc = tlayer(_t(feats), _t(coors), mask=_t(mask))
    _close(tf, jf, 1e-9)
    _close(tc, jc, 1e-9)


def _loss(f, c):
    return (f ** 2).mean() + (c ** 2).mean()


@pytest.mark.parametrize("with_mask", [True, False])
def test_stream_grads_match_jax(with_mask):
    """Gradients with respect to feats, coors and every weight, through the
    chunks' recompute (chunk 8: five chunks), against jax.grad."""
    case = CASES[-1]
    feats, coors, mask = _inputs(3, with_mask=with_mask)
    jlayer, params, tlayer = _layers(case, chunk=8, feats=feats, coors=coors, mask=mask)
    jg = jax.grad(lambda p, f, c: _loss(*jlayer.apply({"params": p}, f, c, mask=_j(mask))),
                  argnums=(0, 1, 2))(jax.tree_util.tree_map(jnp.asarray, params),
                                     _j(feats), _j(coors))
    tf, tc = _t(feats).requires_grad_(), _t(coors).requires_grad_()
    _loss(*tlayer(tf, tc, mask=_t(mask))).backward()
    _close(tf.grad, jg[1], 1e-8)
    _close(tc.grad, jg[2], 1e-8)
    for name, p in tlayer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[0][name]), rtol=1e-8,
                                   atol=1e-10, err_msg=name)


def test_auto_chunk_matches_jax():
    for b in (1, 2, 8):
        for n in (16, 100, 1024, 4096, 8192, 65536):
            for hidden in (18, 130, 258, 1026):
                assert tps._auto_chunk(b, n, hidden) == jps._auto_chunk(b, n, hidden), (
                    b, n, hidden)


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_stream_matches_the_materialised_layer(case):
    """The port's two all-pairs paths, outputs and every gradient."""
    feats, coors, mask = _inputs(11)
    outs = []
    for stream in (False, True):
        layer = EGNN(dim=DIM, init_eps=0.1, stream_pairwise=stream, pairwise_chunk=CHUNK,
                     generator=torch.Generator().manual_seed(2), **case, **F64)
        tf, tc = _t(feats).requires_grad_(), _t(coors).requires_grad_()
        f, c = layer(tf, tc, mask=_t(mask))
        _loss(f, c).backward()
        outs.append([f, c, tf.grad, tc.grad] + [p.grad for p in layer.parameters()])
    for a, b_ in zip(*outs):
        torch.testing.assert_close(b_, a, rtol=1e-9, atol=1e-10)


def test_n1024_takes_the_streamed_route(monkeypatch):
    """``EGNN(dim=...)`` without kNN streams from n = 1024 on, as the JAX
    layer does, and equals JAX's and the port's materialised layer."""
    feats, coors, mask = _inputs(5, b=1, n=1024, d=4)
    jlayer, params, tlayer = _layers({}, stream=None, chunk=None, feats=feats, coors=coors,
                                     mask=mask)
    calls = []
    real = tps.streamed_pairwise

    def spy(*args, **kwargs):
        calls.append(kwargs["chunk"])
        return real(*args, **kwargs)

    monkeypatch.setattr("egnn_tpu_torch.models.egnn.streamed_pairwise", spy)
    tf, tc = tlayer(_t(feats), _t(coors), mask=_t(mask))
    assert calls == [None]
    jf, jc = jax.jit(jlayer.apply)({"params": params}, _j(feats), _j(coors), mask=_j(mask))
    _close(tf, jf, 1e-9)
    _close(tc, jc, 1e-9)
    tlayer.stream_pairwise = False
    mf, mc = tlayer(_t(feats), _t(coors), mask=_t(mask))
    assert len(calls) == 1
    _close(tf, mf.detach().numpy(), 1e-9)
    _close(tc, mc.detach().numpy(), 1e-9)


def test_stream_equivariance():
    feats, coors, _ = _inputs(7, b=1, n=50, d=8, with_mask=False)
    layer = EGNN(dim=8, stream_pairwise=True, pairwise_chunk=16, norm_coors=True,
                 init_eps=0.1, **F64)
    r = torch.from_numpy(np.array(rot(0.2, 0.8, -0.4)))
    shift = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    f1, c1 = layer(_t(feats), _t(coors))
    f2, c2 = layer(_t(feats), _t(coors) @ r + shift)
    torch.testing.assert_close(f2, f1, rtol=0, atol=1e-8)
    torch.testing.assert_close(c2, c1 @ r + shift, rtol=0, atol=1e-8)


def _f32(x):
    return None if x is None else (x.astype(np.float32) if x.dtype.kind == "f" else x)


@pytest.mark.parametrize("with_mask", [True, False])
def test_stream_bf16(with_mask):
    """``compute_dtype=bfloat16`` on the streamed path: within 3e-2 of the
    materialised bf16 layer (the cast points are the same, the sums' order
    differs), coordinates within 0.1 of the float32 layer (tests/
    test_pairwise_stream.py:149-177), and within 3e-2 of JAX's streamed bf16
    layer (both round the same products to bf16, in their own orders)."""
    feats, coors, mask = _inputs(5, with_mask=with_mask)
    feats, coors = _f32(feats), _f32(coors)
    common = dict(fourier_features=2, norm_coors=True, coor_weights_clamp_value=2.0)
    jlayer, params = _jax_layer(dict(common, stream_pairwise=True, pairwise_chunk=CHUNK,
                                     compute_dtype=jnp.bfloat16), feats, coors, mask)
    params = jax.tree_util.tree_map(_f32, params)
    outs = {}
    for name, kw in (("stream", dict(stream_pairwise=True, compute_dtype=torch.bfloat16)),
                     ("materialised", dict(stream_pairwise=False,
                                           compute_dtype=torch.bfloat16)),
                     ("f32", dict(stream_pairwise=True))):
        layer = EGNN(dim=DIM, pairwise_chunk=CHUNK, **common, **kw, device="cpu")
        load_flax_params(layer, params)
        outs[name] = layer(_t(feats), _t(coors), mask=_t(mask))
    f, c = outs["stream"]
    assert f.dtype == torch.float32 and c.dtype == torch.float32
    for a, b_ in zip(outs["stream"], outs["materialised"]):
        torch.testing.assert_close(a, b_, rtol=0, atol=3e-2)
    assert (c - outs["f32"][1]).abs().max().item() < 0.1
    jf, jc = jlayer.apply({"params": params}, _j(feats), _j(coors), mask=_j(mask))
    for t, j in ((f, jf), (c, jc)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j, np.float32), rtol=0,
                                   atol=3e-2)


def test_stream_bf16_counts_and_sums_accumulate_f32():
    """With bf16 projections the cross-chunk sums stay float32: bf16 holds
    no odd integer above 256, so a pair count of 259 would drift."""
    b, n, hidden, m_dim = 1, 259, 8, 8
    g = torch.Generator().manual_seed(2)
    f32 = dict(generator=g, dtype=torch.float32)
    coors = torch.randn(b, n, 3, **f32)
    proj_i = torch.randn(b, n, hidden, **f32).to(torch.bfloat16)
    proj_j = torch.randn(b, n, hidden, **f32).to(torch.bfloat16)

    def w(*s):
        return torch.randn(*s, **f32) * 0.1

    pp = tps.PairwiseParams(w_d=w(1, hidden), edge_w2=w(hidden, m_dim), edge_b2=w(m_dim),
                            gate_w=None, gate_b=None, coors_w1=w(m_dim, m_dim),
                            coors_b1=w(m_dim), coors_w2=w(m_dim, 1), coors_b2=w(1),
                            cn_scale=None)
    res = tps.streamed_pairwise(coors, proj_i, proj_j, pp, mask=torch.ones(b, n, dtype=bool),
                                chunk=64, compute_dtype=torch.bfloat16)
    assert res.pair_count.dtype == torch.float32 and res.m_i.dtype == torch.float32
    assert torch.equal(res.pair_count, torch.full((b, n), float(n), dtype=torch.float32))
