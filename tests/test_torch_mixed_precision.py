"""``compute_dtype=torch.bfloat16`` in the port, on the CPU: the four cases
of ``tests/test_mixed_precision.py`` (close to float32, equivariant at bf16
tolerance, finite gradients in the parameters' dtype, the sparse layer),
with the JAX package's weights and inputs, and the port's bf16 outputs
against JAX's bf16 outputs: both round the same message products to bf16,
in their own orders, so they agree to a few bf16 units of the outputs,
not bitwise (atol 2e-2; seen: 4.9e-4 on the dense layer, 1.1e-2 on the
sparse one, whose xavier-normal weights give outputs of order 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
from egnn_tpu.ops.graph import knn_graph as jax_knn_graph
from egnn_tpu.utils import rot
from egnn_tpu_torch import EGNN, EGNNSparse
from egnn_tpu_torch.utils.port_weights import load_flax_params

CPU = dict(device="cpu")
JAX_BF16_ATOL = 2e-2


def _case(n=64, d=32):
    """tests/test_mixed_precision.py:_case, as numpy float32."""
    feats = jax.random.normal(jax.random.PRNGKey(0), (1, n, d), jnp.float32)
    coors = jax.random.normal(jax.random.PRNGKey(1), (1, n, 3), jnp.float32)
    mask = jax.random.uniform(jax.random.PRNGKey(2), (1, n)) > 0.2
    return np.asarray(feats), np.asarray(coors), np.asarray(mask)


def _f32_params(module, key, *args, **kwargs):
    params = module.init(jax.random.PRNGKey(key), *args, **kwargs)["params"]
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _pair(kw, key, feats, coors, mask):
    """The JAX layer of ``kw`` with its float32 weights, and the port's f32
    and bf16 layers carrying them."""
    jlayer = egnn_tpu.EGNN(**kw, compute_dtype=jnp.bfloat16)
    params = _f32_params(jlayer, key, feats, coors, mask=mask)
    layers = []
    for cd in (None, torch.bfloat16):
        layer = EGNN(**kw, compute_dtype=cd, **CPU)
        load_flax_params(layer, params)
        layers.append(layer)
    return jlayer, params, layers


def _t(x):
    return torch.from_numpy(np.array(x))


def test_bf16_close_to_f32_and_to_jax():
    feats, coors, mask = _case()
    kw = dict(dim=32, num_nearest_neighbors=8, norm_coors=True)
    jlayer, params, (l32, lbf) = _pair(kw, 3, feats, coors, mask)
    f1, c1 = l32(_t(feats), _t(coors), mask=_t(mask))
    f2, c2 = lbf(_t(feats), _t(coors), mask=_t(mask))
    assert f2.dtype == torch.float32 and c2.dtype == torch.float32
    torch.testing.assert_close(f2, f1, rtol=0, atol=0.05)
    torch.testing.assert_close(c2, c1, rtol=0, atol=0.05)
    jf, jc = jlayer.apply({"params": params}, feats, coors, mask=mask)
    for t, j in ((f2, jf), (c2, jc)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j, np.float32), rtol=0,
                                   atol=JAX_BF16_ATOL)


def test_bf16_equivariance():
    feats, coors, mask = _case(d=16)
    layer = EGNN(dim=16, num_nearest_neighbors=6, norm_coors=True,
                 compute_dtype=torch.bfloat16, **CPU)
    r = torch.from_numpy(np.asarray(rot(0.3, -0.6, 1.2), np.float32))
    shift = torch.tensor([1.0, 2.0, -0.5], dtype=torch.float32)
    f1, c1 = layer(_t(feats), _t(coors), mask=_t(mask))
    f2, c2 = layer(_t(feats), _t(coors) @ r + shift, mask=_t(mask))
    # bf16 messages perturb the weights of the coordinate combination, not
    # its equivariant structure; float32 geometry keeps the motion tight
    torch.testing.assert_close(f2, f1, rtol=0, atol=2e-2)
    torch.testing.assert_close(c2, c1 @ r + shift, rtol=0, atol=2e-2)


@pytest.mark.parametrize("stream", [False, True])
def test_bf16_grads_finite(stream):
    """Gradients keep the parameters' float32 dtype and are finite, on the
    kNN layer and on the streamed all-pairs layer."""
    feats, coors, mask = _case(d=16)
    kw = dict(stream_pairwise=True, pairwise_chunk=16) if stream else dict(
        num_nearest_neighbors=6)
    layer = EGNN(dim=16, compute_dtype=torch.bfloat16, **kw, **CPU)
    f, c = layer(_t(feats), _t(coors), mask=_t(mask))
    ((f ** 2).mean() + (c ** 2).mean()).backward()
    for name, p in layer.named_parameters():
        assert p.grad.dtype == p.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name


def test_sparse_bf16_close_to_f32_and_to_jax():
    coors = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (40, 3), jnp.float32))
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (40, 8), jnp.float32))
    x = np.concatenate([coors, feats], -1)
    es = jax_knn_graph(jnp.asarray(coors), 4)
    ei, em = np.asarray(es.edge_index), np.asarray(es.mask)
    jlayer = egnn_tpu.EGNN_Sparse(feats_dim=8, norm_coors=True, compute_dtype=jnp.bfloat16)
    params = _f32_params(jlayer, 2, x, ei, edge_mask=em)
    outs = []
    for cd in (None, torch.bfloat16):
        layer = EGNNSparse(feats_dim=8, norm_coors=True, compute_dtype=cd, **CPU)
        load_flax_params(layer, params)
        outs.append(layer(_t(x), _t(ei), edge_mask=_t(em)))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0.05)
    jo = jlayer.apply({"params": params}, x, ei, edge_mask=em)
    np.testing.assert_allclose(outs[1].detach().numpy(), np.asarray(jo, np.float32), rtol=0,
                               atol=JAX_BF16_ATOL)
