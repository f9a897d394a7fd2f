"""The port's global attention (``models/attention.py``) and the dense
network's ``global_linear_attn_every`` against the JAX package's, on the
CPU in float64: Flax parameters carried by ``load_flax_params``, the same
numpy inputs through both, outputs at 1e-9 and gradients at 1e-8 (float64
rounding in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
from egnn_tpu.models import attention as jatt
from egnn_tpu_torch import Attention, EGNNNetwork, GlobalLinearAttention
from egnn_tpu_torch.utils.port_weights import load_flax_params

F64 = dict(device="cpu", dtype=torch.float64)
DIM, HEADS, DIM_HEAD = 32, 2, 8


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _params(module, *args, **kwargs):
    variables = module.init(jax.random.PRNGKey(0), *args, **kwargs)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _close(t, j, tol=1e-9):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("mask", ["none", "ragged", "one_row_all_masked"])
def test_attention_matches_jax(mask):
    """Cross attention, queries (2, 4) over a context of 24; a batch element
    whose keys are all masked gets the uniform softmax of JAX's finite fill
    (``-inf`` would give NaN)."""
    rng = np.random.RandomState(1)
    x, context = rng.randn(2, 4, DIM), rng.randn(2, 24, DIM)
    m = None
    if mask != "none":
        m = np.arange(24)[None, :] < np.array([[24], [17]])
        if mask == "one_row_all_masked":
            m[1] = False
    jmod = jatt.Attention(DIM, HEADS, DIM_HEAD)
    params = _params(jmod, _j(x), _j(context), mask=_j(m))
    tmod = Attention(DIM, HEADS, DIM_HEAD, **F64)
    load_flax_params(tmod, params)
    out = tmod(_t(x), _t(context), mask=_t(m))
    assert torch.isfinite(out).all()
    _close(out, jmod.apply({"params": params}, _j(x), _j(context), mask=_j(m)))


def test_global_linear_attention_matches_jax():
    rng = np.random.RandomState(2)
    x, queries = rng.randn(2, 24, DIM), rng.randn(2, 4, DIM)
    m = np.arange(24)[None, :] < np.array([[24], [19]])
    jmod = jatt.GlobalLinearAttention(DIM, HEADS, DIM_HEAD)
    params = _params(jmod, _j(x), _j(queries), mask=_j(m))
    tmod = GlobalLinearAttention(DIM, HEADS, DIM_HEAD, **F64)
    load_flax_params(tmod, params)
    jx, jq = jmod.apply({"params": params}, _j(x), _j(queries), mask=_j(m))
    tx, tq = tmod(_t(x), _t(queries), mask=_t(m))
    _close(tx, jx)
    _close(tq, jq)


def _network_case(every):
    """tests/test_parity_reference.py:152-181's network: depth 3, dim 32,
    tokens, positions, adjacency degrees 2 with their embedding, global
    attention (2 heads of 8), kNN 6, clamp 2.0, CoorsNorm."""
    n = 24
    kw = dict(depth=3, dim=DIM, num_tokens=21, num_positions=n, num_adj_degrees=2, adj_dim=4,
              global_linear_attn_every=every, global_linear_attn_heads=HEADS,
              global_linear_attn_dim_head=DIM_HEAD,
              layer_kwargs=dict(num_nearest_neighbors=6, coor_weights_clamp_value=2.0,
                                norm_coors=True, init_eps=0.1))
    rng = np.random.RandomState(5 + every)
    tokens = rng.randint(0, 21, size=(2, n))
    coors = rng.randn(2, n, 3)
    ar = np.arange(n)
    adj = np.abs(ar[:, None] - ar[None, :]) == 1
    mask = ar[None, :] < np.array([[n], [n - 4]])
    return kw, tokens, coors, adj, mask


@pytest.mark.parametrize("every", [1, 2])
def test_network_with_global_attention_matches_jax(every):
    kw, tokens, coors, adj, mask = _network_case(every)
    jnet = egnn_tpu.EGNNNetwork(**kw)
    jkw = dict(adj_mat=_j(adj), mask=_j(mask))
    params = _params(jnet, _j(tokens), _j(coors), **jkw)
    assert "global_tokens" in params and "global_attn_0" in params
    tnet = EGNNNetwork(**kw, **F64)
    assert {name.split(".")[0] for name, _ in tnet.named_children()} == set(params) - {
        "token_emb", "pos_emb", "adj_emb", "global_tokens"}
    load_flax_params(tnet, params)

    def loss(f, c):
        return (f ** 2).mean() + (c ** 2).mean()

    def jloss(p):
        out = jnet.apply({"params": p}, _j(tokens), _j(coors), **jkw)
        return loss(*out), out

    (_, (jf, jc)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tf, tc = tnet(_t(tokens), _t(coors), adj_mat=_t(adj), mask=_t(mask))
    _close(tf, jf)
    _close(tc, jc)
    loss(tf, tc).backward()
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat[name], rtol=1e-8, atol=1e-10,
                                   err_msg=name)


def test_load_flax_params_of_an_attention_network():
    """The attention subtrees carry across by name; ``global_tokens`` is a
    lazy parameter: a tree without it leaves the port's own value, while a
    tree without an attention weight is refused."""
    kw, tokens, coors, adj, mask = _network_case(2)
    params = _params(egnn_tpu.EGNNNetwork(**kw), _j(tokens), _j(coors), adj_mat=_j(adj),
                     mask=_j(mask))
    tnet = EGNNNetwork(**kw, **F64)
    own = tnet.global_tokens.detach().clone()
    load_flax_params(tnet, {k: v for k, v in params.items() if k != "global_tokens"})
    assert torch.equal(tnet.global_tokens, own)
    np.testing.assert_array_equal(tnet.global_attn_2.attn1.to_q_w.detach().numpy(),
                                  params["global_attn_2"]["attn1"]["to_q_w"])
    assert not hasattr(tnet, "global_attn_1")
    load_flax_params(tnet, params)
    np.testing.assert_array_equal(tnet.global_tokens.detach().numpy(), params["global_tokens"])
    attn = dict(params["global_attn_0"], attn1={
        k: v for k, v in params["global_attn_0"]["attn1"].items() if k != "to_q_w"})
    with pytest.raises(KeyError, match="global_attn_0.attn1.to_q_w"):
        load_flax_params(tnet, {**params, "global_attn_0": attn})
