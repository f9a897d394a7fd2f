"""The port's core numerics and initialisers against ``egnn_tpu.ops.core``
and ``egnn_tpu.models.init``, in float64 (atol 1e-12)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops import core as jcore
from egnn_tpu_torch.models import init as tinit
from egnn_tpu_torch.ops import core as tcore

ATOL = 1e-12


def _rng(seed=0):
    return np.random.RandomState(seed)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def test_safe_div():
    num = _rng().randn(4, 5)
    den = np.abs(_rng(1).randn(4, 5))
    den[0, :2] = 0.0
    den[1, 0] = 1e-12
    _close(tcore.safe_div(torch.from_numpy(num), torch.from_numpy(den)),
           jcore.safe_div(jnp.asarray(num), jnp.asarray(den)))


@pytest.mark.parametrize("num_encodings,include_self", [(1, True), (3, True), (2, False)])
def test_fourier_encode_dist(num_encodings, include_self):
    x = np.abs(_rng().randn(2, 6, 5)) * 10
    _close(tcore.fourier_encode_dist(torch.from_numpy(x), num_encodings, include_self),
           jcore.fourier_encode_dist(jnp.asarray(x), num_encodings, include_self))


def test_batched_index_select_nodes_and_edges():
    rng = _rng()
    values = rng.randn(2, 9, 4)
    idx = rng.randint(0, 9, size=(2, 9, 3))
    _close(tcore.batched_index_select(torch.from_numpy(values), torch.from_numpy(idx), 1),
           jcore.batched_index_select(jnp.asarray(values), jnp.asarray(idx), 1))
    _close(tcore.gather_nodes(torch.from_numpy(values), torch.from_numpy(idx)),
           jcore.gather_nodes(jnp.asarray(values), jnp.asarray(idx)))
    edges = rng.randn(2, 9, 9, 5)  # the layer's axis=2 dense-edge gather
    _close(tcore.batched_index_select(torch.from_numpy(edges), torch.from_numpy(idx), 2),
           jcore.batched_index_select(jnp.asarray(edges), jnp.asarray(idx), 2))


def test_gather_bool():
    rng = _rng()
    mask = rng.rand(2, 9) > 0.4
    idx = rng.randint(0, 9, size=(2, 9, 3))
    np.testing.assert_array_equal(
        tcore.gather_bool(torch.from_numpy(mask), torch.from_numpy(idx)).numpy(),
        np.asarray(jcore.gather_bool(jnp.asarray(mask), jnp.asarray(idx))))


def test_coors_norm_with_zero_vectors():
    rel = _rng().randn(2, 5, 4, 3)
    rel[0, 0, 0] = 0.0  # the self pair
    scale = np.array([0.37])
    _close(tcore.coors_norm(torch.from_numpy(rel), torch.from_numpy(scale)),
           jcore.coors_norm(jnp.asarray(rel), jnp.asarray(scale)))


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(affine):
    rng = _rng()
    x = rng.randn(3, 7, 16) * 4 + 1
    gamma = rng.randn(16) if affine else None
    beta = rng.randn(16) if affine else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    _close(tcore.layer_norm(t(x), t(gamma), t(beta)), jcore.layer_norm(j(x), j(gamma), j(beta)))
    ref = torch.nn.functional.layer_norm(t(x), (16,), t(gamma), t(beta), eps=1e-5)
    _close(tcore.layer_norm(t(x), t(gamma), t(beta)), ref.numpy())


def test_initialisers_follow_the_jax_distributions():
    """Bits differ from JAX's; the distributions match: Normal(0, eps)
    weights, U(+-1/sqrt(fan_in)) biases, unit-normal embeddings, and the
    zero padding of tp_hidden_multiple."""
    gen = torch.Generator().manual_seed(0)
    w = tinit.normal_init(1e-3)((200, 300), gen)
    assert abs(w.std().item() - 1e-3) < 2e-5 and abs(w.mean().item()) < 2e-5
    bias = tinit.torch_linear_bias_init(64)((10000,), gen)
    assert bias.abs().max().item() <= 1 / 8 and bias.abs().max().item() > 0.124
    emb = tinit.unit_normal_init((300, 300), gen)
    assert abs(emb.std().item() - 1.0) < 0.01
    padded = tinit.zero_pad_axis(tinit.normal_init(1.0), 1, 5)((4, 8), gen)
    assert torch.all(padded[:, 5:] == 0) and torch.all(padded[:, :5] != 0)
    assert torch.all(tinit.constant_init(0.01)((1,), gen) == 0.01)
    same = tinit.normal_init(1.0)((3,), torch.Generator().manual_seed(4))
    assert torch.equal(same, tinit.normal_init(1.0)((3,), torch.Generator().manual_seed(4)))


def test_gather_nodes_grad_matches_jax():
    """gather_nodes' backward (a segment sum over the indices, K2's plain
    version here) against jax.grad through egnn_tpu's custom VJP, in
    float64 at atol 1e-10; the indices repeat, so rows collect several
    cotangents."""
    import jax

    rng = _rng(4)
    values = rng.randn(3, 11, 5)
    idx = rng.randint(0, 11, size=(3, 11, 4))
    w = rng.randn(3, 11, 4, 5)
    jg = jax.grad(lambda v: (jcore.gather_nodes(v, jnp.asarray(idx)) * jnp.asarray(w)).sum())(
        jnp.asarray(values))
    v = torch.from_numpy(values).requires_grad_()
    (tcore.gather_nodes(v, torch.from_numpy(idx)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-10)


def test_gather_nodes_gradcheck():
    rng = _rng(5)
    v = torch.from_numpy(rng.randn(2, 9, 4)).requires_grad_()
    idx = torch.from_numpy(rng.randint(0, 9, size=(2, 9, 3)))
    assert torch.autograd.gradcheck(lambda x: tcore.gather_nodes(x, idx), (v,))
