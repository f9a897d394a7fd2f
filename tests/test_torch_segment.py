"""The port's segment sum (kernel K2's plain version, ``ops/segment.py`` and
its backward) against the JAX package.

On the CPU the port runs K2's plain version, which ``chip_smoke.py`` holds
the CUDA kernel against on the card. Here it meets the TPU kernel itself in
Pallas interpret mode in float32 at rtol = atol = 1e-4 (the TPU kernel sums
a bf16 hi+lo split of the data, ~1e-5 off, as tests/test_pallas_segment.py
states), and ``jax.ops.segment_sum`` in float64 at atol 1e-12. The backward
is the JAX VJP's gather, index quirk included: -1 reads the last segment,
an id >= S reads segment S - 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops import segment as jseg
from egnn_tpu.ops.pallas.segment import segment_sum_pallas
from egnn_tpu_torch.ops import segment as tseg
from egnn_tpu_torch.ops.cuda import build
from egnn_tpu_torch.ops.cuda import segment as SK


def _ids(rng, shape, n, pad=True):
    """Unsorted ids in [0, n), with -1 padding and ids >= n when ``pad``."""
    ids = rng.randint(0, n, size=shape)
    if pad:
        ids[..., ::9] = -1
        ids[..., 4::13] = n + 3
    return ids


@pytest.mark.parametrize("e,n,d", [(100, 16, 8), (1024, 64, 16), (777, 33, 5)])
def test_plain_matches_pallas_float32(e, n, d):
    rng = np.random.RandomState(e)
    data = rng.randn(e, d).astype(np.float32)
    ids = _ids(rng, (e,), n).astype(np.int32)
    out = segment_sum_pallas(jnp.asarray(data), jnp.asarray(ids), n, True)
    t = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n)
    assert t.dtype == torch.float32 and t.shape == (n, d)
    np.testing.assert_allclose(t.numpy(), np.asarray(out), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(300,), (300, 7), (300, 2, 3)])
def test_plain_matches_jax_float64(shape):
    rng = np.random.RandomState(len(shape))
    data = rng.randn(*shape)
    ids = _ids(rng, (shape[0],), 20)
    mask = rng.rand(shape[0]) > 0.3
    ref = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=20)
    out = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 20)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)
    if len(shape) > 2:  # the edge mask takes (E,) and (E, d) data
        return
    ref = jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 20, mask=jnp.asarray(mask))
    out = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 20,
                           mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("b,e,n,d", [(4, 512, 64, 16), (3, 100, 16, 5), (1, 200, 32, 9)])
def test_batched_matches_jax(b, e, n, d):
    rng = np.random.RandomState(b * 1000 + e)
    data = rng.randn(b, e, d).astype(np.float32)
    ids = rng.randint(0, n, size=(b, e)).astype(np.int32)
    ids[:, -3:] = -1  # padded edges contribute nothing
    ref = jseg.batched_segment_sum(jnp.asarray(data), jnp.asarray(ids), n, interpret=True)
    out = tseg.batched_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n)
    assert out.shape == (b, n, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_empty_segments_and_hub():
    data = torch.ones(8, 4, dtype=torch.float32)
    out = tseg.segment_sum(data, torch.zeros(8, dtype=torch.int64), 5)
    assert torch.all(out[0] == 8.0) and torch.all(out[1:] == 0.0)
    none = tseg.batched_segment_sum(torch.ones(2, 0, 3, dtype=torch.float32),
                                    torch.zeros(2, 0, dtype=torch.int64), 4)
    assert none.shape == (2, 4, 3) and torch.all(none == 0)


def test_plain_adds_in_ascending_edge_order():
    """The plain version's order is the kernel's: each segment summed from
    0.0 in ascending edge order, which fixes its f32 rounding."""
    rng = np.random.RandomState(5)
    data = (rng.randn(2, 400, 3) * 10.0 ** rng.randint(-4, 5, size=(2, 400, 1))).astype(
        np.float32)
    ids = _ids(rng, (2, 400), 11)
    out = SK.segment_sum_plain(torch.from_numpy(data), torch.from_numpy(ids), 11)
    ref = np.zeros((2, 11, 3), np.float32)
    for g in range(2):
        for e in range(400):
            if 0 <= ids[g, e] < 11:
                ref[g, ids[g, e]] += data[g, e]
    np.testing.assert_array_equal(out.numpy(), ref)


def test_grad_matches_pallas_vjp_with_index_quirk():
    """-1 wraps to the last segment and ids >= S clamp to S - 1, as the
    gather in segment_sum_pallas's VJP reads them."""
    rng = np.random.RandomState(0)
    s = 10
    data = rng.randn(50, 6).astype(np.float32)
    ids = _ids(rng, (50,), s)
    ids[:3] = [-1, s, 2 * s]
    w = rng.randn(s, 6).astype(np.float32)
    jg = jax.grad(lambda x: (segment_sum_pallas(x, jnp.asarray(ids, jnp.int32), s, True)
                             * jnp.asarray(w)).sum())(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    (tseg.segment_sum(x, torch.from_numpy(ids), s) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(x.grad.numpy()[:3], w[[s - 1, s - 1, s - 1]])


def test_batched_grad_matches_jax():
    rng = np.random.RandomState(1)
    b, e, n, d = 3, 120, 16, 5
    data = rng.randn(b, e, d).astype(np.float32)
    ids = _ids(rng, (b, e), n).astype(np.int32)
    w = rng.randn(b, n, d).astype(np.float32)
    jg = jax.grad(lambda x: (jseg.batched_segment_sum(x, jnp.asarray(ids), n, interpret=True)
                             * jnp.asarray(w)).sum())(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    (tseg.batched_segment_sum(x, torch.from_numpy(ids), n) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("batched", [False, True])
def test_gradcheck_float64(batched):
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(0, 7, size=(2, 30)))
    x = torch.from_numpy(rng.randn(2, 30, 3)).requires_grad_()
    if batched:
        fn = lambda x: tseg.batched_segment_sum(x, ids, 7)  # noqa: E731
    else:
        fn = lambda x: tseg.segment_sum(x[0], ids[0], 7, mask=ids[0] != 3)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))


def test_cpu_forward_and_backward_never_build(monkeypatch):
    """segment_sum, gather_nodes and knn_select_gather run their plain
    versions on the CPU, forward and backward, and never invoke nvcc."""
    import math

    from egnn_tpu_torch.ops import core, neighbors

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not invoke nvcc")

    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "library", refuse)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(40, 4).astype(np.float32)).requires_grad_()
    tseg.segment_sum(x, torch.from_numpy(rng.randint(0, 9, size=40)), 9).sum().backward()
    v = torch.from_numpy(rng.randn(2, 12, 4).astype(np.float32)).requires_grad_()
    core.gather_nodes(v, torch.from_numpy(rng.randint(0, 12, size=(2, 12, 3)))).sum().backward()
    c = torch.from_numpy(rng.randn(2, 12, 3).astype(np.float32)).requires_grad_()
    _, rows = neighbors.knn_select_gather(c, 4, math.inf, mask=torch.ones(2, 12, dtype=torch.bool),
                                          payload=v)
    rows.sum().backward()
    assert x.grad is not None and v.grad is not None and c.grad is not None


def test_cuda_wrapper_checks_inputs():
    """The kernel wrapper validates before it builds: a bad dtype or shape
    raises ValueError on any device, here on CPU tensors it is handed."""
    data = torch.zeros(1, 5, 2, dtype=torch.float64)
    ids = torch.zeros(1, 5, dtype=torch.int64)
    with pytest.raises(ValueError, match="float32"):
        SK._launch_segment_sum(data, ids, 3)
    with pytest.raises(ValueError, match="ids"):
        SK._launch_segment_sum(data.float(), ids.reshape(5, 1), 3)
    with pytest.raises(ValueError, match="S="):
        SK._launch_segment_sum(data.float(), ids, 0)
