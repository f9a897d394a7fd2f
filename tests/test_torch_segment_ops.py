"""The sparse path's segment reductions and row gathers of the port
(``egnn_tpu_torch/ops/segment.py``, ``ops/core.py``) against ``egnn_tpu``'s
on the CPU, where K2's plain version runs.

Inputs are numpy draws from a seed, in float64 on both sides. Outputs and
the gradients of a random cotangent agree at atol 1e-9 (the sums run in
other orders; everything else is the same arithmetic). Masks and empty
segments are in every case. ``max`` data and ``segment_softmax`` logits are
drawn from a few integers, so that maxima tie: the port splits the gradient
among tied maxima evenly, as JAX's ``segment_max`` and ``max`` do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops import core as jcore
from egnn_tpu.ops import segment as jseg
from egnn_tpu_torch.ops import core as tcore
from egnn_tpu_torch.ops import segment as tseg

ATOL = 1e-9
S = 7   # segments; ids leave segments 5 and 6 empty


def _ids(rng, e):
    return np.sort(rng.randint(0, 5, size=e))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def _vjp_both(t_fn, j_fn, arrays, cot):
    """Outputs and the gradients of <out, cot> wrt each array, both sides."""
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out_t = t_fn(*leaves)
    grads_t = torch.autograd.grad(out_t, leaves, torch.from_numpy(cot))
    out_j, vjp = jax.vjp(j_fn, *[jnp.asarray(a) for a in arrays])
    grads_j = vjp(jnp.asarray(cot))
    return out_t, out_j, grads_t, grads_j


def _check(t_fn, j_fn, arrays, seed=9):
    rng = np.random.RandomState(seed)
    out_j = j_fn(*[jnp.asarray(a) for a in arrays])
    cot = rng.randn(*np.shape(out_j))
    out_t, out_j, grads_t, grads_j = _vjp_both(t_fn, j_fn, arrays, cot)
    _close(out_t, out_j)
    for gt, gj in zip(grads_t, grads_j):
        _close(gt, gj)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("width", [0, 3], ids=["1d", "2d"])
def test_segment_count_and_mean(masked, width):
    rng = np.random.RandomState(1)
    e = 40
    ids = _ids(rng, e)
    mask = rng.rand(e) > 0.3 if masked else None
    data = rng.randn(e, width) if width else rng.randn(e)
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    cnt_t = tseg.segment_count(torch.from_numpy(ids), S, tm, dtype=torch.float64)
    cnt_j = jseg.segment_count(jnp.asarray(ids), S, jm, dtype=jnp.float64)
    _close(cnt_t, cnt_j, atol=0)
    _check(lambda d: tseg.segment_mean(d, torch.from_numpy(ids), S, tm),
           lambda d: jseg.segment_mean(d, jnp.asarray(ids), S, jm), [data])


@pytest.mark.parametrize("aggr", ["add", "sum", "mean", "max"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_segment_aggregate(aggr, masked):
    rng = np.random.RandomState(2)
    e = 48
    ids = _ids(rng, e)
    mask = rng.rand(e) > 0.3 if masked else None
    # a few integers: tied maxima in every segment
    data = rng.randint(-2, 3, size=(e, 4)).astype(np.float64)
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    _check(lambda d: tseg.segment_aggregate(aggr, d, torch.from_numpy(ids), S, tm),
           lambda d: jseg.segment_aggregate(aggr, d, jnp.asarray(ids), S, jm), [data])


def test_segment_max_splits_the_gradient_among_ties():
    data = torch.tensor([1.0, 3.0, 3.0, 3.0, 2.0, -1.0], dtype=torch.float64, requires_grad=True)
    ids = torch.tensor([0, 0, 0, 0, 1, 1])
    out = tseg.segment_max(data, ids, 3)
    (g,) = torch.autograd.grad(out, data, torch.tensor([3.0, 1.0, 5.0], dtype=torch.float64))
    assert out.tolist() == [3.0, 2.0, 0.0]   # the empty segment gives 0
    assert g.tolist() == [0.0, 1.0, 1.0, 1.0, 1.0, 0.0]
    gj = jax.grad(lambda d: (jseg.segment_max(d, jnp.asarray(ids.numpy()), 3)
                             * jnp.asarray([3.0, 1.0, 5.0])).sum())(
        jnp.asarray(data.detach().numpy()))
    _close(g, gj, atol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("ties", [False, True], ids=["spread", "ties"])
def test_segment_softmax(masked, ties):
    rng = np.random.RandomState(3)
    e, w = 36, 5
    ids = _ids(rng, e)
    logits = rng.randint(-1, 2, size=(e, w)).astype(np.float64) if ties else 3 * rng.randn(e, w)
    mask = (rng.rand(e, w) > 0.3) if masked else None
    if masked:
        mask[ids == 4] = False   # a segment whose every entry is masked
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    _check(lambda lg: tseg.segment_softmax(lg, torch.from_numpy(ids), S, tm),
           lambda lg: jseg.segment_softmax(lg, jnp.asarray(ids), S, jm), [logits])


@pytest.mark.parametrize("uniform", [False, True], ids=["segments", "uniform_size"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
def test_graph_layer_norm(uniform, masked, affine):
    rng = np.random.RandomState(4)
    g, s, d = 4, 6, 5
    n = g * s
    batch = np.repeat(np.arange(g), s)
    x = rng.randn(n, d) * 2.0 + 0.5
    mask = rng.rand(n) > 0.3 if masked else None
    if masked:
        mask[s:2 * s] = False   # a graph with no valid node
    gamma, beta = (rng.randn(d), rng.randn(d)) if affine else (None, None)
    us = s if uniform else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    arrays = [x] + ([gamma, beta] if affine else [])

    def t_fn(xx, *gb):
        return tseg.graph_layer_norm(xx, torch.from_numpy(batch), g, *(gb or (None, None)),
                                     node_mask=tm, uniform_size=us)

    def j_fn(xx, *gb):
        return jseg.graph_layer_norm(xx, jnp.asarray(batch), g, *(gb or (None, None)),
                                     node_mask=jm, uniform_size=us)

    _check(t_fn, j_fn, arrays)


def test_graph_layer_norm_without_batch_is_one_graph():
    rng = np.random.RandomState(5)
    x = rng.randn(9, 4)
    _check(lambda xx: tseg.graph_layer_norm(xx, None, 3, None, None),
           lambda xx: jseg.graph_layer_norm(xx, None, 3, None, None), [x])


@pytest.mark.parametrize("aggr", ["add", "sum", "mean", "max"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_uniform_aggregate(aggr, masked):
    rng = np.random.RandomState(6)
    n, k = 9, 4
    data = rng.randint(-2, 3, size=(n * k, 3)).astype(np.float64)
    mask = rng.rand(n * k) > 0.3 if masked else None
    if masked:
        mask[:k] = False   # a receiver with no valid edge
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    _check(lambda dd: tseg.uniform_aggregate(aggr, dd, k, tm),
           lambda dd: jseg.uniform_aggregate(aggr, dd, k, jm), [data])
    # the same as the segment form over repeat(arange(n), k)
    ids = torch.arange(n).repeat_interleave(k)
    _close(tseg.uniform_aggregate(aggr, torch.from_numpy(data), k, tm),
           tseg.segment_aggregate(aggr, torch.from_numpy(data), ids, n, tm).numpy())


def test_unported_and_unknown_options_raise():
    x = torch.zeros(4, 2, dtype=torch.float64)
    ids = torch.zeros(4, dtype=torch.int64)
    # axis_name takes a process group (tests/test_torch_sparse_partition.py
    # runs it); the JAX package's axis names raise
    with pytest.raises(TypeError, match="axis_name takes a torch.distributed process group"):
        tseg.segment_softmax(x, ids, 1, axis_name="nodes")
    with pytest.raises(TypeError, match="axis_name takes a torch.distributed process group"):
        tseg.graph_layer_norm(x, ids, 1, None, None, axis_name="nodes")
    with pytest.raises(ValueError, match="unknown aggr"):
        tseg.segment_aggregate("min", x, ids, 1)
    with pytest.raises(ValueError, match="unknown aggr"):
        tseg.uniform_aggregate("min", x, 2)


# ---------------------------------------------------------------------------
# the row gathers, whose backward is the segment sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trailing", [(), (5,), (2, 3)], ids=["1d", "2d", "3d"])
def test_gather_rows(trailing):
    rng = np.random.RandomState(7)
    values = rng.randn(8, *trailing)
    idx = rng.randint(0, 8, size=30)   # repeated rows, two never read
    _check(lambda v: tcore.gather_rows(v, torch.from_numpy(idx)),
           lambda v: jcore.gather_rows(v, jnp.asarray(idx)), [values])


@pytest.mark.parametrize("out_of_block", [False, True], ids=["local", "out_of_block"])
def test_gather_rows_blocked(out_of_block):
    rng = np.random.RandomState(8)
    g, r, e_b, c = 3, 5, 7, 4
    values = rng.randn(g * r, c)
    idx = (rng.randint(0, r, size=(g, e_b)) + np.arange(g)[:, None] * r).reshape(-1)
    if out_of_block:
        idx[[0, 8, 20]] = [14, 0, 3]   # rows of other blocks: they gather zeros
    _check(lambda v: tcore.gather_rows_blocked(v, torch.from_numpy(idx), g, r),
           lambda v: jcore.gather_rows_blocked(v, jnp.asarray(idx), g, r), [values])
    if out_of_block:
        out = tcore.gather_rows_blocked(torch.from_numpy(values), torch.from_numpy(idx), g, r)
        assert not out[[0, 8, 20]].any()


@pytest.mark.parametrize("dims", [[], [4], [3, 2]], ids=["none", "one", "two"])
def test_embed_tokens(dims):
    rng = np.random.RandomState(10)
    n, lead = 11, 3
    tables = [rng.randn(5, dm) for dm in dims]
    x = np.concatenate([rng.randn(n, lead)] + [rng.randint(0, 5, size=(n, 1)).astype(np.float64)
                                               for _ in dims], axis=-1)
    out_t = tcore.embed_tokens(torch.from_numpy(x), dims, [torch.from_numpy(t) for t in tables])
    out_j = jcore.embed_tokens(jnp.asarray(x), dims, [jnp.asarray(t) for t in tables])
    _close(out_t, out_j, atol=0)
    if dims:
        _check(lambda *ts: tcore.embed_tokens(torch.from_numpy(x), dims, list(ts)),
               lambda *ts: jcore.embed_tokens(jnp.asarray(x), dims, list(ts)), tables)


def test_exists():
    assert tcore.exists(0) and not tcore.exists(None)
    from egnn_tpu_torch import ops
    assert ops.exists is tcore.exists and ops.gather_rows is tcore.gather_rows
