"""The port's segment sum (kernel K2's plain version and its fixed-point
model, ``ops/segment.py`` and its backward) against the JAX package.

On the CPU the port runs K2's plain version; ``chip_smoke.py`` holds the CUDA
kernel bitwise against its model ``segment_sum_fixed_point``, which the tests
below hold against float64 (within deg * 2^-23 * sum|x|, the worst case of a
sequential f32 sum), against itself on permuted edges (bitwise) and against
the plain version where every sum is exact. The plain version meets the TPU kernel itself in
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
    """The plain version, the CPU path, sums each segment from 0.0 in
    ascending edge order, which fixes its f32 rounding (the kernel's sums do
    not depend on the order: its model, below)."""
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


def _fixed_point_case(name):
    """(data (b, E, D) float32, ids (b, E), S) for the model's tests."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "random_pad_b3":
        return rng.randn(3, 700, 5).astype(np.float32), _ids(rng, (3, 700), 40), 40
    if name == "hubs":  # a few segments of hundreds of edges, the rest short
        ids = rng.randint(0, 64, size=(1, 2000))
        ids[0, 800:] = rng.randint(0, 4, size=1200)
        return (rng.randn(1, 2000, 9) * 3).astype(np.float32), ids.astype(np.int32), 64
    if name == "magnitudes_1e-30_1e30":  # one segment, each value beside its negation
        x = rng.choice([-1.0, 1.0], (1, 600, 4)) * 10.0 ** rng.uniform(-30, 30, (1, 600, 4))
        data = np.concatenate([x, -x, rng.randn(1, 50, 4)], axis=1).astype(np.float32)
        return data, np.zeros((1, 1250), np.int64), 2
    if name == "denormals":
        return (rng.randn(2, 500, 3) * 1e-40).astype(np.float32), _ids(rng, (2, 500), 30), 30
    if name == "denormal_results":  # x beside -x + t, |t| ~ 1e-42
        x = (rng.randn(1, 400, 3) * 1e-37).astype(np.float32)
        t = (rng.randn(1, 400, 3) * 1e-42).astype(np.float32)
        ids = rng.randint(0, 20, size=(1, 400))
        return np.concatenate([x, -x + t], axis=1), np.concatenate([ids, ids], axis=1), 20
    if name == "wide_columns_int32":
        return (rng.randn(2, 300, 70) * 10.0 ** rng.randint(-3, 4, size=(2, 300, 1))).astype(
            np.float32), _ids(rng, (2, 300), 25).astype(np.int32), 25
    raise KeyError(name)


FIXED_POINT_CASES = ["random_pad_b3", "hubs", "magnitudes_1e-30_1e30", "denormals",
                     "denormal_results", "wide_columns_int32"]


def _f64_reference(data, ids, s):
    """The float64 sum and the allowed error deg * 2^-23 * sum|x|."""
    d64, ids = torch.from_numpy(data).double(), torch.from_numpy(ids)
    deg = SK.segment_sum_plain(torch.ones_like(d64[..., :1]), ids, s)
    return (SK.segment_sum_plain(d64, ids, s),
            deg * 2.0**-23 * SK.segment_sum_plain(d64.abs(), ids, s))


@pytest.mark.parametrize("name", FIXED_POINT_CASES)
def test_fixed_point_within_sequential_f32_error_of_float64(name):
    data, ids, s = _fixed_point_case(name)
    out = SK.segment_sum_fixed_point(torch.from_numpy(data), torch.from_numpy(ids), s)
    ref, limit = _f64_reference(data, ids, s)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert bool(((out.double() - ref).abs() <= limit).all())


def _scalar_fixed_point(column):
    """The model's arithmetic for one (segment, column), in Python scalars:
    float64 products by powers of two are exact, ``round`` rounds half to
    even, ``float(int)`` rounds to nearest, numpy's float32 cast too."""
    finite = [x for x in column if np.isfinite(x)]
    nan = any(np.isnan(x) for x in column)
    pos, neg = any(x == np.inf for x in column), any(x == -np.inf for x in column)
    if nan or (pos and neg):
        return np.float32(np.nan)
    if pos or neg:
        return np.float32(np.inf if pos else -np.inf)
    ebits = max([1] + [(int(np.float32(x).view(np.uint32)) >> 23) & 0xFF for x in finite])
    h = 62 - len(column).bit_length()
    k = ebits - 126 - h  # u = 2^k
    total = sum(round(float(x) * 2.0 ** -k) for x in finite)
    return np.float32(float(total) * 2.0**k)


def test_fixed_point_matches_a_scalar_reference():
    """Every element of the model, bit for bit, against the arithmetic
    written out per (segment, column) in Python scalars."""
    rng = np.random.RandomState(15)
    data = (rng.randn(2, 300, 4) * 10.0 ** rng.randint(-45, 30, size=(2, 300, 4))).astype(
        np.float32)
    data[0, :40] = -data[0, 40:80]  # cancellation
    data[1, 5, 2], data[1, 9, 3], data[1, 11, 3] = np.nan, np.inf, -np.inf
    ids = _ids(rng, (2, 300), 12)
    ids[0, :80] = 3  # a segment with a wide spread of exponents
    out = SK.segment_sum_fixed_point(torch.from_numpy(data), torch.from_numpy(ids), 12).numpy()
    for g in range(2):
        for s in range(12):
            rows = data[g, ids[g] == s]
            for c in range(4):
                want = _scalar_fixed_point(rows[:, c]) if len(rows) else np.float32(0.0)
                assert out[g, s, c].view(np.uint32) == np.float32(want).view(np.uint32), (g, s, c)


@pytest.mark.parametrize("name", FIXED_POINT_CASES)
def test_fixed_point_same_bits_under_permutation(name):
    data, ids, s = _fixed_point_case(name)
    perm = np.random.RandomState(7).permutation(data.shape[1])
    out = SK.segment_sum_fixed_point(torch.from_numpy(data), torch.from_numpy(ids), s)
    moved = SK.segment_sum_fixed_point(torch.from_numpy(data[:, perm].copy()),
                                       torch.from_numpy(ids[:, perm].copy()), s)
    assert torch.equal(out.view(torch.int32), moved.view(torch.int32))


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_fixed_point_exact_where_sums_are_exact(dtype):
    """Small integers: every partial sum is exact in f32, so the model, the
    plain version and float64 agree to the bit (padding, ids >= S, b > 1)."""
    rng = np.random.RandomState(11)
    data = rng.randint(-50, 51, size=(3, 900, 6)).astype(np.float32)
    ids = _ids(rng, (3, 900), 45).astype(dtype)
    out = SK.segment_sum_fixed_point(torch.from_numpy(data), torch.from_numpy(ids), 45)
    plain = SK.segment_sum_plain(torch.from_numpy(data), torch.from_numpy(ids), 45)
    assert torch.equal(out, plain)


def test_fixed_point_single_edges_and_empty_segments_exact():
    rng = np.random.RandomState(12)
    data = (rng.randn(1, 40, 3) * 10.0 ** rng.randint(-40, 38, size=(1, 40, 1))).astype(
        np.float32)
    out = SK.segment_sum_fixed_point(torch.from_numpy(data), torch.arange(40)[None] * 2, 81)
    assert torch.equal(out[0, ::2][:40], torch.from_numpy(data[0]))
    empty = out[0, 1::2]
    assert torch.equal(empty, torch.zeros(40, 3)) and not bool(empty.signbit().any())


def test_fixed_point_non_finite_as_float64():
    """NaN, or +inf beside -inf, gives NaN; one kind of infinity gives it;
    the other columns of the segment stay finite and within their error."""
    rng = np.random.RandomState(13)
    data = rng.randn(1, 300, 5).astype(np.float32)
    ids = np.repeat(np.arange(6), 50)[None]
    data[0, 3, 0] = np.nan                            # segment 0, column 0
    data[0, 60, 1] = np.inf                           # segment 1, column 1
    data[0, 110, 2] = -np.inf                         # segment 2, column 2
    data[0, 160, 3], data[0, 170, 3] = np.inf, -np.inf  # segment 3, column 3
    data[0, 210, 4], data[0, 220, 4] = np.nan, np.inf   # segment 4, column 4
    out = SK.segment_sum_fixed_point(torch.from_numpy(data), torch.from_numpy(ids), 6)[0]
    ref, limit = _f64_reference(data, ids, 6)
    ref, limit = ref[0], limit[0]
    special = ~torch.isfinite(ref)
    assert int(special.sum()) == 5
    assert torch.equal(out[special].isnan(), ref[special].isnan())
    assert bool((out[special].isnan() | (out[special].double() == ref[special])).all())
    assert bool(((out[~special].double() - ref[~special]).abs() <= limit[~special]).all())


@pytest.mark.parametrize("name", ["hubs", "magnitudes_1e-30_1e30", "denormals",
                                  "denormal_results"])
def test_float_scaling_equals_the_models_rounding(name):
    """The kernel scales x by 1/u as two float32 products, 2^min(k, 127)
    then 2^max(k - 127, 0), and rounds half to even: the same integers as the
    model's float64 product, because the products are exact wherever the
    result can round to anything but 0."""
    data, ids, s = _fixed_point_case(name)
    x = torch.from_numpy(data).reshape(-1, data.shape[-1])
    rng = np.random.RandomState(14)
    for _ in range(20):
        ebits = int(rng.randint(1, 255))
        h = int(rng.randint(31, 62))
        k = h - 1 - (ebits - 127)
        scaled = x.double() * 2.0**k
        keep = x.abs().double() < 2.0 ** (ebits - 126)  # |x| < 2^(e_max + 1)
        lo = torch.tensor(2.0 ** min(k, 127), dtype=torch.float32)
        hi = torch.tensor(2.0 ** max(k - 127, 0), dtype=torch.float32)
        as_float = torch.round((x * lo) * hi).double()
        assert torch.equal(as_float[keep], torch.round(scaled)[keep])


def test_fixed_point_takes_float32_only():
    with pytest.raises(ValueError, match="float32"):
        SK.segment_sum_fixed_point(torch.zeros(1, 3, 2, dtype=torch.float64),
                                   torch.zeros(1, 3, dtype=torch.int64), 2)
