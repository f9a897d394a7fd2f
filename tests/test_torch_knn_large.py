"""The port's large-n neighbour selection against the JAX package: the plain
versions of kernels K4 (j-tiled exact selection), K5 and K6 (packed-key
candidates), the routing gates, and the dispatcher's tiled, packed and
packed-tiled routes, compact and wide.

On the CPU the port's wrappers run the kernels' plain versions, which
``chip_smoke.py`` holds the CUDA kernels against bitwise on the card. Here
they meet the TPU kernels in Pallas interpret mode, in float32, with small
j-tiles (tj = 128) so that several tiles merge.

Tolerances. ``idx``, ``cols``, ``winner`` and ``valid`` are exact. ``keys``
are exact on integer or dyadic coordinates: every square and sum is then
exact in float32, so XLA's interpret-mode rounding, which may differ by an
ulp from a coordinate-by-coordinate sum, cannot move a key. On random floats
the refined ``indices`` are exact and ``ranking`` agrees at rtol = atol =
1e-6 (the same ulp). Gathered rows are copies: bitwise. Payload gradients
agree at 1e-6 (float32 sums in other orders).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops import neighbors as jnb
from egnn_tpu.ops.pallas import knn as jk
from egnn_tpu_torch.ops import neighbors as tnb
from egnn_tpu_torch.ops.cuda import knn as K


def _case(seed, b, n, c=3, with_mask=False, with_adj=False, kind="int"):
    rng = np.random.RandomState(seed)
    if kind == "int":        # many exact distance ties
        coors = rng.randint(-8, 8, size=(b, n, c)).astype(np.float32)
    elif kind == "dyadic":   # exact in float32, few ties
        coors = (rng.randint(-2048, 2048, size=(b, n, c)) / 64.0).astype(np.float32)
    else:                    # random floats: ties have measure zero
        coors = (rng.randn(b, n, c) * 2.0).astype(np.float32)
    mask = rng.rand(b, n) > 0.2 if with_mask else None
    adj = None
    if with_adj:
        ar = np.arange(n)
        adj = np.broadcast_to(np.abs(ar[:, None] - ar[None, :]) == 1, (b, n, n)).copy()
        extra = rng.rand(b, n, n) < 0.01
        adj |= extra | np.swapaxes(extra, 1, 2)
    return coors, mask, adj


def _pileup(seed, n, distinct):
    """``distinct`` integer points tiled to n: distance ties in groups far
    larger than kc, which no candidate list can cover."""
    base = np.random.RandomState(seed).randint(-2, 3, size=(1, distinct, 3)).astype(np.float32)
    return np.tile(base, (1, n // distinct, 1))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the routing gates and constants are the reference's
# ---------------------------------------------------------------------------


def test_gates_match_the_reference():
    assert tnb.CANDIDATE_SLACK == jnb.CANDIDATE_SLACK
    assert K.PACKED_MASK_SENTINEL == jk.PACKED_MASK_SENTINEL
    assert K.PACKED_MASK_SENTINEL_TILED == jk.PACKED_MASK_SENTINEL_TILED
    sizes = [1, 100, 128, 129, 1210, 12200, 16384, 16385, 16896, 17000, 17024, 17408,
             20480, 32768, 65536, 66048, 262144, 262145]
    for n in sizes:
        assert K.supports_knn_shapes(n) == jk.supports_pallas_knn_shapes(n), n
        for kc in (1, 12, 20, 32, 33, 128, 129):
            assert K.supports_knn_packed(n, kc) == \
                jk.supports_pallas_knn_packed(n, kc, backend="tpu"), (n, kc)
            assert K.supports_knn_packed_tiled(n, kc) == \
                jk.supports_pallas_knn_packed_tiled(n, kc, backend="tpu"), (n, kc)
    for n in (128, 1280, 12288, 16384, 17024, 17408, 20480, 65536, 66048, 262144):
        assert K._packed_tiled_tj(n) == jk._packed_tiled_tj(n), n
        assert K._packed_tiled_tj(n, 128) == jk._packed_tiled_tj(n, 128), n


# ---------------------------------------------------------------------------
# K4: the j-tiled exact selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,c,with_mask,with_adj", [
    (512, 8, 3, False, False),
    (512, 8, 3, True, False),
    (384, 5, 3, True, True),
    (300, 3, 3, True, False),    # n not a multiple of the lane width
    (640, 16, 5, True, True),    # c = 5, five j-tiles
])
def test_knn_select_tiled_plain_matches_pallas(n, k, c, with_mask, with_adj):
    coors, mask, adj = _case(n + k, 2, n, c, with_mask, with_adj)
    jv, ji = jk.knn_select_pallas_tiled(_j(coors), k, mask=_j(mask), adj_mat=_j(adj),
                                        interpret=True, tj=128)
    tv, ti = K.knn_select_tiled(_t(coors), k, _t(mask), _t(adj))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))  # integer coordinates
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64
    # row chunks of any size give the same selection
    cv, ci = K.knn_select_plain(_t(coors), k, _t(mask), _t(adj), row_chunk=100)
    assert torch.equal(ci, ti) and torch.equal(cv, tv)


def test_knn_select_tiled_tie_order_across_tiles():
    """Every distance ties at 0: the winners are the lowest columns."""
    coors = np.zeros((1, 256, 3), np.float32)
    _, ji = jk.knn_select_pallas_tiled(_j(coors), 6, interpret=True, tj=128)
    _, ti = K.knn_select_tiled(_t(coors), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0, 200].tolist() == [0, 1, 2, 3, 4, 5]


def test_knn_select_tiled_ranks_in_float32():
    """Like the TPU kernel, K4 ranks in float32 whatever it is given."""
    coors, mask, _ = _case(5, 1, 256, with_mask=True, kind="float")
    tv, ti = K.knn_select_tiled(_t(coors.astype(np.float64)), 8, _t(mask))
    fv, fi = K.knn_select_tiled(_t(coors), 8, _t(mask))
    assert tv.dtype == torch.float32 and torch.equal(tv, fv) and torch.equal(ti, fi)


# ---------------------------------------------------------------------------
# K5 and K6: packed-key candidates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,kc,c,with_mask,kind", [
    (512, 12, 3, False, "int"),
    (512, 12, 3, True, "int"),
    (512, 20, 3, True, "dyadic"),
    (1210, 12, 3, True, "dyadic"),   # pads to 1280 = 10 j-tiles, not a power of two
    (256, 20, 5, False, "dyadic"),   # c = 5
])
def test_candidates_packed_tiled_plain_matches_pallas(n, kc, c, with_mask, kind):
    coors, mask, _ = _case(n + kc, 2, n, c, with_mask, kind=kind)
    jkeys, jcols = jk.knn_candidates_packed_tiled(_j(coors), kc, mask=_j(mask),
                                                  interpret=True, tj=128)
    tkeys, tcols = K.knn_candidates_packed_tiled(_t(coors), kc, _t(mask))
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    assert tkeys.dtype == torch.int32 and tcols.dtype == torch.int64
    ckeys, ccols = K.knn_candidates_packed_tiled_plain(_t(coors), kc, _t(mask), row_chunk=77)
    assert torch.equal(ckeys, tkeys) and torch.equal(ccols, tcols)


@pytest.mark.parametrize("n,kc,c,with_mask,kind", [
    (128, 12, 3, False, "int"),
    (256, 20, 3, True, "int"),
    (200, 12, 3, True, "dyadic"),    # n not a multiple of the lane width
    (256, 9, 5, True, "dyadic"),
])
def test_candidates_packed_plain_matches_pallas(n, kc, c, with_mask, kind):
    coors, mask, _ = _case(n * 3 + kc, 2, n, c, with_mask, kind=kind)
    jkeys, jcols = jk.knn_candidates_packed(_j(coors), kc, mask=_j(mask), interpret=True)
    tkeys, tcols = K.knn_candidates_packed(_t(coors), kc, _t(mask))
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))


def test_candidates_order_is_key_then_global_column():
    """Coincident points: one key for every pair, so the candidates are the
    lowest columns of the whole row, not of a tile."""
    coors = np.zeros((1, 384, 3), np.float32)
    for fn in (K.knn_candidates_packed_tiled, K.knn_candidates_packed):
        keys, cols = fn(_t(coors), 12)
        assert (keys == 0).all()
        assert torch.equal(cols, torch.arange(12).expand(1, 384, 12))


def test_candidates_masked_pairs_take_the_sentinel():
    coors, _, _ = _case(9, 1, 256, kind="dyadic")
    mask = np.zeros((1, 256), bool)
    mask[0, [3, 50, 51, 200, 255]] = True   # fewer valid nodes than k
    for fn, jfn, sentinel in (
        (K.knn_candidates_packed_tiled,
         lambda *a, **kw: jk.knn_candidates_packed_tiled(*a, tj=128, **kw),
         K.PACKED_MASK_SENTINEL_TILED),
        (K.knn_candidates_packed, jk.knn_candidates_packed, K.PACKED_MASK_SENTINEL),
    ):
        keys, cols = fn(_t(coors), 12, _t(mask))
        jkeys, jcols = jfn(_j(coors), 12, mask=_j(mask), interpret=True)
        np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
        np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
        assert (keys[0, 0] == sentinel).all()           # a masked row
        assert (keys[0, 3, :5] < sentinel).all() and (keys[0, 3, 5:] == sentinel).all()
        assert cols[0, 3, 5:].tolist() == [0, 1, 2, 4, 5, 6, 7]  # lowest masked columns


def test_candidates_reject_kc_beyond_n():
    with pytest.raises(ValueError):
        K.knn_candidates_packed_tiled(torch.zeros(1, 8, 3), 12)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------


def _both(coors, k, radius, mask, adj, payload, backend, wide):
    jn, jg = jnb.knn_select_gather(_j(coors), k, radius, mask=_j(mask), adj_mat=_j(adj),
                                   payload=_j(payload), backend=backend, interpret=True,
                                   wide=wide)
    tn, tg = tnb.knn_select_gather(_t(coors), k, radius, mask=_t(mask), adj_mat=_t(adj),
                                   payload=_t(payload), backend=backend, wide=wide)
    return jn, jg, tn, tg


def _assert_same(jn, jg, tn, tg, exact_ranking=False):
    np.testing.assert_array_equal(tn.indices.numpy(), np.asarray(jn.indices))
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(jn.valid))
    tol = dict(rtol=0, atol=0) if exact_ranking else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn.ranking.numpy(), np.asarray(jn.ranking), **tol)
    assert (tn.winner is None) == (jn.winner is None)
    if tn.winner is not None:
        np.testing.assert_array_equal(tn.winner.numpy(), np.asarray(jn.winner))
    assert (tg is None) == (jg is None)
    if tg is not None:
        np.testing.assert_array_equal(tg.detach().numpy(), np.asarray(jg))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("backend,n,k", [("packed_tiled", 512, 8), ("packed", 256, 16)])
def test_packed_routes_match_jax(backend, n, k, with_mask, wide):
    coors, mask, _ = _case(n + k + with_mask, 2, n, with_mask=with_mask, kind="float")
    payload = np.random.RandomState(7).randn(2, n, 5).astype(np.float32)
    jn, jg, tn, tg = _both(coors, k, 2.5, mask, None, payload, backend, wide)
    _assert_same(jn, jg, tn, tg)
    slots = k + tnb.CANDIDATE_SLACK if wide else k
    assert tn.indices.shape == (2, n, slots) and tn.indices.dtype == torch.int64
    assert tg.shape == (2, n, slots, 3 + with_mask + 5)
    if wide:
        assert (tn.winner.sum(-1) == k).all()
        # the winner slots hold the exact top-k
        ev, ei = K.knn_select_plain(_t(coors), k, _t(mask))
        for bi in range(2):
            for i in range(0, n, 7):
                assert set(tn.indices[bi, i][tn.winner[bi, i]].tolist()) == \
                    set(ei[bi, i].tolist())


@pytest.mark.parametrize("with_mask,with_adj", [(False, False), (True, True)])
def test_tiled_route_matches_jax(with_mask, with_adj):
    n, k = 384, 8
    coors, mask, adj = _case(4, 2, n, with_mask=with_mask, with_adj=with_adj, kind="float")
    payload = np.random.RandomState(8).randn(2, n, 4).astype(np.float32)
    jn, jg, tn, tg = _both(coors, k, 3.0, mask, adj, payload, "tiled", True)
    _assert_same(jn, jg, tn, tg)
    assert tn.winner is None and tn.indices.shape == (2, n, k)


def test_without_payload_no_rows():
    coors, mask, _ = _case(6, 1, 256, with_mask=True, kind="float")
    for backend in ("tiled", "packed", "packed_tiled"):
        jn, jg, tn, tg = _both(coors, 8, math.inf, mask, None, None, backend, False)
        assert tg is None
        _assert_same(jn, jg, tn, tg)


@pytest.mark.parametrize("with_adj", [False, True])
def test_auto_beyond_the_full_band_reach(monkeypatch, with_adj):
    """With the reach lowered, ``auto`` takes the routes it takes beyond
    n = 16384: K5 and the refine without an adjacency, K4 with one."""
    n, k = 512, 8
    monkeypatch.setattr(K, "FULL_BAND_MAX_N", 256)
    calls = []
    for name in ("knn_select_gather", "knn_select", "knn_select_tiled",
                 "knn_candidates_packed_tiled", "knn_candidates_packed"):
        def spy(*a, _fn=getattr(K, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(K, name, spy)
    coors, mask, adj = _case(12, 2, n, with_mask=True, with_adj=with_adj, kind="float")
    payload = np.random.RandomState(3).randn(2, n, 4).astype(np.float32)
    tn, tg = tnb.knn_select_gather(_t(coors), k, 3.0, mask=_t(mask), adj_mat=_t(adj),
                                   payload=_t(payload), wide=True)
    jn, jg = jnb.knn_select_gather(
        _j(coors), k, 3.0, mask=_j(mask), adj_mat=_j(adj), payload=_j(payload),
        backend="tiled" if with_adj else "packed_tiled", interpret=True, wide=True)
    _assert_same(jn, jg, tn, tg)
    assert calls == (["knn_select_tiled"] if with_adj else ["knn_candidates_packed_tiled"])
    # a shape the packed-tiled gate refuses goes to K4 (lane-padded 17024 = 128 * 133)
    assert not K.supports_knn_packed_tiled(17000, k + 4)
    # within the reach nothing changes
    calls.clear()
    small = tnb.knn_select_gather(_t(coors[:, :200]), k, 3.0, payload=_t(payload[:, :200]),
                                  wide=True)[0]
    assert calls == ["knn_select_gather"] and small.winner is None


def test_forced_packed_backends_fall_through_their_gates():
    """A forced packed backend whose gate fails takes the exact route, as in
    the JAX dispatcher: an adjacency, n < 128, n < 2 * kc."""
    coors, mask, adj = _case(2, 1, 160, with_mask=True, with_adj=True, kind="float")
    ev, ei = K.knn_select_plain(_t(coors), 8, _t(mask), _t(adj))
    for backend in ("packed", "packed_tiled"):
        nbhd, _ = tnb.knn_select_gather(_t(coors), 8, math.inf, mask=_t(mask),
                                        adj_mat=_t(adj), backend=backend, wide=True)
        assert nbhd.winner is None and torch.equal(nbhd.indices, ei)
        small, _ = tnb.knn_select_gather(_t(coors[:, :100]), 8, math.inf, backend=backend,
                                         wide=True)
        assert small.winner is None and small.indices.shape == (1, 100, 8)
        big_k, _ = tnb.knn_select_gather(_t(coors), 100, math.inf, backend=backend, wide=True)
        assert big_k.winner is None and big_k.indices.shape == (1, 160, 100)
    # "fused" without a payload is the exact selection too
    fused, _ = tnb.knn_select_gather(_t(coors), 8, math.inf, mask=_t(mask), adj_mat=_t(adj),
                                     backend="fused")
    assert fused.winner is None and torch.equal(fused.indices, ei)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("backend,distinct", [("packed", 32), ("packed_tiled", 64)])
def test_tie_pileup_takes_the_exact_fallback(monkeypatch, backend, distinct, with_mask, wide):
    """Tie groups larger than kc fail the coverage certificate: the whole
    call goes to the exact kernel and reproduces it bit for bit."""
    n, k = 256, 8
    kc = k + tnb.CANDIDATE_SLACK
    coors = _pileup(3, n, distinct)
    mask = np.random.RandomState(4).rand(1, n) > 0.3 if with_mask else None
    exact_name = "knn_select_tiled" if backend == "packed_tiled" else "knn_select"
    calls = []

    def spy(*a, _fn=getattr(K, exact_name), **kw):
        calls.append(exact_name)
        return _fn(*a, **kw)

    monkeypatch.setattr(K, exact_name, spy)
    jn, jg, tn, tg = _both(coors, k, math.inf, mask, None, None, backend, wide)
    assert calls == [exact_name]
    _assert_same(jn, jg, tn, tg, exact_ranking=True)
    ev, ei = K.knn_select_plain(_t(coors), k, _t(mask))
    assert torch.equal(tn.indices[..., :k], ei) and torch.equal(tn.ranking[..., :k], ev)
    if wide:
        assert torch.equal(tn.winner, (torch.arange(kc) < k).expand(1, n, kc))
        assert (tn.indices[..., k:] == n - 1).all() and torch.isinf(tn.ranking[..., k:]).all()


def test_compact_ties_prefer_the_lowest_slot():
    """Every point twice: the certificate holds, but the k-th and (k+1)-th
    candidates tie exactly in rank. The lowest slot (the lowest column) wins,
    as ``jax.lax.top_k`` has it; ``torch.topk`` promises no such order."""
    n, k = 256, 5
    half, _, _ = _case(21, 1, n // 2, kind="float")
    coors = np.concatenate([half, half], axis=1)   # node i + 128 duplicates node i
    for backend in ("packed", "packed_tiled"):
        jn, jg, tn, tg = _both(coors, k, math.inf, None, None, None, backend, False)
        _assert_same(jn, jg, tn, tg)
        ev, ei = K.knn_select_plain(_t(coors), k)
        assert torch.equal(tn.indices, ei)
        # k is odd, so the last winner is the first of a tied pair
        assert (tn.indices[0, :, -1] < n // 2).all()
        jn, jg, tn, tg = _both(coors, k, math.inf, None, None, None, backend, True)
        _assert_same(jn, jg, tn, tg)


def test_wide_boundary_tie_group_resolved_by_rank_then_slot():
    """Nodes 100..103 share node 0's coarse key but differ in exact rank:
    the winner mask resolves the boundary by exact (rank, slot) order, not
    candidate order."""
    n, k = 128, 4
    coors = (np.random.RandomState(9).randn(1, n, 3) * 2).astype(np.float32)
    base = coors[0, 0] + np.asarray([2.0, 0.0, 0.0], np.float32)
    for t, eps in enumerate([3e-6, 1e-6, 2e-6, 0.0]):
        coors[0, 100 + t] = base + np.asarray([eps, 0, 0], np.float32)
    for backend in ("packed", "packed_tiled"):
        jn, jg, tn, tg = _both(coors, k, math.inf, None, None, None, backend, True)
        _assert_same(jn, jg, tn, tg)
        _, ei = K.knn_select_plain(_t(coors), k)
        for i in range(n):
            assert set(tn.indices[0, i][tn.winner[0, i]].tolist()) == set(ei[0, i].tolist()), i


@pytest.mark.parametrize("wide", [False, True])
def test_masked_rows_with_the_kth_key_at_the_sentinel(wide):
    """Fewer valid nodes than k: the k-th key of every row is the masked-fill
    sentinel, which the certificate accepts, and the result is still exact."""
    n, k = 128, 8
    coors, _, _ = _case(31, 1, n, kind="float")
    mask = np.zeros((1, n), bool)
    mask[0, [1, 17, 64, 65, 127]] = True
    for backend in ("packed", "packed_tiled"):
        jn, jg, tn, tg = _both(coors, k, 50.0, mask, None, None, backend, wide)
        _assert_same(jn, jg, tn, tg)
        ev, ei = K.knn_select_plain(_t(coors), k, _t(mask))
        if wide:
            picked = [tn.indices[0, i][tn.winner[0, i]].tolist() for i in range(n)]
            assert all(sorted(p) == sorted(ei[0, i].tolist()) for i, p in enumerate(picked))
        else:
            assert torch.equal(tn.indices, ei)
            assert torch.equal(tn.valid, ev <= 50.0)


@pytest.mark.parametrize("backend,wide", [("packed_tiled", True), ("packed_tiled", False),
                                          ("packed", True), ("tiled", False)])
def test_large_route_gradients_match_jax(backend, wide):
    """The gathered rows carry gradients to the coordinates and the payload
    (the backward is the segment sum over the kc-wide indices); selection is
    not differentiated."""
    n, k = 256, 8
    coors, mask, _ = _case(41, 2, n, with_mask=True, kind="float")
    payload = np.random.RandomState(42).randn(2, n, 4).astype(np.float32)
    slots = k + tnb.CANDIDATE_SLACK if wide and backend != "tiled" else k
    w = np.random.RandomState(43).randn(2, n, slots, 3 + 1 + 4).astype(np.float32)

    def jloss(c, p):
        _, g = jnb.knn_select_gather(c, k, math.inf, mask=_j(mask), payload=p,
                                     backend=backend, interpret=True, wide=wide)
        return (g * jnp.asarray(w)).sum()

    jc, jp = jax.grad(jloss, argnums=(0, 1))(_j(coors), _j(payload))
    tc, tp = _t(coors).requires_grad_(), _t(payload).requires_grad_()
    nbhd, g = tnb.knn_select_gather(tc, k, math.inf, mask=_t(mask), payload=tp,
                                    backend=backend, wide=wide)
    assert not nbhd.indices.requires_grad and not nbhd.ranking.requires_grad
    (g * _t(w)).sum().backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the card's traversal of K4-K6 (knn_select_block_kernel) as a CPU model
# ---------------------------------------------------------------------------


def _block_case(seed, n, c, kind, with_mask, with_adj):
    """One batch of two: a random mask mixes masked and unmasked rows inside
    every warp; the adjacency is a chain plus random edges."""
    coors, _, adj = _case(seed, 2, n, c, with_adj=with_adj, kind=kind)
    rng = np.random.RandomState(seed + 1)
    mask = rng.rand(2, n) > 0.3 if with_mask else None
    return _t(coors), _t(mask), _t(adj)


_SHIFTS = {0: None, 12: K.knn_candidates_packed_tiled_plain, 14: K.knn_candidates_packed_plain}


@pytest.mark.parametrize("n,k,c,kind,with_mask,with_adj,rows,tile", [
    (2049, 16, 3, "int", True, True, 4, None),   # integer ties, last tile 1 column, nq % 32 = 1
    (1025, 20, 3, "float", True, False, 4, 512),
    (777, 8, 3, "int", True, True, 2, 128),      # seven tiles, the last 9 columns
    (600, 16, 3, "dyadic", False, False, 1, None),
    (700, 48, 3, "int", True, True, 2, None),    # two list slots a lane
    (530, 48, 3, "float", True, False, 1, None),
    (520, 128, 3, "int", True, True, 1, None),   # four slots a lane
    (530, 12, 5, "int", True, True, 1, None),    # c = 5: 512-column tiles, the last 18 columns
    (33, 5, 3, "int", True, True, 4, None),      # one real row in the second block
    (1027, 32, 3, "int", True, False, 2, 256),   # a full slot; the last tile 3 columns
])
@pytest.mark.parametrize("shift", [0, 12, 14])
def test_block_model_matches_plain(n, k, c, kind, with_mask, with_adj, rows, tile, shift):
    """The kernel's steps (rows a warp, four columns a lane, the pre-test,
    one vote a warp step, the offers) give the plain versions' selection
    bit for bit: K4 with its fills and adjacency, K5 and K6 with their keys
    and sentinels."""
    coors, mask, adj = _block_case(n + k + c + rows, n, c, kind, with_mask, with_adj)
    if shift == 0:
        v, i, counts = K.knn_select_block_model(coors, k, mask, adj, 0, rows, tile)
        pv, pi = K.knn_select_plain(coors, k, mask, adj)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    else:
        keys, cols, counts = K.knn_select_block_model(coors, k, mask, None, shift, rows, tile)
        pk, pc = _SHIFTS[shift](coors, k, mask)
        assert keys.dtype == torch.int32 and torch.equal(keys, pk) and torch.equal(cols, pc)
    warps = 2 * -(-n // (8 * rows)) * 8
    tile = K.block_tile(c) if tile is None else tile
    assert counts["steps"] == warps * sum(-(-min(tile, n - j0) // 128)
                                          for j0 in range(0, n, tile))
    assert 0 < counts["votes"] <= counts["steps"]



# ---------------------------------------------------------------------------
# K8 on the same traversal: the query rows, several warps a row
# ---------------------------------------------------------------------------


def _query_case(seed, n, R, kind, with_mask, c=3):
    """A batch of two: the points, R query rows picked among them (repeats
    allowed) and the mask on both sides."""
    coors, _, _ = _case(seed, 2, n, c=c, kind=kind)
    rng = np.random.RandomState(seed + 2)
    mask = rng.rand(2, n) > 0.25 if with_mask else None
    fidx = rng.randint(0, n, size=(2, R))
    q = np.take_along_axis(coors, fidx[..., None], axis=1)
    qm = None if mask is None else np.take_along_axis(mask, fidx, axis=1)
    return coors, mask, q, qm, fidx


@pytest.mark.parametrize("n,R,k,kind,with_mask,rows,stripes", [
    (20000, 1, 16, "float", True, 1, 8),     # one row; stripes of 20 and 19 steps
    (20000, 5, 16, "float", False, 1, 8),    # fewer rows than a block holds
    (20000, 700, 16, "dyadic", True, 2, 8),  # masks on both sides
    (3000, 37, 16, "int", True, 4, 4),       # integer ties across the stripes
    (2100, 64, 128, "float", True, 1, 8),    # four list slots a lane
    (5000, 100, 48, "int", True, 2, 2),      # two
    (4000, 300, 16, "float", False, 4, 1),   # one warp a row
])
def test_query_model_matches_plain(n, R, k, kind, with_mask, rows, stripes):
    """K8's steps (rows a warp, stripes of every tile a warp each, the
    pre-test, one vote a warp step, the offers, the stripes' lists merged)
    give the plain version's selection bit for bit."""
    coors, mask, q, qm, _ = _query_case(n + R + k, n, R, kind, with_mask)
    v, i, counts = K.knn_select_block_model(_t(coors), k, _t(mask), None, 0, rows, None, _t(q),
                                            _t(qm), stripes)
    pv, pi = K.knn_select_queries_plain(_t(q), _t(coors), k, _t(qm), _t(mask))
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    n_rows = -(-R // (8 // stripes * rows)) * (8 // stripes * rows)
    tile = K.block_tile(3)
    steps = sum(-(-min(tile, n - j0) // 128) for j0 in range(0, n, tile))
    assert counts["steps"] == 2 * n_rows // rows * steps
    assert 0 < counts["votes"] <= counts["steps"]
    assert counts["merges"] == 2 * n_rows * (stripes - 1)


@pytest.mark.parametrize("n,R,k,kind,with_mask,rows,stripes", [
    (300, 40, 6, "float", True, 2, 2),       # three steps: stripes of two and one
    (512, 9, 16, "float", False, 1, 4),
    (256, 128, 8, "int", True, 4, 8),        # ties; eight stripes, six of them empty
])
def test_query_model_matches_pallas(n, R, k, kind, with_mask, rows, stripes):
    coors, mask, q, qm, fidx = _query_case(n + R, n, R, kind, with_mask)
    jv, ji = jk.knn_select_queries_pallas(_j(q), _j(coors), k, q_mask=_j(qm), p_mask=_j(mask),
                                          interpret=True)
    v, i, _ = K.knn_select_block_model(_t(coors), k, _t(mask), None, 0, rows, None, _t(q), _t(qm),
                                       stripes)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    tol = dict(rtol=0, atol=0) if kind == "int" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **tol)
    # the rows are K4's rows, bit for bit
    ev, ei = K.knn_select_plain(_t(coors), k, _t(mask))
    pick = _t(fidx)[..., None].expand(2, R, k)
    assert torch.equal(i, torch.gather(ei, 1, pick)) and torch.equal(v, torch.gather(ev, 1, pick))


@pytest.mark.parametrize("with_mask", [False, True])
def test_query_model_matches_plain_at_c5(with_mask):
    """c != 3: one row a warp through the predicated loop over 512-column
    tiles, as K4 takes it, bit for bit with the plain version."""
    n, R, k = 1300, 21, 16
    coors, mask, q, qm, _ = _query_case(n + R, n, R, "dyadic", with_mask, c=5)
    v, i, counts = K.knn_select_block_model(_t(coors), k, _t(mask), None, 0, 1, None, _t(q),
                                            _t(qm))
    pv, pi = K.knn_select_queries_plain(_t(q), _t(coors), k, _t(qm), _t(mask))
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    assert 0 < counts["votes"] <= counts["steps"]


def test_query_model_refuses_an_adjacency():
    coors = torch.zeros(1, 16, 3)
    with pytest.raises(ValueError):
        K.knn_select_block_model(coors, 2, None, torch.zeros(1, 16, 16, dtype=torch.bool),
                                 queries=coors[:, :4])
    with pytest.raises(ValueError):
        K.knn_select_block_model(coors, 2, queries=coors[:, :4], stripes=3)


# ---------------------------------------------------------------------------
# K1 and K3 on the same traversal: the points, several warps a row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,c,kind,with_mask,with_adj,rows,stripes", [
    (1024, 8, 3, "float", True, True, 1, 4),   # anchor 3 at b = 1: four warps a row
    (300, 8, 3, "int", True, True, 1, 8),      # tie pile-ups; eight stripes of 0-1 steps
    (777, 16, 3, "dyadic", False, False, 4, 2),
    (530, 48, 3, "int", True, True, 2, 2),     # two list slots a lane
    (200, 128, 3, "float", True, False, 1, 4), # four
    (260, 5, 5, "int", True, True, 1, 1),      # c = 5, as the kernel plans it
    (600, 12, 5, "float", True, False, 1, 2),  # c = 5 over 512-column tiles, split
    (160, 8, 3, "nan", False, True, 1, 4),     # NaN rankings: still k real columns a row
])
def test_self_stripes_model_matches_plain(n, k, c, kind, with_mask, with_adj, rows, stripes):
    """K3's and K1's steps (the points' rows, stripes of every tile a warp
    each, the stripes' lists merged, K1's copy of the winners' rows) give the
    plain versions' selection and rows bit for bit."""
    coors, mask, adj = _block_case(n + k + c + stripes, n, c,
                                   "float" if kind == "nan" else kind, with_mask, with_adj)
    if kind == "nan":   # a NaN coordinate: its row and its column rank NaN
        coors[0, 17, 1] = math.nan
        coors[1, 90, 0] = math.nan
    table = torch.from_numpy(np.random.RandomState(n).randn(2, n, 7).astype(np.float32))
    v, i, got_rows, counts = K.knn_select_block_model(coors, k, mask, adj, 0, rows, None,
                                                      stripes=stripes, table=table)
    pv, pi, prows = K.knn_select_gather_plain(coors, k, table, mask, adj)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    assert torch.equal(got_rows.view(torch.int32), prows.view(torch.int32))
    v3, i3, counts3 = K.knn_select_block_model(coors, k, mask, adj, 0, rows, None,
                                               stripes=stripes)
    sv, si = K.knn_select_plain(coors, k, mask, adj)
    assert torch.equal(v3.view(torch.int32), sv.view(torch.int32)) and torch.equal(i3, si)
    assert counts3 == counts
    n_rows = -(-n // (8 // stripes * rows)) * (8 // stripes * rows)
    tile = K.block_tile(c)
    steps = sum(-(-min(tile, n - j0) // 128) for j0 in range(0, n, tile))
    assert counts["steps"] == 2 * n_rows // rows * steps
    assert 0 < counts["votes"] <= counts["steps"]
    assert counts["merges"] == 2 * n_rows * (stripes - 1)


def test_self_stripes_model_matches_gather_pallas():
    """The striped model of K1 against the TPU kernel in interpret mode, on
    integer coordinates (exact rankings) with a mask and a chain."""
    n, k = 256, 8
    coors, mask, adj = _case(7, 2, n, with_mask=True, with_adj=True, kind="int")
    table = np.random.RandomState(8).randn(2, n, 36).astype(np.float32)
    jv, ji, jrows = jk.knn_select_gather_pallas(_j(coors), k, _j(table), mask=_j(mask),
                                                adj_mat=_j(adj), interpret=True)
    v, i, got_rows, _ = K.knn_select_block_model(_t(coors), k, _t(mask), _t(adj), 0, 1, None,
                                                 stripes=4, table=_t(table))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(jrows))


def test_self_model_refuses_a_payload_for_query_rows():
    coors = torch.zeros(1, 16, 3)
    with pytest.raises(ValueError):
        K.knn_select_block_model(coors, 2, queries=coors[:, :4], table=torch.zeros(1, 16, 2))
    with pytest.raises(ValueError):
        K.knn_select_block_model(coors, 2, window=(torch.zeros(1, 1), 8, 128, None))
