"""The dispatcher's ``backend="pallas"`` and ``backend="fused"`` against the
JAX package's, and the port's ``ops`` namespace against ``egnn_tpu.ops``.

On the CPU each kernel's wrapper runs its plain version; the JAX side runs
its Pallas kernels in interpret mode. Integer coordinates keep every squared
distance exact in float32, so indices, rankings and gathered rows agree bit
for bit; payload and coordinate gradients agree at 1e-6 (float32 sums in
other orders). A spy on the wrappers shows which kernel each route takes.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu.ops as jops
from egnn_tpu.ops import neighbors as jnb
from egnn_tpu.ops.pallas import knn as jk
import egnn_tpu_torch.ops as tops
from egnn_tpu_torch.ops import neighbors as tnb
from egnn_tpu_torch.ops.cuda import knn as K


def _case(seed, b, n, with_mask, with_adj, payload_w):
    rng = np.random.RandomState(seed)
    coors = rng.randint(-8, 8, size=(b, n, 3)).astype(np.float32)
    mask = rng.rand(b, n) > 0.2 if with_mask else None
    adj = None
    if with_adj:
        ar = np.arange(n)
        adj = np.broadcast_to(np.abs(ar[:, None] - ar[None, :]) == 1, (b, n, n)).copy()
    payload = rng.randn(b, n, payload_w).astype(np.float32) if payload_w else None
    return coors, mask, adj, payload


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def calls(monkeypatch):
    """The kernel wrappers the dispatcher calls, in order."""
    seen = []
    for name in ("knn_select_gather", "knn_select", "knn_select_tiled"):
        def spy(*a, _fn=getattr(K, name), _name=name, **kw):
            seen.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(K, name, spy)
    return seen


@pytest.mark.parametrize("backend,n,k,with_mask,with_adj,payload_w,kernel", [
    ("pallas", 256, 8, True, True, 6, "knn_select_gather"),   # K1
    ("pallas", 200, 5, True, False, 0, "knn_select"),         # K3
    ("pallas", 100, 4, False, True, 3, "knn_select_gather"),  # below 128: no gate
    ("fused", 256, 8, True, True, 6, "knn_select_gather"),    # K1 inside the gate
    ("fused", 300, 16, True, False, 4, "knn_select_gather"),
    ("fused", 100, 4, True, False, 3, "knn_select"),          # n < 128: apart
    ("fused", 256, 8, True, False, 0, "knn_select"),          # no payload: exact
])
def test_backend_matches_jax(calls, backend, n, k, with_mask, with_adj, payload_w, kernel):
    coors, mask, adj, payload = _case(n + k + payload_w, 2, n, with_mask, with_adj, payload_w)
    jn, jg = jnb.knn_select_gather(_j(coors), k, math.inf, mask=_j(mask), adj_mat=_j(adj),
                                   payload=_j(payload), backend=backend, interpret=True)
    tn, tg = tnb.knn_select_gather(_t(coors), k, math.inf, mask=_t(mask), adj_mat=_t(adj),
                                   payload=_t(payload), backend=backend)
    assert calls == [kernel]
    np.testing.assert_array_equal(tn.indices.numpy(), np.asarray(jn.indices))
    np.testing.assert_array_equal(tn.ranking.numpy(), np.asarray(jn.ranking))
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(jn.valid))
    assert tn.winner is None
    if payload is None:
        assert tg is None and jg is None
    else:
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_backend_gradients_match_jax(backend):
    """The gathered rows carry gradients to the coordinates and the payload
    (K1's backward, K2 on the card), as the reference's custom VJP does."""
    n, k = 192, 6
    coors, mask, adj, payload = _case(7, 2, n, True, True, 5)
    w = np.random.RandomState(8).randn(2, n, k, 3 + 1 + 5).astype(np.float32)

    def jloss(c, p):
        _, g = jnb.knn_select_gather(c, k, math.inf, mask=_j(mask), adj_mat=_j(adj), payload=p,
                                     backend=backend, interpret=True)
        return jnp.sum(g * w)

    jgc, jgp = jax.grad(jloss, argnums=(0, 1))(_j(coors), _j(payload))
    tc = _t(coors).requires_grad_()
    tp = _t(payload).requires_grad_()
    _, g = tnb.knn_select_gather(tc, k, math.inf, mask=_t(mask), adj_mat=_t(adj), payload=tp,
                                 backend=backend)
    (g * _t(w)).sum().backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-6, atol=1e-6)


def test_routes_beyond_the_full_band_reach(monkeypatch, calls):
    """With the reach lowered below n: "pallas" still takes the full-band
    kernels, "fused" K1 inside its gate and, without a payload, the exact
    selection beyond the reach (K4)."""
    monkeypatch.setattr(K, "FULL_BAND_MAX_N", 128)
    coors, mask, _, payload = _case(3, 1, 256, True, False, 4)
    ev, ei = K.knn_select_plain(_t(coors), 8, _t(mask))
    for backend, pay, kernel in (("pallas", payload, "knn_select_gather"),
                                 ("pallas", None, "knn_select"),
                                 ("fused", payload, "knn_select_gather"),
                                 ("fused", None, "knn_select_tiled"),
                                 ("auto", payload, "knn_select_tiled")):
        calls.clear()
        nbhd, _ = tnb.knn_select_gather(_t(coors), 8, math.inf, mask=_t(mask),
                                        payload=_t(pay), backend=backend)
        assert calls[:1] == [kernel], (backend, pay is None)
        assert torch.equal(nbhd.indices, ei) and torch.equal(nbhd.ranking, ev)


def test_fused_gate_is_the_reference():
    for n in (1, 127, 128, 1024, 4096, 8192, 16384, 20000):
        for tw in (4, 36, 100, 128, 129, 300):
            for k in (1, 8, 16, 128):
                assert K.supports_knn_gather(n, tw, k) == jk.supports_pallas_knn_gather(
                    n, tw, k), (n, tw, k)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        tnb.knn_select_gather(torch.zeros(1, 16, 3, dtype=torch.float32), 4, math.inf,
                              backend="mosaic")


def test_ops_namespace_reexports_the_reference_names():
    """``egnn_tpu_torch.ops`` exports, under the reference's names, the ops
    the port has; each is the port's own function."""
    from egnn_tpu_torch.ops import gather_nodes, knn_select, segment_sum
    from egnn_tpu_torch.ops import core, graph, neighbors, pairwise_stream, segment, spatial

    assert set(tops.__all__) <= set(jops.__all__)
    assert gather_nodes is core.gather_nodes and segment_sum is segment.segment_sum
    assert knn_select is neighbors.knn_select
    for name in tops.__all__:
        obj = getattr(tops, name)
        assert obj.__module__.startswith("egnn_tpu_torch.ops."), name
        assert obj is getattr({"core": core, "graph": graph, "neighbors": neighbors,
                               "pairwise_stream": pairwise_stream, "segment": segment,
                               "spatial": spatial}[
            obj.__module__.rsplit(".", 1)[1]], name)
    out = segment_sum(torch.ones(3, 2, dtype=torch.float32), torch.tensor([0, 2, 2]), 3)
    assert out[:, 0].tolist() == [1.0, 0.0, 2.0]
