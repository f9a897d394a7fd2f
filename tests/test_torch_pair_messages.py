"""The plain versions of the fused pair kernels K10 and K11
(``egnn_tpu_torch/ops/cuda/pair_messages.py``) against the JAX package's
Pallas kernels in interpret mode, and the hand-derived backward against
float64 autograd of the plain forward.

The JAX kernels compute in float32 whatever they are given, so comparisons
with them hold float32 tolerances (those of ``tests/test_fused_pairs.py``
and ``tests/test_pallas_knn_layer.py``: rtol 2e-4 / atol 2e-5 forward, rtol
5e-4 / atol 5e-5 for gradients, the sums taken in other orders). Neighbour
ids are self-free there: a self pair under ``norm_coors`` carries
scale / eps = 1e8-sized terms that cancel only after the scatter, which
float32 cannot resolve. Against autograd everything is float64 and agrees
at 1e-10 relative to each tensor's largest value.
"""
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egnn_tpu.ops.pallas.knn_layer import fused_knn_messages as jax_knn_messages
from egnn_tpu.ops.pallas.pair_messages import fused_pair_messages as jax_pair_messages
from egnn_tpu_torch.ops.cuda import pair_messages as PM

WEIGHT_NAMES = ("wj", "wd", "w2", "b2", "gw", "gb", "cw1", "cb1", "cw2", "cb2", "scale")

# tests/test_pallas_knn_layer.py's option grid, plus the sparse caller's gate
# semantics and slot counts that are no multiple of 8
CASES = {
    "bare": dict(fourier=0, soft_edges=False, norm_coors=False, clamp=None),
    "fourier_norm_clamp": dict(fourier=2, soft_edges=False, norm_coors=True, clamp=2.0),
    "soft_norm": dict(fourier=0, soft_edges=True, norm_coors=True, clamp=None),
    "fourier4_soft_clamp": dict(fourier=4, soft_edges=True, norm_coors=False, clamp=1.0),
    "gate_feats_only": dict(fourier=0, soft_edges=True, norm_coors=True, clamp=1.5,
                            gate_feats_only=True),
    "k5": dict(fourier=0, soft_edges=False, norm_coors=True, clamp=2.0, k=5),
    "k12_b2": dict(fourier=2, soft_edges=True, norm_coors=True, clamp=2.0, k=12, b=2),
}


def _case(seed, b=1, n=96, k=8, c=3, d=8, fourier=0, m=16, self_pairs=False):
    """numpy inputs of both kernels on one neighbourhood: K10 reads the
    gathered rows and Wj, K11 ``proj_j = feats @ Wj`` and the ids."""
    rng = np.random.RandomState(seed)
    h, dd = 2 * (2 * d + 2 * fourier + 1), 2 * fourier + 1
    x = dict(
        coors=rng.randn(b, n, c), feats=0.5 * rng.randn(b, n, d),
        proj_i=0.3 * rng.randn(b, n, h), g_mi=rng.randn(b, n, m), g_cd=rng.randn(b, n, c))
    idx = (np.arange(n)[None, :, None] + rng.randint(1, n, size=(b, n, k))) % n
    if self_pairs:
        idx[..., 0] = np.arange(n)[None, :]
    x["idx"] = idx
    x["pv"] = rng.rand(b, n, k) > 0.25
    sc = 0.3
    x["weights"] = (
        sc * rng.randn(d, h), sc * rng.randn(dd, h), sc * rng.randn(h, m), sc * rng.randn(m),
        sc * rng.randn(m, 1), sc * rng.randn(1), sc * rng.randn(m, 4 * m),
        sc * rng.randn(4 * m), sc * rng.randn(4 * m, 1), sc * rng.randn(1), np.array([0.9]))
    return x


def _spec(case):
    spec = dict(CASES[case])
    shape = dict(k=spec.pop("k", 8), b=spec.pop("b", 1), fourier=spec["fourier"])
    return shape, spec


def _torch_args(x, gather, dtype):
    """The wrappers' tensors (K10: coors, cj, fj, proj_i, pv; K11: coors,
    proj_i, proj_j, idx, pv) and weights."""
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    idx = torch.from_numpy(x["idx"])
    b, n, k = idx.shape
    weights = tuple(t(w) for w in x["weights"])
    coors, feats = t(x["coors"]), t(x["feats"])
    if gather:
        return [coors, t(x["proj_i"]), feats @ weights[0], idx, torch.from_numpy(x["pv"])], \
            list(weights[1:])
    rows = lambda v: PM._gather_rows(v, idx).reshape(b, n * k, -1)  # noqa: E731
    return [coors, rows(coors), rows(feats), t(x["proj_i"]),
            t(x["pv"].reshape(b, n * k, 1))], list(weights)


def _jax_args(x, gather):
    j = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    b, n, k = x["idx"].shape
    weights = tuple(j(w) for w in x["weights"])
    if gather:
        return (j(x["coors"]), j(x["proj_i"]), j(x["feats"]) @ weights[0],
                jnp.asarray(x["idx"], jnp.int32), jnp.asarray(x["pv"], jnp.int32)), weights[1:]
    take = lambda v: jnp.take_along_axis(  # noqa: E731
        j(v)[:, :, None, :], jnp.asarray(x["idx"])[..., None], axis=1).reshape(b, n * k, -1)
    return (j(x["coors"]), take(x["coors"]), take(x["feats"]), j(x["proj_i"]),
            j(x["pv"].reshape(b, n * k, 1))), weights


def _jax_call(gather, opts):
    """f(tensors..., weights...) through the Pallas kernels in interpret mode."""
    static = (opts["fourier"], opts["soft_edges"], opts["norm_coors"], opts["clamp"], 1e-8, True)
    if gather:
        return lambda *a: jax_knn_messages(*a[:5], *static, *a[5:])
    static += (False, opts.get("gate_feats_only", False))
    return lambda *a: jax_pair_messages(*a[:5], *static, *a[5:])


def _torch_call(gather, opts):
    static = (opts["fourier"], opts["soft_edges"], opts["norm_coors"], opts["clamp"], 1e-8)
    if gather:
        return lambda *a: PM.fused_knn_messages(*a[:5], *static, *a[5:])
    static += (False, opts.get("gate_feats_only", False))
    return lambda *a: PM.fused_pair_messages(*a[:5], *static, *a[5:])


KERNELS = pytest.mark.parametrize("gather", [False, True], ids=["K10", "K11"])
# every case on both kernels; K11 has no gate_feats_only option, in either package
CASES_BY_KERNEL = pytest.mark.parametrize("case,gather", [
    pytest.param(case, gather, id=f"{case}-{'K11' if gather else 'K10'}")
    for case in sorted(CASES) for gather in (False, True)
    if not (gather and CASES[case].get("gate_feats_only"))])


@CASES_BY_KERNEL
def test_plain_forward_matches_the_pallas_kernel(case, gather):
    shape, opts = _spec(case)
    x = _case(0, **shape)
    tensors, weights = _torch_args(x, gather, torch.float32)
    m_i, cd = _torch_call(gather, opts)(*tensors, *weights)
    jt, jw = _jax_args(x, gather)
    jm, jc = _jax_call(gather, opts)(*jt, *jw)
    np.testing.assert_allclose(m_i.numpy(), np.asarray(jm), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(cd.numpy(), np.asarray(jc), rtol=2e-4, atol=2e-5)


@CASES_BY_KERNEL
def test_plain_backward_matches_jax_grad_of_the_pallas_kernel(case, gather):
    """Every input and weight gradient: the hand-derived plain backward in
    float32 against jax.grad through the Pallas forward and backward."""
    shape, opts = _spec(case)
    x = _case(1, n=64, **shape)
    tensors, weights = _torch_args(x, gather, torch.float32)
    diff = (0, 1, 2) if gather else (0, 1, 2, 3)
    leaves = [t.requires_grad_() if i in diff else t for i, t in enumerate(tensors)]
    ws = [w.requires_grad_() for w in weights]
    m_i, cd = _torch_call(gather, opts)(*leaves, *ws)
    g_mi, g_cd = (torch.from_numpy(x[key]).float() for key in ("g_mi", "g_cd"))
    wanted = [leaves[i] for i in diff] + ws
    tg = torch.autograd.grad((m_i * g_mi).sum() + (cd * g_cd).sum(), wanted)

    jt, jw = _jax_args(x, gather)
    call = _jax_call(gather, opts)
    jg_mi, jg_cd = jnp.asarray(x["g_mi"], jnp.float32), jnp.asarray(x["g_cd"], jnp.float32)

    def loss(*a):
        jm, jc = call(*a)
        return (jm * jg_mi).sum() + (jc * jg_cd).sum()

    argnums = diff + tuple(range(5, 5 + len(jw)))
    jg = jax.grad(loss, argnums=argnums)(*jt, *jw)
    names = ([("coors", "proj_i", "proj_j"), ("coors", "cj", "fj", "proj_i")][not gather]
             + WEIGHT_NAMES[1 if gather else 0:])
    for name, a, b_ in zip(names, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_).reshape(a.shape), rtol=5e-4,
                                   atol=5e-5, err_msg=f"gradient of {name}")


def _assert_close_scaled(a, b, name, tol=1e-10):
    scale = max(b.abs().max().item(), 1e-30)
    assert (a - b).abs().max().item() <= tol * scale, name


@pytest.mark.parametrize("self_pairs", [False, True], ids=["self_free", "self_pairs"])
@CASES_BY_KERNEL
def test_hand_derived_backward_matches_float64_autograd(case, gather, self_pairs):
    """The plain backward, called as the autograd.Function calls it, against
    torch autograd of the plain forward in float64. With self pairs (dist = 0
    <= eps^2: CoorsNorm's dead zone) the coordinate gradients carry
    scale / eps-sized terms, so every tensor is held relative to its own
    largest value."""
    shape, opts = _spec(case)
    x = _case(2, n=48, self_pairs=self_pairs, **shape)
    tensors, weights = _torch_args(x, gather, torch.float64)
    popts = PM.PairOptions(opts["fourier"], opts["soft_edges"], opts["norm_coors"], opts["clamp"],
                           1e-8, opts.get("gate_feats_only", False))
    g_mi, g_cd = torch.from_numpy(x["g_mi"]), torch.from_numpy(x["g_cd"])
    if gather:
        plain_f, plain_b = PM.fused_knn_messages_plain, PM.fused_knn_messages_backward_plain
        diff = (0, 1, 2)
    else:
        plain_f, plain_b = PM.fused_pair_messages_plain, PM.fused_pair_messages_backward_plain
        diff = (0, 1, 2, 3)
    hand = plain_b(*tensors, tuple(weights), g_mi, g_cd, popts)
    hand = list(hand[:-1]) + list(hand[-1])
    leaves = [t.clone().requires_grad_() if i in diff else t for i, t in enumerate(tensors)]
    ws = [w.clone().requires_grad_() for w in weights]
    m_i, cd = plain_f(*leaves, tuple(ws), popts)
    auto = torch.autograd.grad((m_i * g_mi).sum() + (cd * g_cd).sum(),
                               [leaves[i] for i in diff] + ws, allow_unused=True)
    assert len(hand) == len(auto)
    for i, (a, b_) in enumerate(zip(hand, auto)):
        if b_ is None:   # an unused dummy (gw, gb or scale): the hand gradient is zero
            assert not a.any()
            continue
        _assert_close_scaled(a.reshape(b_.shape), b_, f"gradient {i}")
    # and the Function's own backward is that plain backward
    leaves = [t.clone().requires_grad_() if i in diff else t for i, t in enumerate(tensors)]
    ws = [w.clone().requires_grad_() for w in weights]
    out = _torch_call(gather, opts)(*leaves, *ws)
    fn = torch.autograd.grad(out, [leaves[i] for i in diff] + ws, (g_mi, g_cd))
    for a, b_ in zip(fn, hand):
        assert torch.equal(a, b_.reshape(a.shape))


@KERNELS
def test_clamp_is_strict_and_masked_slots_get_no_gradient(gather):
    """A coordinate weight exactly at the clamp value is outside (strict
    ``inside``), so nothing flows through it into the coordinate-weight MLP;
    a slot with pv = 0 gets no gradient at all, and its rows stay finite."""
    x = _case(3, n=32, k=4)
    opts = dict(fourier=0, soft_edges=False, norm_coors=True, clamp=None)
    tensors, weights = _torch_args(x, gather, torch.float64)
    b, n, k = x["idx"].shape
    plain_b = PM.fused_knn_messages_backward_plain if gather \
        else PM.fused_pair_messages_backward_plain
    weights_wo_wj = weights if gather else weights[1:]
    cj = PM._gather_rows(tensors[0], torch.from_numpy(x["idx"]))
    hj = PM._gather_rows(tensors[2], torch.from_numpy(x["idx"])) if gather \
        else PM._pairs(tensors[2], n) @ weights[0]
    pv4 = torch.from_numpy(x["pv"])[..., None].double()
    unclamped = PM._tile_forward(tensors[0], cj, hj, tensors[1 if gather else 3], pv4,
                                 tuple(weights_wo_wj), PM.PairOptions(0, False, True, None, 1e-8))
    wm = unclamped["wm"][0, :, :, 0]
    node, slot = divmod(int(torch.argmax(wm.abs() * pv4[0, :, :, 0])), k)
    edge = abs(wm[node, slot].item())
    only = torch.zeros(b, n, k, dtype=torch.bool)
    only[0, node, slot] = True
    tensors[4] = only if gather else only.reshape(b, n * k, 1).double()
    zeros_mi = torch.zeros_like(torch.from_numpy(x["g_mi"]))
    g_cd = torch.from_numpy(x["g_cd"])

    def grads(clamp):
        popts = PM.PairOptions(0, False, True, clamp, 1e-8)
        out = plain_b(*tensors, tuple(weights), zeros_mi, g_cd, popts)
        return out[0], out[-1][-4], out[-1][-3]     # d_coors, d_cb1, d_cw2

    d_coors, d_cb1, d_cw2 = grads(edge)             # wm == clamp: outside
    assert not d_cb1.any() and not d_cw2.any() and d_coors.abs().max() > 0
    _, d_cb1, d_cw2 = grads(edge * (1 + 1e-9))      # just inside
    assert d_cb1.abs().max() > 0 and d_cw2.abs().max() > 0

    # pv = 0 slots: exactly zero j-side gradients (K10's pair layout shows them)
    if not gather:
        tensors[4] = torch.from_numpy(x["pv"].reshape(b, n * k, 1)).double()
        popts = PM.PairOptions(0, False, True, 2.0, 1e-8)
        out = plain_b(*tensors, tuple(weights), torch.from_numpy(x["g_mi"]), g_cd, popts)
        dead = ~torch.from_numpy(x["pv"]).reshape(b, n * k)
        assert dead.any() and not out[1][dead].any() and not out[2][dead].any()
        assert all(torch.isfinite(t).all() for t in out[:4])


@pytest.mark.parametrize("case", sorted(c for c in CASES if "gate_feats_only" not in c))
def test_k10_and_k11_agree_on_one_neighbourhood(case):
    """K11 is K10 with the gather inside: the same neighbourhood gives the
    same sums, and the j-side gradients of K10, summed per node, are K11's."""
    shape, opts = _spec(case)
    x = _case(4, n=40, **shape)
    out, grads = {}, {}
    for gather in (False, True):
        tensors, weights = _torch_args(x, gather, torch.float64)
        coors = tensors[0].requires_grad_()
        ws = [w.requires_grad_() for w in weights]
        if gather:   # proj_j = feats @ Wj stays in the graph on K11's side too
            feats = torch.from_numpy(x["feats"]).requires_grad_()
            tensors[2] = feats @ torch.from_numpy(x["weights"][0])
        m_i, cd = _torch_call(gather, opts)(*tensors, *ws)
        out[gather] = (m_i, cd)
        loss = (m_i * torch.from_numpy(x["g_mi"])).sum() + (cd * torch.from_numpy(x["g_cd"])).sum()
        grads[gather] = torch.autograd.grad(loss, ws[-10:])
    for a, b_ in zip(out[False], out[True]):
        torch.testing.assert_close(a, b_, rtol=0, atol=1e-12)
    for a, b_ in zip(grads[False], grads[True]):
        _assert_close_scaled(a, b_, "weight gradient", tol=1e-12)


def test_gates_state_the_kernels_own_limits():
    # anchor-3 and net65k widths, any slot count up to 64 (no multiple of 8 asked)
    for k in (1, 5, 8, 12, 16, 20, 64):
        assert PM.supports_fused_pair_messages(k, 130, 16, 32)
        assert PM.supports_fused_knn_layer(k, 130, 16)
    assert PM._tile_rows(8, 3, 32, 130, 16, 64, 0, False) == 64
    assert not PM.supports_fused_pair_messages(65, 130, 16, 32)
    assert not PM.supports_fused_pair_messages(8, 130, 16, 32, c=9)
    assert not PM.supports_fused_pair_messages(8, 130, 16, 32, fourier=17)
    # wider layers take a smaller tile (the sparse molecule layer: dim 64,
    # fourier 4, h = 274), and at last none
    wide = PM._tile_rows(8, 3, 64, 274, 16, 64, 4, False)
    assert wide is not None and 8 <= wide < 64 and wide % 4 == 0
    assert not PM.supports_fused_pair_messages(8, 1026, 16, 256)
    # the layout the gate sums is within the card's 227 KB at the tile it picks
    assert 4 * PM._smem_floats(64, 3, 32, 130, 16, 64, 0, False, True) <= PM.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# the host's copy of the kernels' shared-memory layout and tiles
# ---------------------------------------------------------------------------

_SOURCE = Path(PM.__file__).resolve().parents[2] / "csrc" / "pair_messages.cu"


# make_layout's regions in the source's order: name, and when the region is
# there (every other region aliases one before it, taking no floats)
_REGIONS = [("wj", None), ("wd", None), ("w2", None), ("b2", None), ("gw", None),
            ("cw1", None), ("cb1", None), ("cw2", None), ("misc", None), ("H", None),
            ("S", "backward"), ("X", None), ("DISTF", None), ("Z2", "backward"), ("M0", None),
            ("MSG", "soft_edges"), ("CZ1", None), ("REL", None), ("ROW", None), ("JDX", None),
            ("DM", "backward"), ("DREL", "backward"), ("DDF", "backward"),
            ("DCZ1", "backward"), ("ONES", "backward"), ("NXT", "forward")]


def _source_layout_total(rows, c, d, h, m, m4, fourier, soft_edges, backward, ti=1):
    """``make_layout(s, backward).total`` of the CUDA source: the size of
    each region read from its ``L.X = o; o += size;`` statement, the regions
    taken as ``_REGIONS`` says, the tile buffers aligned to a float4."""
    src = _SOURCE.read_text()
    body = src.split("inline Layout make_layout(const Shape& s, bool backward) {")[1]
    body = body.split("  return L;")[0]
    sizes = re.findall(r"L\.(\w+) = o; o \+= ([^;]+);", body)
    assert [name for name, _ in sizes] == [name for name, _ in _REGIONS]
    assert "o = (o + 3) & ~3;" in body.split("L.H = o;")[0]
    for stride in ("L.ld_h = odd(s.h);", "L.ld_m = odd(s.m);", "L.ld_m4 = odd(s.m4);",
                   "L.ldr = s.rows + 4;", "const int dd = 2 * s.fourier + 1;",
                   "L.ldn = s.d > 0 ? s.c + odd(s.d) + 1 : 3;"):
        assert stride in body
    shape = SimpleNamespace(rows=rows, c=c, d=d, h=h, m=m, m4=m4, fourier=fourier, ti=ti)
    lds = SimpleNamespace(ld_h=h | 1, ld_m=m | 1, ld_m4=m4 | 1, ldr=rows + 4,
                          ldn=c + (d | 1) + 1 if d > 0 else 3)
    scope = dict(s=shape, L=lds, dd=2 * fourier + 1,
                 kRowScalars=int(re.search(r"kRowScalars = (\d+);", src).group(1)))
    on = dict(backward=backward, forward=not backward, soft_edges=soft_edges)
    total = 0
    for (name, size), (_, when) in zip(sizes, _REGIONS):
        if name == "H":
            total = (total + 3) & ~3
        if when is None or on[when]:
            total += eval(size, {}, scope)  # noqa: S307 (a product of the names above)
    return total


LAYOUTS = [  # rows, c, d, h, m, m4, fourier, soft_edges: anchor 3 and the paths, K11 (d = 0),
    (32, 3, 32, 130, 16, 64, 0, False), (24, 3, 32, 130, 16, 64, 0, False),  # odd widths
    (64, 3, 32, 130, 16, 64, 0, False), (32, 3, 0, 130, 16, 64, 0, False),
    (8, 3, 64, 258, 16, 64, 0, False), (24, 5, 0, 74, 8, 32, 2, True),
    (32, 3, 10, 54, 12, 48, 3, True), (64, 8, 16, 66, 16, 64, 16, True),
    (32, 3, 64, 274, 16, 64, 4, False)]  # anchor 5's backward tile, both modes


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: "_".join(map(str, v)))
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_host_layout_mirrors_the_source(layout, backward):
    # the forward's staging region holds the tile's ti nodes' rows
    for ti in sorted({1, max(1, layout[0] // 16), layout[0] // 8}):
        assert PM._smem_floats(*layout, backward, ti) == \
            _source_layout_total(*layout, backward, ti)


# PR 5's backward layout, which kept every weight gradient in shared
# memory: the gates' limit, frozen here to hold them to the shapes they took
def _gate_floats_then(rows, c, d, h, m, m4, fourier, soft_edges):
    dd, ldr = 2 * fourier + 1, rows + 4
    odd = lambda x: x | 1  # noqa: E731
    total = (d * odd(h) + dd * odd(h) + h * odd(m) + 2 * m + m * odd(m4) + 2 * m4 + 3 + 3) & ~3
    total += ldr * (2 * h + d + m * (3 if soft_edges else 2) + m4 + c + dd + 10 + 1)
    grads = d * h + dd * h + h * m + m + m + 1 + m * m4 + m4 + m4 + 1 + 1
    return total + ldr * (m + c + dd) + grads


def _gate_then(k, c, d, h, m, fourier, soft_edges):
    if not (1 <= k <= 64 and 1 <= c <= 8 and 0 <= fourier <= 16):
        return False
    return any(rows >= k and 4 * _gate_floats_then(rows, c, d, h, m, 4 * m, fourier, soft_edges)
               <= 232448 for rows in range(64, 0, -8))


def _layouts_fit(k, c, d, h, m, fourier, soft_edges):
    """Whether the kernels launch at this shape within ``shape_ok``'s limits
    (c <= 8, fourier <= 16, tiles of 8 to 64 rows in steps of 8 holding
    whole nodes): some forward tile of rows // k nodes and some backward
    tile whose layouts fit one block's shared memory."""
    if not (1 <= k <= 64 and 1 <= c <= 8 and 0 <= fourier <= 16):
        return False
    tiles = [rows for rows in range(8, 65, 8) if rows >= k]
    fits = lambda rows, backward: 4 * PM._smem_floats(  # noqa: E731
        rows, c, d, h, m, 4 * m, fourier, soft_edges, backward, rows // k) <= PM.MAX_SMEM_BYTES
    return any(fits(r, False) for r in tiles) and any(fits(r, True) for r in tiles)


@pytest.mark.parametrize("k", [1, 5, 8, 12, 16, 20, 64])
@pytest.mark.parametrize("widths", [(130, 16, 32), (258, 16, 64), (1026, 16, 256)],
                         ids=["dim32", "dim64", "dim256"])
@pytest.mark.parametrize("fourier", [0, 4, 16])
@pytest.mark.parametrize("c", [3, 8, 9])
def test_gates_accept_the_shapes_they_accepted(k, widths, fourier, c):
    """The gates take every shape the legacy budget took, and exactly those
    whose launch layouts fit a block."""
    h, m, dim = widths
    for soft in (False, True):
        for d, gate_now in ((dim, PM.supports_fused_pair_messages(k, h, m, dim, c, fourier, soft)),
                            (0, PM.supports_fused_knn_layer(k, h, m, c, fourier, soft))):
            assert gate_now == _layouts_fit(k, c, d, h, m, fourier, soft)
            if _gate_then(k, c, d, h, m, fourier, soft):
                assert gate_now
            # the backward takes a tile wherever the gates pass, within the
            # kernel's own limits (shape_ok): whole nodes, a multiple of 8 rows
            rows = PM._bwd_tile_rows(k, c, d, h, m, 4 * m, fourier, soft)
            assert (rows is not None) == gate_now
            if rows is not None:
                assert rows % 8 == 0 and k <= rows <= PM.MAX_ROWS
                floats = PM._smem_floats(rows, c, d, h, m, 4 * m, fourier, soft, True)
                assert 4 * floats <= PM.MAX_SMEM_BYTES


@pytest.mark.parametrize("k,rows,nodes", [(8, 32, 4), (16, 32, 2), (20, 24, 1)],
                         ids=["anchor3_k8", "pathC_k16", "pathA_kc20"])
@pytest.mark.parametrize("gather", [False, True], ids=["K10", "K11"])
def test_backward_tile_fits_two_blocks_an_sm(k, rows, nodes, gather, monkeypatch):
    d = 0 if gather else 32
    assert PM._bwd_tile_rows(k, 3, d, 130, 16, 64, 0, False) == rows
    assert PM._BWD_BLOCKS_PER_SM == 2
    # the tile holds the whole nodes it was sized for, padded to 8 rows at most
    assert nodes >= 1 and nodes * k <= rows < nodes * k + 8
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))
    assert PM.launch_grid(1, 65536, k, rows, True, "cuda") == (nodes, 264)
    assert PM.launch_grid(1, 2 * nodes + 1, k, rows, True, "cuda") == (nodes, 3)
    nbytes = 4 * PM._smem_floats(rows, 3, d, 130, 16, 64, 0, False, True)
    # each block also holds 1 KB the card reserves; the SM has 228 KB
    assert PM._BWD_BLOCKS_PER_SM * (nbytes + 1024) <= PM.SM_SMEM_BYTES
    assert PM._BWD_BLOCKS_PER_SM * nbytes <= PM.MAX_SMEM_BYTES
    # the forward keeps its 64-row tile
    assert PM._tile_rows(k, 3, d, 130, 16, 64, 0, False) == 64


ANCHOR5 = (3, 64, 274, 16, 64, 4, False)   # c, d, h, m, 4m, fourier, soft_edges
DIM32 = (3, 32, 130, 16, 64, 0, False)


def _bwd_tile_then(k, c, d, h, m, m4, fourier, soft_edges, mxu_bf16):
    """The backward's tile before both modes took one rule, frozen here: the
    float32 mode fell to one node where two blocks an SM held no tile, the
    tensor-core mode took the largest tile one block holds where two held
    none of 16 rows or more."""
    if PM._tile_rows(k, c, d, h, m, m4, fourier, soft_edges) is None:
        return None
    floats = lambda rows: PM._smem_floats(  # noqa: E731
        rows, c, d, h, m, m4, fourier, soft_edges, True)
    tiles = [-(-ti * k // 8) * 8 for ti in range(max(1, 32 // k), 0, -1)]
    two = [rows for rows in tiles if PM._fits_sm(floats(rows), 2)]
    if two and (two[0] >= 16 or not mxu_bf16):
        return two[0]
    one = [rows for rows in tiles if PM._fits_sm(floats(rows), 1)]
    if mxu_bf16:
        return one[0] if one else None
    return tiles[-1] if tiles[-1] in one else None


@pytest.mark.parametrize("k,widths,rows_f32,rows_mode,blocks_mode", [
    (8, ANCHOR5, 32, 32, 1), (8, DIM32, 32, 32, 2), (16, DIM32, 32, 32, 2),
    (20, DIM32, 24, 24, 2)], ids=["anchor5", "anchor3", "pathC_k16", "pathA_kc20"])
def test_backward_tile_in_the_tensor_core_mode(k, widths, rows_f32, rows_mode, blocks_mode,
                                               monkeypatch):
    """Both modes' K10b take one tile: where two blocks an SM hold no tile of
    16 rows or more (anchor 5's widths), the largest tile of whole nodes up
    to 32 rows that one block holds, the grid sized by the one block an SM
    (the mode's m16 fragments full; the float32 mode's fixed costs a tile
    paid for 32 rows, not 8); elsewhere the tile both had."""
    assert PM._bwd_tile_rows(k, *widths) == rows_f32 == rows_mode
    assert PM._bwd_blocks_per_sm(rows_mode, *widths) == blocks_mode
    floats = PM._smem_floats(rows_mode, *widths, True)
    assert floats == _source_layout_total(rows_mode, *widths, True)
    assert 4 * floats <= PM.MAX_SMEM_BYTES
    assert PM._fits_sm(floats, blocks_mode) and not PM._fits_sm(floats, blocks_mode + 1)
    if widths == ANCHOR5:
        assert 4 * floats == 222400
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))
    n = 16384   # anchor 5 at G = 512: 512 molecules of 32 nodes
    tiles = -(-n // (rows_mode // k))
    assert PM.launch_grid(1, n, k, rows_mode, True, "cuda", blocks_mode) == (
        rows_mode // k, min(tiles, 132 * blocks_mode))
    # the float32 grid by the blocks one SM holds: 132 at anchor 5, 264 elsewhere
    assert PM.launch_grid(1, n, k, rows_f32, True, "cuda", blocks_mode)[1] == (
        132 if widths == ANCHOR5 else 264)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: "_".join(map(str, v)))
@pytest.mark.parametrize("k", [8, 16])
def test_tensor_core_mode_keeps_the_float32_tile_where_two_blocks_hold_16_rows(layout, k):
    widths = layout[1:]
    f32 = _bwd_tile_then(k, *widths, False)
    mode = PM._bwd_tile_rows(k, *widths)
    assert (f32 is None) == (mode is None)
    if f32 is None:
        return
    floats = lambda rows: PM._smem_floats(rows, *widths, True)  # noqa: E731
    if f32 >= 16 and PM._fits_sm(floats(f32), PM._BWD_BLOCKS_PER_SM):
        assert mode == f32
    else:   # the largest tile of whole nodes up to _BWD_ROWS rows that one block holds
        tiles = [-(-ti * k // 8) * 8 for ti in range(max(1, PM._BWD_ROWS // k), 0, -1)]
        assert mode == next(rows for rows in tiles if PM._fits_sm(floats(rows), 1))
        assert mode >= f32
    assert mode % 8 == 0 and k <= mode <= PM.MAX_ROWS
    assert floats(mode) == _source_layout_total(mode, *widths, True)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda v: "_".join(map(str, v)))
@pytest.mark.parametrize("k", [1, 5, 8, 12, 16, 20])
def test_one_backward_tile_rule_for_both_modes(layout, k):
    """One rule for the backward's tile and grid in both modes: where two
    blocks an SM hold no tile of 16 rows or more, the float32 tile and its
    blocks an SM are what the tensor-core mode's were (the largest tile one
    block holds, one block an SM); everywhere else the float32 tile is what
    it was (anchor 3's 32 rows, path C's 32, path A's 24), at two blocks an
    SM. The source picks its one-block instance by the same test."""
    widths = layout[1:]
    rows = PM._bwd_tile_rows(k, *widths)
    f32, mode = _bwd_tile_then(k, *widths, False), _bwd_tile_then(k, *widths, True)
    assert (rows is None) == (f32 is None) == (mode is None)
    if rows is None:
        return
    floats = lambda r: PM._smem_floats(r, *widths, True)  # noqa: E731
    two = [r for r in (-(-ti * k // 8) * 8 for ti in range(max(1, 32 // k), 0, -1))
           if PM._fits_sm(floats(r), 2)]
    per_sm = PM._bwd_blocks_per_sm(rows, *widths)
    assert rows == mode
    if two and two[0] >= 16:
        assert rows == f32 and per_sm == 2
    else:
        assert per_sm == (2 if PM._fits_sm(floats(rows), 2) else 1)
    # bwd_kernel's test: two blocks and the card's 1 KB each in an SM's shared memory
    assert (per_sm == 1) == (2 * (4 * floats(rows) + 1024) > PM.SM_SMEM_BYTES)
    assert floats(rows) == _source_layout_total(rows, *widths, True)
    if widths == DIM32 and k in (8, 16, 20):
        assert rows == {8: 32, 16: 32, 20: 24}[k]


@pytest.mark.parametrize("shape,rows,nodes", [
    ((1, 1024, 8), 32, 4), ((8, 1024, 8), 64, 8), ((1, 65536, 16), 64, 4),
    ((1, 65536, 20), 64, 3)], ids=["anchor3_b1", "anchor3_b8", "pathC_k16", "pathA_kc20"])
@pytest.mark.parametrize("gather", [False, True], ids=["K10", "K11"])
def test_forward_tile_is_sized_to_the_pairs_and_fits_two_blocks_an_sm(shape, rows, nodes,
                                                                       gather, monkeypatch):
    b, n, k = shape
    d = 0 if gather else 32
    got = PM._fwd_tile_rows(b, n, k, 3, d, 130, 16, 64, 0, False, 132)
    assert got == rows and got // k == nodes
    # whole nodes, a multiple of 8 rows, never more than the gates' tile
    assert got % 8 == 0 and nodes * k <= got < nodes * k + 8
    assert got <= PM._tile_rows(k, 3, d, 130, 16, 64, 0, False)
    # two blocks an SM, each with the 1 KB the card reserves, and one alone
    nbytes = 4 * PM._smem_floats(got, 3, d, 130, 16, 64, 0, False, False, nodes)
    assert PM._FWD_BLOCKS_PER_SM == 2
    assert PM._FWD_BLOCKS_PER_SM * (nbytes + 1024) <= PM.SM_SMEM_BYTES
    assert nbytes <= PM.MAX_SMEM_BYTES
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))
    ti, grid = PM.launch_grid(b, n, k, got, False, "cuda")
    assert ti == nodes and grid == min(b * -(-n // nodes), 264)


@pytest.mark.parametrize("sms", [132, 114])
def test_forward_tile_fills_the_block_slots_at_anchor_3(sms):
    """Anchor 3's 8192 pairs: the gates' 64-row tile makes 128 tiles, half
    the block slots of an H100 or fewer. The forward's tile takes fewer
    nodes so that the tiles fill more slots, in one wave of blocks where
    one wave holds them."""
    b, n, k = 1, 1024, 8
    slots = sms * PM._FWD_BLOCKS_PER_SM
    rows = PM._fwd_tile_rows(b, n, k, 3, 32, 130, 16, 64, 0, False, sms)
    tiles = b * -(-n // (rows // k))
    gate_tiles = b * -(-n // (PM._tile_rows(k, 3, 32, 130, 16, 64, 0, False) // k))
    assert gate_tiles < slots          # the gates' tile leaves slots empty
    assert slots // 2 < tiles <= slots  # one wave, more than half the slots busy
    assert rows < 64


@pytest.mark.parametrize("k", [1, 5, 8, 12, 16, 20, 64])
@pytest.mark.parametrize("widths", [(130, 16, 32), (258, 16, 64)], ids=["dim32", "dim64"])
@pytest.mark.parametrize("fourier", [0, 16])
def test_forward_takes_a_tile_wherever_the_gates_pass(k, widths, fourier):
    h, m, dim = widths
    for soft in (False, True):
        for d in (dim, 0):
            gate = PM._tile_rows(k, 3, d, h, m, 4 * m, fourier, soft)
            for b, n in ((1, 1), (1, 1000), (4, 70000)):
                rows = PM._fwd_tile_rows(b, n, k, 3, d, h, m, 4 * m, fourier, soft, 132)
                assert (rows is None) == (gate is None)
                if rows is not None:
                    assert rows % 8 == 0 and k <= rows <= gate
                    floats = PM._smem_floats(rows, 3, d, h, m, 4 * m, fourier, soft, False,
                                             rows // k)
                    assert 4 * floats <= PM.MAX_SMEM_BYTES


def test_wrappers_refuse_what_is_not_ported():
    x = _case(5, n=16, k=4)
    tensors, weights = _torch_args(x, False, torch.float32)
    with pytest.raises(ValueError, match="11 weights"):
        PM.fused_pair_messages(*tensors, 0, False, True, 2.0, 1e-8, False, False, *weights[1:])
    with pytest.raises(ValueError, match="no fused pair kernel"):
        PM._on_card(torch.empty(1, device="meta"))


# every shape of this grid that the gates take: (k, (h, m, d), fourier)
MODE_FIT_SHAPES = [
    (k, widths, fourier) for k in (1, 5, 8, 12, 16, 20, 64)
    for widths in ((130, 16, 32), (258, 16, 64), (274, 16, 64), (18, 4, 4), (54, 12, 10),
                   (1026, 16, 256))
    for fourier in (0, 3, 4, 16)
    if PM.supports_fused_pair_messages(k, widths[0], widths[1], widths[2], 3, fourier)]


@pytest.mark.parametrize("k,widths,fourier", MODE_FIT_SHAPES,
                         ids=lambda v: "_".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_tensor_core_mode_forward_fits_wherever_the_gates_pass(k, widths, fourier):
    """The mode's K10f keeps its weights' bf16 copies and its bf16 rows in
    the places of the f32 forward's copies and lines (``_mode_fwd_fits``,
    the mirror of the source's ``bf16_copies`` and ``mode_rows``): on every
    tile the forward may take where the gates pass, so that no shape they
    take is refused at launch in the mode."""
    h, m, d = widths
    gate = PM._tile_rows(k, 3, d, h, m, 4 * m, fourier, False)
    for rows in range(gate, 0, -8):
        if rows >= k:
            assert PM._mode_fwd_fits(rows, d, h, m, 4 * m, fourier), rows
