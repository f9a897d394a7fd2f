"""The tensor-core mode (``mxu_bf16``) of the fused pair kernel K10, on the
CPU: the port's plain versions in the mode (``egnn_tpu_torch/ops/cuda/
pair_messages.py``: ``_mm``, ``_dG``) against the JAX package's Pallas
kernel in interpret mode with ``mxu_bf16=True``, forward and every
gradient; the fused layers of both families in the mode, the JAX side
switched by patching its kernel's entry point for the test's duration; and
``mxu_bf16_for``, the switch of the port's layers.

Tolerances, relative to each tensor's largest magnitude. The forward holds
1e-5: both sides round the same float32 operands to bfloat16 and add exact
products in float32, in other orders (measured: 3.0e-7 at most here, 1.2e-6
over three seeds). The mode differs from float32 by 8.1e-4 to 2.9e-2 there,
and each case asserts more than 1e-4. Gradients hold 1e-3: the backward
rounds values it computed itself (d_z2, d_h1, the recomputed s1), and where
such a value lies within a float32 rounding of a bfloat16 tie the two sides
round it apart, one bfloat16 step, whose effect reaches 2.2e-4 of a
gradient's largest value in these cases; the mode differs from float32 by
4.8e-3 to 0.19 there, and each case asserts more than the tolerance. The
layers and the network hold 1e-4 of the largest value, outputs and
gradients, with the JAX side in float32 (x64 off for the call) as the
port's modules are: then both kernels get the same float32 inputs up to
rounding (measured: 3.7e-5 at most; the mode moves the outputs by 3.6e-4 to
1.1e-3, asserted above the tolerance, and most gradients by 1e-4 to 1e-2).
With x64 on, the JAX layers compute the kernel's inputs in float64, and the
roundings to bfloat16 part more often (2.9e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egnn_tpu
from egnn_tpu.ops.pallas import pair_messages as jax_pm
from egnn_tpu_torch import EGNN, EGNNNetwork, EGNNSparse
from egnn_tpu_torch.ops.cuda import pair_messages as PM
from egnn_tpu_torch.ops.graph import knn_graph
from egnn_tpu_torch.utils.port_weights import load_flax_params
from test_torch_pair_messages import CASES, WEIGHT_NAMES, _case, _jax_args, _torch_args

FWD_TOL, FWD_GAP = 1e-5, 1e-4
GRAD_TOL = 1e-3
LAYER_TOL = 1e-4
F32 = dict(device="cpu", dtype=torch.float32)

# CASES of the f32 tests, and two that reach the rules' other branches: d = 4
# (fj @ Wj and its gradients stay f32) and m = 4 (the gate's product, cmsg @
# cW1 and the backward's d_z2 @ W2^T stay f32)
MODE_CASES = {name: (dict(spec), {}) for name, spec in CASES.items()}
MODE_CASES["d4_soft_norm"] = (dict(fourier=0, soft_edges=True, norm_coors=True, clamp=2.0),
                              dict(d=4))
MODE_CASES["m4_soft_fourier"] = (dict(fourier=2, soft_edges=True, norm_coors=False, clamp=None),
                                 dict(m=4))


def _mode_case(name, seed, **size):
    spec, widths = MODE_CASES[name]
    spec = dict(spec)
    shape = dict(k=spec.pop("k", 8), b=spec.pop("b", 1), fourier=spec["fourier"])
    return _case(seed, **shape, **widths, **size), spec


def _static(opts):
    return (opts["fourier"], opts["soft_edges"], opts["norm_coors"], opts["clamp"], 1e-8)


def _rel(a, b):
    """max |a - b| over the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _port(x, opts, mode, grads=False):
    """The port's K10 (plain versions on the CPU): (m_i, cd) and, with
    ``grads``, the gradients of the inputs and the eleven weights."""
    tensors, weights = _torch_args(x, False, torch.float32)
    gfo = opts.get("gate_feats_only", False)
    diff = (0, 1, 2, 3)
    leaves = [t.requires_grad_() if i in diff and grads else t for i, t in enumerate(tensors)]
    ws = [w.requires_grad_(grads) for w in weights]
    m_i, cd = PM.fused_pair_messages(*leaves, *_static(opts), mode, gfo, *ws)
    if not grads:
        return m_i.detach().numpy(), cd.detach().numpy()
    g_mi, g_cd = (torch.from_numpy(x[key]).to(torch.float32) for key in ("g_mi", "g_cd"))
    out = torch.autograd.grad((m_i * g_mi).sum() + (cd * g_cd).sum(),
                              [leaves[i] for i in diff] + ws)
    return [g.numpy() for g in out]


def _jax(x, opts, mode, grads=False):
    """The JAX package's K10 in interpret mode, as ``_port``."""
    jt, jw = _jax_args(x, False)
    gfo = opts.get("gate_feats_only", False)

    def call(*a):
        return jax_pm.fused_pair_messages(*a[:5], *_static(opts), True, mode, gfo, *a[5:])

    if not grads:
        return tuple(np.asarray(o) for o in call(*jt, *jw))
    g_mi, g_cd = (jnp.asarray(x[key], jnp.float32) for key in ("g_mi", "g_cd"))

    def loss(*a):
        m_i, cd = call(*a)
        return (m_i * g_mi).sum() + (cd * g_cd).sum()

    out = jax.grad(loss, argnums=tuple(range(4)) + tuple(range(5, 16)))(*jt, *jw)
    return [np.asarray(g) for g in out]


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_plain_forward_in_the_mode_matches_the_pallas_kernel(case):
    x, opts = _mode_case(case, 0)
    got, want = _port(x, opts, True), _jax(x, opts, True)
    exact = _port(x, opts, False)
    for name, g, w, e in zip(("m_i", "coors_delta"), got, want, exact):
        assert _rel(g, w) <= FWD_TOL, name
        assert _rel(e, w) > FWD_GAP, f"{name}: the mode does not round"


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_plain_backward_in_the_mode_matches_jax_grad(case):
    """Every input and weight gradient of the hand-derived backward in the
    mode against jax.grad through the Pallas kernel's mode, forward and
    backward; the gradients of the unused dummies (gw, gb without the gate,
    scale without CoorsNorm) are zero on both sides."""
    x, opts = _mode_case(case, 1, n=64)
    got, want = _port(x, opts, True, grads=True), _jax(x, opts, True, grads=True)
    exact = _port(x, opts, False, grads=True)
    names = ("coors", "cj", "fj", "proj_i") + WEIGHT_NAMES
    gap = 0.0
    for name, g, w, e in zip(names, got, want, exact):
        w = w.reshape(g.shape)
        if not np.abs(w).max():
            assert not np.abs(g).max(), name
            continue
        assert _rel(g, w) <= GRAD_TOL, name
        gap = max(gap, _rel(e, w))
    assert gap > GRAD_TOL, "the mode's gradients do not round"


def test_rules_read_the_widths():
    """Which products round: the forward at a contraction of 8 or more, the
    backward where every width reaches 8 (the narrow d = 4 and m = 4 cases
    take the other branches)."""
    opts = PM.PairOptions(0, False, False, None, 1e-8, mxu_bf16=True)
    a = torch.tensor([[1.0 + 2.0 ** -10] * 8], dtype=torch.float32)
    w = torch.ones(8, 1, dtype=torch.float32)
    assert PM._mm(a, w, opts).item() == 8.0                     # rounded
    assert PM._mm(a[:, :7], w[:7], opts).item() > 7.0           # 7: exact
    assert PM._mm(a, w, opts._replace(mxu_bf16=False)).item() > 8.0
    assert PM._dG(a, w, opts, 8, 8).item() == 8.0
    assert PM._dG(a, w, opts, 8, 1).item() > 8.0                # a one-column width
    # ties to even, as the card's __float2bfloat16_rn
    ties = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8], dtype=torch.float32)
    assert PM._bf16(ties).tolist() == [1.0, 1.0 + 2.0 ** -6]


def test_mxu_bf16_for_follows_the_matmul_precision():
    before = torch.get_float32_matmul_precision()
    try:
        for precision in ("highest", "high", "medium"):
            torch.set_float32_matmul_precision(precision)
            assert not PM.mxu_bf16_for(torch.device("cpu"))
            assert not PM.mxu_bf16_for(torch.zeros(1, dtype=torch.float32).device)
            assert PM.mxu_bf16_for(torch.device("cuda")) == (precision == "medium")
            assert PM.mxu_bf16_for("cuda:0") == (precision == "medium")
    finally:
        torch.set_float32_matmul_precision(before)


# ---------------------------------------------------------------------------
# the layers in the mode: the port forced by ``mxu_bf16_for``, the JAX package
# by its kernel's entry point called with interpret=True, mxu_bf16=True
# ---------------------------------------------------------------------------


@pytest.fixture
def mode(monkeypatch):
    """Both packages' fused layers in the mode; records the modes the
    port's calls asked for, and the JAX kernel's calls."""
    calls = {"port": [], "jax": 0}
    real_jax = jax_pm.fused_pair_messages

    def jax_in_mode(*a):
        calls["jax"] += 1
        a = list(a)
        a[10], a[11] = True, True     # interpret, mxu_bf16
        return real_jax(*a)

    real = PM.fused_pair_messages

    def counted(*a):
        calls["port"].append(a[10])
        return real(*a)

    monkeypatch.setattr(jax_pm, "fused_pair_messages", jax_in_mode)
    monkeypatch.setattr(PM, "mxu_bf16_for", lambda device: True)
    monkeypatch.setattr(PM, "fused_pair_messages", counted)
    return calls


def _flax_params(module, *args, **kwargs):
    with jax.enable_x64(False):
        variables = jax.jit(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs))(*args)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _compare(jmod, tmod, params, jargs, targs, diff, tkw=None, jkw=None, seed=3):
    """Output and the gradients of a random cotangent with respect to the
    ``diff``-th argument and every parameter, port against JAX, each within
    LAYER_TOL of its largest magnitude; returns the port's output."""
    tkw, jkw = tkw or {}, jkw or {}
    load_flax_params(tmod, params)
    targs = list(targs)
    targs[diff] = targs[diff].clone().requires_grad_()
    out_t = tmod(*targs, **tkw)
    outs_t = out_t if isinstance(out_t, tuple) else (out_t,)
    cots = [np.random.RandomState(seed + i).randn(*o.shape).astype(np.float32)
            for i, o in enumerate(outs_t)]

    def apply(p, xx):
        a = list(jargs)
        a[diff] = xx
        out = jmod.apply({"params": p}, *a, **jkw)
        return out if isinstance(out, tuple) else (out,)

    @jax.jit
    def out_and_grads(p, xx, cot):
        outs, vjp = jax.vjp(apply, p, xx)
        return outs, vjp(cot)

    with jax.enable_x64(False):
        outs_j, (gp_j, gx_j) = out_and_grads(params, jargs[diff],
                                             tuple(jnp.asarray(c) for c in cots))
    for o_t, o_j in zip(outs_t, outs_j):
        assert _rel(o_t.detach().numpy(), o_j) <= LAYER_TOL, "output"
    names, leaves = zip(*tmod.named_parameters())
    g_t = torch.autograd.grad(outs_t, (targs[diff],) + leaves,
                              [torch.from_numpy(c) for c in cots], allow_unused=True)
    assert _rel(g_t[0].numpy(), gx_j) <= LAYER_TOL, "input"
    flat = _flat(gp_j)
    for name, leaf, g in zip(names, leaves, g_t[1:]):
        if not np.abs(flat[name]).max():
            continue
        g = torch.zeros_like(leaf) if g is None else g
        assert _rel(g.numpy(), flat[name]) <= LAYER_TOL, name
    return outs_t


def test_fused_pairs_network_in_the_mode_matches_jax(mode, monkeypatch):
    """A depth-2 ``EGNNNetwork(fused_pairs=True)`` in the anchor-3
    arrangement (tokens, node mask, chain adjacency, clamp) with the soft
    gate: output and the gradients of the coordinates and every parameter;
    the same network in float32 differs by more than the tolerance. Without
    CoorsNorm: every kNN row holds its own node, and under CoorsNorm that
    pair's +-scale / eps terms cancel in the coordinate gradients only to
    float32 rounding (2e-2 of their largest value here, in either mode), in
    other orders on the two sides."""
    n = 64
    rng = np.random.RandomState(12)
    tokens = rng.randint(0, 21, size=(2, n))
    coors = (2.0 * rng.randn(2, n, 3)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([[n], [48]])
    adj = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1
    layer = dict(num_nearest_neighbors=8, soft_edges=True, coor_weights_clamp_value=2.0,
                 init_eps=0.1, fused_pairs=True)
    net = dict(depth=2, dim=16, num_tokens=21, num_positions=n, layer_kwargs=layer)
    jnet = egnn_tpu.EGNNNetwork(**net)
    jargs = (tokens, coors)
    jkw = dict(adj_mat=adj, mask=mask)
    params = _flax_params(jnet, *jargs, **jkw)
    tnet = EGNNNetwork(**net, **F32)
    targs = (torch.from_numpy(tokens), torch.from_numpy(coors))
    tkw = dict(adj_mat=torch.from_numpy(adj), mask=torch.from_numpy(mask))
    out = _compare(jnet, tnet, params, jargs, targs, 1, tkw, jkw)
    assert mode["port"] == [True, True] and mode["jax"] >= 2   # a call a layer
    monkeypatch.setattr(PM, "mxu_bf16_for", lambda device: False)
    with torch.no_grad():
        exact = tnet(*targs, **tkw)
    assert mode["port"][2:] == [False, False]
    for a, e in zip(out, exact):
        assert _rel(a.detach().numpy(), e.numpy()) > LAYER_TOL


def _molecules(seed, d, g=3, na=12, k=4):
    rng = np.random.RandomState(seed)
    n = g * na
    coors = 1.5 * rng.randn(n, 3)
    node_mask = np.ones(n, bool)
    for i in range(g):
        node_mask[i * na + rng.randint(na - 3, na + 1):(i + 1) * na] = False
    es = knn_graph(torch.from_numpy(coors), k, node_mask=torch.from_numpy(node_mask),
                   graph_size=na)
    x = np.concatenate([coors, rng.randn(n, d)], axis=-1).astype(np.float32)
    return x, es.edge_index.numpy(), dict(
        edge_mask=es.mask.numpy(), batch=np.repeat(np.arange(g), na), node_mask=node_mask,
        num_graphs=g)


def test_fused_uniform_layer_in_the_mode_matches_jax(mode, monkeypatch):
    """One ``EGNNSparse`` layer under ``fused_uniform`` (the sparse gate
    semantics, soft edges, CoorsNorm, Fourier features, mean): output and the
    gradients of x and every parameter."""
    d, k = 16, 8
    x, edge_index, kw = _molecules(13, d, k=k)
    opts = dict(feats_dim=d, uniform_degree=k, soft_edge=1, norm_coors=True, fourier_features=2,
                aggr="mean", fused_uniform=True)
    jmod = egnn_tpu.EGNNSparse(**opts)
    jkw, jargs = kw, (x, edge_index)
    params = _flax_params(jmod, *jargs, **jkw)
    tkw = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for key, v in kw.items()}
    tmod = EGNNSparse(**opts, **F32)
    targs = (torch.from_numpy(x), torch.from_numpy(edge_index))
    out = _compare(jmod, tmod, params, jargs, targs, 0, tkw, jkw)
    assert mode["port"] == [True] and mode["jax"] >= 1
    monkeypatch.setattr(PM, "mxu_bf16_for", lambda device: False)
    with torch.no_grad():
        exact = tmod(*targs, **tkw)
    assert _rel(out[0].detach().numpy(), exact.numpy()) > LAYER_TOL


def test_fused_knn_has_no_mode(monkeypatch):
    """K11 has no tensor-core mode in either package: a ``fused_knn`` layer
    gives the same bits with the mode forced and without it."""
    rng = np.random.RandomState(14)
    feats = torch.from_numpy(rng.randn(2, 40, 16).astype(np.float32))
    coors = torch.from_numpy(rng.randn(2, 40, 3).astype(np.float32))
    layer = EGNN(dim=16, num_nearest_neighbors=8, norm_coors=True, fused_knn=True, **F32,
                 generator=torch.Generator().manual_seed(5))
    plain = [t.detach() for t in layer(feats, coors)]
    monkeypatch.setattr(PM, "mxu_bf16_for", lambda device: True)
    forced = [t.detach() for t in layer(feats, coors)]
    for a, b_ in zip(forced, plain):
        assert torch.equal(a, b_)


# ---------------------------------------------------------------------------
# the mode's ties (``pair_messages.mode_tie_pairs``), which chip_smoke.py's
# phase 43 takes out of a case for its tie-free rerun
# ---------------------------------------------------------------------------

F64 = dict(device="cpu", dtype=torch.float64)


def test_bf16_boundary_distance_on_hand_made_values():
    """Exactly on a bf16 midpoint (where rounding to nearest turns): 0; on a
    bf16 value: half a bf16 step; the boundary below a power of two lies a
    quarter step of the binade above under it; 0 is no tie."""
    values = torch.tensor([1.25, 1.5, -3.0, 3 * 2.0 ** -21, 1000.0], **F64)
    step = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 2.0 ** -27, 4.0], **F64)
    mid = values + step / 2
    assert torch.equal(PM.bf16_boundary_distance(mid), torch.zeros_like(mid))
    assert torch.equal(PM._bf16(mid + step * 2.0 ** -10), values + step)   # the midpoint turns
    assert torch.equal(PM.bf16_boundary_distance(values), step / 2)
    below = torch.tensor([2.0 - 2.0 ** -8], **F64)       # the boundary under 2
    assert PM.bf16_boundary_distance(below).item() == 0.0
    assert PM.bf16_boundary_distance(torch.tensor([2.0], **F64)).item() == 2.0 ** -8
    assert PM.bf16_boundary_distance(torch.zeros(1, **F64)).item() == float("inf")


def test_within_reach_flags_midpoints_and_the_clamp_not_a_step_away():
    """A value on a bf16 midpoint, or a weight at +-clamp, whose float32
    samples stray from it by a float32 rounding, is flagged; the same a bf16
    step away (half a step from the nearest midpoint) is not."""
    gen = torch.Generator().manual_seed(0)
    mids = (torch.randint(128, 256, (64,), generator=gen).to(torch.float64) + 0.5) * 2.0 ** -7
    mids = mids * torch.where(torch.rand(64, generator=gen) < 0.5, -1.0, 1.0).double()
    samples = [mids * (1 + s * 2.0 ** -23) for s in (1, -2, 3)]
    near = PM.within_reach(mids, samples, PM.bf16_boundary_distance(mids))
    assert bool(near.all())
    away = mids + mids.sign() * 2.0 ** -8          # half a bf16 step: a bf16 value
    samples_away = [away * (1 + s * 2.0 ** -23) for s in (1, -2, 3)]
    assert not bool(PM.within_reach(away, samples_away, PM.bf16_boundary_distance(away)).any())
    clamp = 2.0
    wm = torch.tensor([clamp, -clamp, clamp * (1 + 2.0 ** -7), -clamp * (1 - 2.0 ** -8)], **F64)
    jitter = [wm * (1 + s * 2.0 ** -23) for s in (1, -1)]
    assert PM.within_reach(wm, jitter, (wm.abs() - clamp).abs()).tolist() == [
        True, True, False, False]


def _mode_args(x, dtype=torch.float64):
    tensors, weights = _torch_args(x, False, dtype)
    g = [torch.from_numpy(x[key]).to(dtype) for key in ("g_mi", "g_cd")]
    return tensors, tuple(weights), g


def _opts(spec):
    return PM.PairOptions(spec["fourier"], spec["soft_edges"], spec["norm_coors"], spec["clamp"],
                          1e-8, spec.get("gate_feats_only", False), True)


def test_mode_tie_pairs_flags_a_value_placed_on_a_midpoint_and_the_clamp():
    """A case whose pair p has s1 at feature j placed on a bf16 midpoint (by
    its node's proj_i) and whose clamp is pair q's |wz * pv|: p is a
    rounding tie there and q a clamp tie; placed a bf16 step away, neither."""
    x, spec = _mode_case("fourier_norm_clamp", 5)
    opts = _opts(spec)
    tensors, weights, g = _mode_args(x)
    coors, cj, fj, proj_i, pv = tensors
    b, n, k = x["idx"].shape
    live = np.flatnonzero(x["pv"].reshape(-1))
    p, q, j = int(live[3]), int(live[11]), 5

    def forward(proj):
        return PM._tile_forward(coors, PM._pairs(cj, n),
                                PM._mm(PM._pairs(fj, n), weights[0], opts), proj,
                                PM._pairs(pv, n), weights[1:], opts)

    def silu_inverse(y, x0):
        for _ in range(60):   # Newton on silu(x) = y, x > 0
            s = 1 / (1 + np.exp(-x0))
            x0 -= (x0 * s - y) / (s * (1 + x0 * (1 - s)))
        return x0

    h1 = forward(proj_i)["h1"].reshape(b * n * k, -1)[p, j].item()
    for offset, tie in ((0.5, True), (0.0, False)):     # a midpoint; a bf16 value
        target = (160 + offset) * 2.0 ** -7                # in [1.25, 1.26], where s1 is
        moved = proj_i.clone()
        moved[0, p // k, j] += silu_inverse(target, 1.5) - h1
        t = forward(moved)
        assert abs(t["s1"].reshape(b * n * k, -1)[p, j].item() - target) < 1e-12
        clamp_at = abs(t["wm"].reshape(-1)[q].item()) * (1.0 if tie else 1 + 2.0 ** -7)
        detail = {}
        rounding, clamp = PM.mode_tie_pairs(coors, cj, fj, moved, pv, weights, *g,
                                            opts._replace(clamp=clamp_at), detail=detail)
        assert bool(detail["s1"].reshape(b * n * k, -1)[p, j]) == tie
        assert bool(detail["wm"].reshape(-1)[q]) == tie
        assert bool(clamp.reshape(-1)[q]) == tie
        if tie:
            assert bool(rounding.reshape(-1)[p])
        assert not bool((rounding | clamp)[~torch.from_numpy(x["pv"])].any())   # live pairs only


def test_masking_the_ties_equals_the_plain_version_over_the_other_pairs():
    """The plain version in the mode with the flagged pairs' pv set to 0
    equals, in float64, the plain version run node by node over the other
    pairs alone: outputs, every input gradient (zero at a flagged pair) and
    every weight gradient (summed over the nodes)."""
    x, spec = _mode_case("k12_b2", 6, n=24)
    opts = _opts(spec)
    tensors, weights, g = _mode_args(x)
    rounding, clamp = PM.mode_tie_pairs(*tensors, weights, *g, opts, factor=20.0)
    ties = (rounding | clamp).numpy()
    live = x["pv"]
    assert ties.any() and (live & ~ties).any()
    x_masked = dict(x, pv=live & ~ties)
    tensors_m, _, _ = _mode_args(x_masked)
    b, n, k = x["idx"].shape
    m_i, cd = PM.fused_pair_messages_plain(*tensors_m, weights, opts)
    grads = PM.fused_pair_messages_backward_plain(*tensors_m, weights, *g, opts)
    coors, cj, fj, proj_i, _ = tensors
    d_cj = torch.zeros_like(cj)
    d_fj = torch.zeros_like(fj)
    d_w = [torch.zeros_like(w) for w in weights]
    for bi in range(b):
        for i in range(n):
            keep = np.flatnonzero(x_masked["pv"][bi, i])
            if keep.size == 0:
                assert torch.equal(m_i[bi, i], torch.zeros_like(m_i[bi, i]))
                continue
            rows = torch.from_numpy(i * k + keep)
            one = (coors[bi:bi + 1, i:i + 1], cj[bi:bi + 1, rows], fj[bi:bi + 1, rows],
                   proj_i[bi:bi + 1, i:i + 1], torch.ones(1, keep.size, 1, **F64))
            gi = (g[0][bi:bi + 1, i:i + 1], g[1][bi:bi + 1, i:i + 1])
            om, oc = PM.fused_pair_messages_plain(*one, weights, opts)
            torch.testing.assert_close(m_i[bi, i], om[0, 0], rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(cd[bi, i], oc[0, 0], rtol=1e-12, atol=1e-12)
            gc, gcj, gfj, gpi, gw = PM.fused_pair_messages_backward_plain(*one, weights, *gi, opts)
            torch.testing.assert_close(grads[0][bi, i], gc[0, 0], rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(grads[3][bi, i], gpi[0, 0], rtol=1e-12, atol=1e-12)
            d_cj[bi, rows], d_fj[bi, rows] = gcj[0], gfj[0]
            d_w = [a + c for a, c in zip(d_w, gw)]
    torch.testing.assert_close(grads[1], d_cj, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(grads[2], d_fj, rtol=1e-12, atol=1e-12)
    for got, want in zip(grads[4], d_w):
        torch.testing.assert_close(got, want.reshape(got.shape), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", ["fourier_norm_clamp", "k12_b2", "m4_soft_fourier"])
def test_tie_masked_plain_version_in_the_mode_matches_the_pallas_kernel(case):
    """The port's plain version in the mode on a case whose tie pairs are
    masked (pv = 0; a wide reach, so that some are) still agrees with the
    Pallas kernel's mode in interpret mode, forward at FWD_TOL and every
    gradient at GRAD_TOL of its largest value."""
    x, spec = _mode_case(case, 7, n=64)
    tensors, weights, g = _mode_args(x)
    rounding, clamp = PM.mode_tie_pairs(*tensors, weights, *g, _opts(spec), factor=20.0)
    ties = (rounding | clamp).numpy()
    assert ties.any()
    x = dict(x, pv=x["pv"] & ~ties)
    for name, got, want in zip(("m_i", "coors_delta"), _port(x, spec, True), _jax(x, spec, True)):
        assert _rel(got, want) <= FWD_TOL, name
    names = ("coors", "cj", "fj", "proj_i") + WEIGHT_NAMES
    for name, got, want in zip(names, _port(x, spec, True, grads=True),
                               _jax(x, spec, True, grads=True)):
        want = want.reshape(got.shape)
        if np.abs(want).max():
            assert _rel(got, want) <= GRAD_TOL, name
        else:
            assert not np.abs(got).max(), name
