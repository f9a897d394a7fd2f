"""Dropout in training mode in the port, on the CPU: the rate and the
inverted scaling at every site of the materialised layer, the streamed block
and the sparse layer (``tests/test_dropout_stats.py``'s statistics); eval
mode equal to dropout 0; the fused flags giving way; masks fixed by the
caller's generator, also through the streamed path's recompute, whose
gradients equal the materialised path's under the same masks; a sharded
call's mask, its part of the whole draw (the graph axis and tensor
parallelism hold the layers in ``test_torch_graph_axis.py`` and
``test_torch_tp.py``); and the train step, which applies no dropout,
against the JAX step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import egnn_tpu
from egnn_tpu import training as jtrain
from egnn_tpu_torch import EGNN, EGNNNetwork, EGNNSparse
from egnn_tpu_torch import training as ttrain
from egnn_tpu_torch.models import egnn as egnn_mod
from egnn_tpu_torch.models import egnn_sparse as sparse_mod
from egnn_tpu_torch.ops import core
from egnn_tpu_torch.ops import pairwise_stream as tps
from egnn_tpu_torch.ops.cuda import pair_messages as PM
from egnn_tpu_torch.ops.graph import knn_graph
from egnn_tpu_torch.utils.port_weights import load_flax_params

F64 = dict(device="cpu", dtype=torch.float64)
RATE = 0.5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _dense_inputs(seed, b=1, n=16, d=8, with_mask=False):
    g = _gen(seed)
    feats = torch.randn(b, n, d, generator=g, dtype=torch.float64)
    coors = torch.randn(b, n, 3, generator=g, dtype=torch.float64)
    mask = torch.rand(b, n, generator=g) > 0.2 if with_mask else None
    return feats, coors, mask


def _molecules(seed, d=8, graphs=4, atoms=10, k=4):
    g = _gen(seed)
    n = graphs * atoms
    coors = 1.5 * torch.randn(n, 3, generator=g, dtype=torch.float64)
    es = knn_graph(coors, k, graph_size=atoms)
    x = torch.cat([coors, torch.randn(n, d, generator=g, dtype=torch.float64)], dim=-1)
    return x, es.edge_index, es.mask


@pytest.fixture
def record(monkeypatch):
    """Every dropout call of the port's layers and streamed block, as
    (input, output)."""
    calls = []

    def recording(x, rate, generator, _real=core.dropout):
        out = _real(x, rate, generator)
        calls.append((x.detach(), out.detach()))
        return out

    for mod in (egnn_mod, sparse_mod, tps):
        monkeypatch.setattr(mod, "dropout", recording)
    return calls


def _layer(path, rate=RATE, **kw):
    """A float64 layer of the given path: ``materialised`` (all pairs),
    ``streamed`` (all pairs in chunks of 8), ``knn`` (kNN 6) or ``sparse``."""
    if path == "sparse":
        return EGNNSparse(feats_dim=8, dropout=rate, norm_coors=True, **kw, **F64)
    opts = dict(materialised=dict(stream_pairwise=False),
                streamed=dict(stream_pairwise=True, pairwise_chunk=8),
                knn=dict(num_nearest_neighbors=6))[path]
    return EGNN(dim=8, dropout=rate, init_eps=0.1, norm_coors=True, **opts, **kw, **F64)


def _run(layer, path, generator=None, seed=0, grads=False):
    """Outputs (and with ``grads`` the gradients of every input and weight)."""
    if path == "sparse":
        x, ei, em = _molecules(seed)
        inputs = [x.requires_grad_(grads)]
        out = (layer(inputs[0], ei, edge_mask=em, generator=generator),)
    else:
        feats, coors, mask = _dense_inputs(seed, n=20, with_mask=True)
        inputs = [feats.requires_grad_(grads), coors.requires_grad_(grads)]
        out = layer(*inputs, mask=mask, generator=generator)
    if not grads:
        return list(out)
    loss = sum((o ** 2).mean() for o in out)
    return list(out) + list(torch.autograd.grad(loss, inputs + list(layer.parameters()),
                                                allow_unused=True))


# (path, the shapes of its dropout sites in the order drawn)
SITES = {
    # edge MLP h1 (b, n, n, hidden = 2 (2 * 8 + 1)), coordinate MLP (b, n, n, 4m),
    # node MLP (b, n, 2d)
    "materialised": [(1, 20, 20, 34), (1, 20, 20, 64), (1, 20, 16)],
    # two draws a j-chunk (n = 20 in three chunks of 8), then the node MLP
    "streamed": [(1, 20, 8, 34), (1, 20, 8, 64)] * 3 + [(1, 20, 16)],
    # per edge (4 graphs of 10 atoms, k = 4), then per node
    "sparse": [(160, 34), (160, 64), (40, 16)],
}


@pytest.mark.parametrize("path", sorted(SITES))
def test_dropout_rate_and_scaling(path, record):
    """The zero share over all sites within 5 sigma of the rate; every
    surviving entry is its input times 1/keep, bitwise."""
    _run(_layer(path).train(), path, _gen(3))
    assert [tuple(x.shape) for x, _ in record] == SITES[path]
    total = sum(x.numel() for x, _ in record)
    zeroed = sum(int((out == 0).sum()) for _, out in record)
    sigma = (RATE * (1 - RATE) / total) ** 0.5
    assert abs(zeroed / total - RATE) < 5 * sigma, (zeroed / total, total)
    for x, out in record:
        assert bool((x != 0).all())
        kept = out != 0
        assert torch.equal(out[kept], x[kept] / (1.0 - RATE))


def _block_setup(seed, n=12, hidden=16, m_dim=16):
    g = _gen(seed)

    def rnd(*s, scale=1.0):
        return scale * torch.randn(*s, generator=g, dtype=torch.float64)

    params = tps.PairwiseParams(
        w_d=rnd(1, hidden, scale=0.3), edge_w2=torch.eye(hidden, m_dim, dtype=torch.float64),
        edge_b2=torch.zeros(m_dim, dtype=torch.float64), gate_w=None, gate_b=None,
        coors_w1=rnd(m_dim, 4 * m_dim, scale=0.3), coors_b1=rnd(4 * m_dim, scale=0.1),
        coors_w2=rnd(4 * m_dim, 1, scale=0.3), coors_b2=torch.zeros(1, dtype=torch.float64),
        cn_scale=None)
    return rnd(1, n, 3), rnd(1, n, hidden, scale=0.5), params


@pytest.mark.parametrize("site", ["edge_mlp", "coors_mlp"])
def test_streamed_block_dropout_expectation(site):
    """The mean of the block's sums over 400 draws against the closed form
    E[f(drop(h))] = keep f(h / keep) (f(0) = 0), which pins rate and scaling
    (tests/test_dropout_stats.py:126-199). ``coors_mlp``: proj = 0 and
    w_d = 0 make the messages constant, so that only the coordinate MLP's
    mask is random."""
    keep = 1.0 - {"edge_mlp": 0.5, "coors_mlp": 0.3}[site]
    coors, proj, params = _block_setup(1)
    rel = coors[:, :, None, :] - coors[:, None, :, :]
    if site == "edge_mlp":
        h1 = proj[:, :, None, :] + proj[:, None, :, :] + (rel ** 2).sum(-1)[..., None] @ params.w_d
        expect = (keep * F.silu(F.silu(h1 / keep))).sum(dim=-2)
        pick, opts = 0, dict(update_coors=False)
    else:
        proj = torch.zeros_like(proj)
        params = params._replace(w_d=torch.zeros_like(params.w_d),
                                 edge_b2=0.7 * torch.randn(16, generator=_gen(8),
                                                           dtype=torch.float64))
        z = F.silu(params.edge_b2) @ params.coors_w1 + params.coors_b1
        w = (keep * F.silu(z / keep)) @ params.coors_w2 + params.coors_b2
        expect = w[0] * rel.sum(dim=-2)
        pick, opts = 1, dict(update_feats=False)
    draws = 400
    g = _gen(6)
    mean = sum(tps.pairwise_block(coors, proj, coors, proj, None, params, dropout_rate=1 - keep,
                                  generator=g, **opts)[pick] for _ in range(draws)) / draws
    scale = expect.abs().mean().item() + 1e-3
    assert (mean - expect).abs().mean().item() < 8 * scale / draws ** 0.5


@pytest.mark.parametrize("path", ["materialised", "streamed", "knn", "sparse"])
def test_eval_mode_equals_dropout_zero(path):
    dropping = _layer(path, rate=0.3, generator=_gen(1)).eval()
    plain = _layer(path, rate=0.0, generator=_gen(1))
    for a, b_ in zip(_run(dropping, path), _run(plain, path)):
        assert torch.equal(a, b_)


@pytest.fixture
def fused_calls(monkeypatch):
    calls = []
    for name in ("fused_pair_messages", "fused_knn_messages"):
        def counted(*a, _real=getattr(PM, name), _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(PM, name, counted)
    return calls


@pytest.mark.parametrize("flag", ["fused_pairs", "fused_knn", "fused_uniform"])
def test_fused_flags_give_way_in_training_mode(flag, fused_calls):
    """In training mode the flag takes the unfused path, with the unfused
    module's masks and outputs bitwise; in eval mode the kernel runs."""
    path = "sparse" if flag == "fused_uniform" else "knn"
    extra = dict(uniform_degree=4) if path == "sparse" else {}
    fused = _layer(path, rate=0.2, generator=_gen(1), **{flag: True}, **extra).train()
    plain = _layer(path, rate=0.2, generator=_gen(1), **extra).train()
    for a, b_ in zip(_run(fused, path, _gen(4)), _run(plain, path, _gen(4))):
        assert torch.equal(a, b_)
    assert fused_calls == []
    _run(fused.eval(), path)
    assert len(fused_calls) == 1


@pytest.mark.parametrize("path", ["materialised", "streamed", "sparse"])
def test_generator_fixes_the_masks(path):
    """A fixed generator state gives bit-identical outputs and gradients
    (the streamed path's through its recompute); another state other
    outputs; training mode without a generator is refused."""
    layer = _layer(path, rate=0.3).train()
    first = _run(layer, path, _gen(10), grads=True)
    again = _run(layer, path, _gen(10), grads=True)
    other = _run(layer, path, _gen(11), grads=True)
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)
    assert not torch.allclose(first[0], other[0])
    with pytest.raises(ValueError, match="generator"):
        _run(layer, path)


def test_streamed_gradients_equal_the_materialised_path_under_the_same_masks(
        record, monkeypatch):
    """The masks the streamed path drew (chunk by chunk, then the node MLP)
    replayed on the materialised path: outputs and every gradient agree up
    to the order of the sums. A recompute that drew other masks than the
    forward would not."""
    streamed = _layer("streamed", rate=0.3, generator=_gen(2)).train()
    out_s = _run(streamed, "streamed", _gen(5), grads=True)
    forward_calls = len(SITES["streamed"])
    # the forward's draws, then each chunk's recompute in the backward: the
    # same inputs and the same masks
    assert len(record) == 2 * forward_calls - 1
    for x, out in record[forward_calls:]:
        assert any(torch.equal(x, xf) and torch.equal(out, of)
                   for xf, of in record[:forward_calls - 1])
    keeps = [out != 0 for _, out in record[:forward_calls]]
    n = 20
    masks = [torch.cat(keeps[0:-1:2], dim=2)[:, :, :n], torch.cat(keeps[1:-1:2], dim=2)[:, :, :n],
             keeps[-1]]

    def replay(x, rate, generator):
        keep = masks.pop(0)
        assert keep.shape == x.shape
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(egnn_mod, "dropout", replay)
    materialised = _layer("materialised", rate=0.3, generator=_gen(2)).train()
    out_m = _run(materialised, "materialised", _gen(5), grads=True)
    assert masks == []
    for a, b_ in zip(out_s, out_m):
        torch.testing.assert_close(a, b_, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("rows,cols", [((4, 12), None), (None, (8, 24)), ((8, 12), (16, 24))],
                         ids=["rows", "cols", "both"])
def test_sharded_dropout_is_its_part_of_the_whole_draw(rows, cols):
    """A sharded call (``whole`` and ``slices`` from ``sharded_part``: rows
    on dim 1, columns on the last dim) keeps bitwise its part of the mask
    that the unsharded call draws from the same generator state, and leaves
    the generator where that call leaves it."""
    x = torch.randn(2, 12, 5, 24, generator=_gen(3), dtype=torch.float64)
    part = x[:, rows[0]:rows[0] + 4] if rows else x
    part = part[..., cols[0]:cols[0] + 8] if cols else part
    g_whole, g_part = _gen(9), _gen(9)
    want = core.dropout(x, RATE, g_whole)
    got = core.dropout(part, RATE, g_part, *core.sharded_part(part.shape, rows, cols))
    if rows:
        want = want[:, rows[0]:rows[0] + 4]
    if cols:
        want = want[..., cols[0]:cols[0] + 8]
    assert torch.equal(got, want)
    assert torch.equal(g_whole.get_state(), g_part.get_state())
    with pytest.raises(ValueError, match="not x's"):
        core.dropout(part, RATE, g_part, (2, 12, 5, 24), ((1, 0, 3),))


def test_train_step_applies_no_dropout_as_the_jax_step():
    """The JAX step calls the network without ``deterministic=False``: at
    dropout 0.1 two steps of the port's step (the module in training mode)
    equal two of the JAX step, and the module's mode is kept."""
    n = 32
    layer = dict(num_nearest_neighbors=8, norm_coors=True, coor_weights_clamp_value=2.0,
                 init_eps=0.1, dropout=0.1)
    net_kw = dict(depth=2, dim=16, num_tokens=21, num_positions=n, layer_kwargs=layer)
    rng = np.random.RandomState(21)
    tokens = rng.randint(0, 21, size=(2, n))
    clean = np.cumsum(rng.randn(2, n, 3), axis=1)
    noised = clean + rng.randn(2, n, 3)
    mask = np.arange(n)[None, :] < rng.randint(n // 2, n + 1, size=(2, 1))
    adj = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) == 1
    jnet = egnn_tpu.EGNNNetwork(**net_kw)
    jargs = tuple(jnp.asarray(a) for a in (tokens, noised, clean, adj, mask))
    params = jnet.init(jax.random.PRNGKey(0), jargs[0], jargs[1], adj_mat=jargs[3],
                       mask=jargs[4])["params"]
    jstate = jtrain.TrainState.create(params, jtrain.make_fused_adam(1e-3))
    jstep = jtrain.make_denoise_train_step(jnet, donate=False)
    tnet = EGNNNetwork(**net_kw, **F64)
    load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, params))
    assert tnet.training
    tstep = ttrain.make_denoise_train_step(tnet, ttrain.make_fused_adam(tnet.parameters(), 1e-3))
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in (tokens, noised, clean, adj, mask))
    for _ in range(2):
        jstate, jloss = jstep(jstate, *jargs)
        np.testing.assert_allclose(tstep(*targs).numpy(), np.asarray(jloss), rtol=0, atol=1e-9)
    assert tnet.training
    jflat = {}
    for key, value in jstate.params.items():
        if hasattr(value, "items"):
            jflat.update({f"{key}.{name}": np.asarray(v) for name, v in value.items()})
        else:
            jflat[key] = np.asarray(value)
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[name], rtol=0, atol=1e-9,
                                   err_msg=name)
