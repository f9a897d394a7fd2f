"""The port's pipeline parallelism (``egnn_tpu_torch/parallel/pipeline.py``)
against ``egnn_tpu``'s on the CPU, stages as processes under gloo
(``test_torch_parallel.run_ranks``), the JAX side on a ``pipe`` mesh of the
same stage count over the first 2 or 4 of conftest's 8 virtual devices:
the cases of ``tests/test_pipeline.py`` at S = 2 and 4.

Held here: ``make_pipelined_apply``'s outputs with and without a mask; the
stage gradients and the input gradients through it; the stage blocks'
shapes; the streaming loss (``make_pipelined_loss``) with and without a
mask, its stage and input gradients; both against JAX and against the
sequential stack in one process; the JAX stacked tree carried by
``load_stacked_flax_params``; each stage ran its layers M times a forward
(bubble ticks compute nothing); at S = 1 the pipeline equals the
sequential stack bitwise.

Float64 throughout, at 1e-9 times the tensor's largest magnitude where that
exceeds 1. One spawn of 4 ranks runs every case: S = 2 on the groups
{0, 1} and {2, 3} at once, then S = 4. No JAX at this file's top: a spawned
rank imports it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_parallel import _np, run_ranks

F64 = dict(device="cpu", dtype=torch.float64)
ATOL = 1e-9
DEPTH, B, M, N, DIM = 8, 8, 4, 24, 8
LAYER_KW = dict(dim=DIM, num_nearest_neighbors=4, norm_coors=True, coor_weights_clamp_value=2.0)


def _close(actual, desired, atol=ATOL, name=""):
    desired = np.asarray(desired)
    scale = max(1.0, float(np.abs(desired).max())) if desired.size else 1.0
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0, atol=atol * scale,
                               err_msg=name)


def _inputs():
    rng = np.random.RandomState(0)
    feats, coors = rng.randn(B, N, DIM), rng.randn(B, N, 3)
    return feats, coors, rng.rand(B, N) > 0.2, coors + 0.1


def mb_loss(fo, co, tgt, m):
    """``tests/test_pipeline.py``'s microbatch loss (numpy-free: it runs in
    both packages)."""
    err = (co - tgt) ** 2
    if m is not None:
        err = err * m[..., None]
    return err.mean() + (fo ** 2).mean()


# ---------------------------------------------------------------------------
# rank-side cases (no JAX here)
# ---------------------------------------------------------------------------

def _stage_rows(stacked, rank, S):
    L = DEPTH // S
    return {k: _np(v.grad[rank * L:(rank + 1) * L]) for k, v in stacked.items()}


def pipeline_cases(group, p):
    """Every case on one group of S stages: outputs and gradients through
    ``make_pipelined_apply`` and ``make_pipelined_loss``, each stage's
    gradients of its own layers' rows, stage 0's input gradients, and the
    layer calls a forward made on this stage."""
    from egnn_tpu_torch import EGNN, parallel
    from egnn_tpu_torch.utils.port_weights import load_stacked_flax_params

    S, rank = dist.get_world_size(group), dist.get_rank(group)
    layer = EGNN(**LAYER_KW, **F64)
    calls = [0]
    layer.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
    feats, coors, mask, target = (torch.from_numpy(a) for a in p["inputs"])
    out = dict(calls={})

    def fresh():
        stacked = load_stacked_flax_params(layer, p["stacked"])
        block = parallel.stage_block(parallel.to_stages(stacked, S), group)
        return stacked, block

    apply = parallel.make_pipelined_apply(layer, group, M)
    for with_mask in (False, True):
        stacked, block = fresh()
        calls[0] = 0
        with torch.no_grad():
            fo, co = apply(block, feats, coors, mask=mask if with_mask else None)
        out[f"apply_{with_mask}"] = dict(f=_np(fo), c=_np(co))
        out["calls"][f"apply_{with_mask}"] = calls[0]
    out["stage_shape"] = {k: tuple(v.shape) for k, v in block.items()}

    stacked, block = fresh()
    f, c = feats.clone().requires_grad_(), coors.clone().requires_grad_()
    fo, co = apply(block, f, c)
    loss = (fo ** 2).mean() + (co ** 2).mean()
    loss.backward()
    out["apply_grad"] = dict(loss=loss.item(), stage=_stage_rows(stacked, rank, S),
                             f_grad=_np(f.grad) if f.grad is not None else None,
                             c_grad=_np(c.grad) if c.grad is not None else None)

    pl_loss = parallel.make_pipelined_loss(layer, group, M, mb_loss)
    for with_mask in (False, True):
        stacked, block = fresh()
        f, c = feats.clone().requires_grad_(), coors.clone().requires_grad_()
        calls[0] = 0
        loss = pl_loss(block, f, c, target, mask=mask if with_mask else None)
        out["calls"][f"loss_{with_mask}"] = calls[0]
        loss.backward()
        out[f"loss_{with_mask}"] = dict(loss=loss.item(), stage=_stage_rows(stacked, rank, S),
                                        f_grad=None if f.grad is None else _np(f.grad),
                                        c_grad=None if c.grad is None else _np(c.grad))
    return out


def sequential_case(p, S):
    """The sequential stack in this process over the same microbatches: the
    microbatch-mean loss with and without the mask and its gradients, and
    the applied outputs."""
    from egnn_tpu_torch import EGNN
    from egnn_tpu_torch.utils.port_weights import load_stacked_flax_params

    layer = EGNN(**LAYER_KW, **F64)
    feats, coors, mask, target = (torch.from_numpy(a) for a in p["inputs"])
    mb = B // M
    out = {}
    for with_mask in (False, True):
        stacked = load_stacked_flax_params(layer, p["stacked"])
        f, c = feats.clone().requires_grad_(), coors.clone().requires_grad_()
        losses, outs = [], []
        for i in range(M):
            sl = slice(i * mb, (i + 1) * mb)
            m = mask[sl] if with_mask else None
            fo, co = f[sl], c[sl]
            for li in range(DEPTH):
                fo, co = torch.func.functional_call(
                    layer, {k: v[li] for k, v in stacked.items()}, (fo, co), dict(mask=m))
            outs.append((fo, co))
            losses.append(mb_loss(fo, co, target[sl], m))
        loss = torch.stack(losses).sum() / M
        loss.backward()
        out[f"loss_{with_mask}"] = dict(loss=loss.item(),
                                        grads={k: _np(v.grad) for k, v in stacked.items()},
                                        f_grad=_np(f.grad), c_grad=_np(c.grad))
        out[f"apply_{with_mask}"] = dict(f=_np(torch.cat([o[0] for o in outs]).detach()),
                                         c=_np(torch.cat([o[1] for o in outs]).detach()))
    return out


def one_stage_case(group, p):
    """S = 1 (a group of one rank): the pipeline's outputs, loss and
    gradients against the sequential stack, bitwise."""
    from egnn_tpu_torch import EGNN, parallel
    from egnn_tpu_torch.utils.port_weights import load_stacked_flax_params

    layer = EGNN(**LAYER_KW, **F64)
    feats, coors, mask, target = (torch.from_numpy(a) for a in p["inputs"])
    stacked = load_stacked_flax_params(layer, p["stacked"])
    block = parallel.stage_block(parallel.to_stages(stacked, 1), group)
    loss = parallel.make_pipelined_loss(layer, group, M, mb_loss)(block, feats, coors, target,
                                                                  mask=mask)
    loss.backward()
    with torch.no_grad():
        fo, co = parallel.make_pipelined_apply(layer, group, M)(block, feats, coors, mask=mask)
    return dict(loss=loss.item(), grads={k: _np(v.grad) for k, v in stacked.items()},
                f=_np(fo), c=_np(co))


def pipe_cases(rank, world, p):
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    solo = dist.new_group([0])      # every rank takes part in making a group
    one = one_stage_case(solo, p) if rank == 0 else None
    out = {2: pipeline_cases(pairs[rank // 2], p), 4: pipeline_cases(dist.group.WORLD, p),
           "one": one}
    if rank == 0:
        out["seq"] = sequential_case(p, 1)
    return out


# ---------------------------------------------------------------------------
# the JAX side and the spawn
# ---------------------------------------------------------------------------

def _jax_refs(S, inputs):
    import jax
    from jax.sharding import Mesh

    from egnn_tpu import EGNN as JEGNN
    from egnn_tpu.parallel.pipeline import (make_pipelined_apply, make_pipelined_loss,
                                            stack_layer_params, to_stages)

    feats, coors, mask, target = inputs
    layer = JEGNN(**LAYER_KW)
    stacked = stack_layer_params(layer, jax.random.PRNGKey(3), feats[:1], coors[:1], DEPTH)
    mesh = Mesh(np.array(jax.devices()[:S]), ("pipe",))
    pp = make_pipelined_apply(layer, mesh, M)
    refs = {}
    for with_mask in (False, True):
        fo, co = pp(to_stages(stacked, S), feats, coors, mask=mask if with_mask else None)
        refs[f"apply_{with_mask}"] = dict(f=np.asarray(fo), c=np.asarray(co))

    def loss_apply(p, f, c):
        fo, co = pp(to_stages(p, S), f, c)
        return (fo ** 2).mean() + (co ** 2).mean()

    value, grads = jax.value_and_grad(loss_apply, argnums=(0, 1, 2))(stacked, feats, coors)
    refs["apply_grad"] = dict(loss=float(value), grads=grads[0], f_grad=grads[1],
                              c_grad=grads[2])
    for with_mask in (False, True):
        pl = make_pipelined_loss(layer, mesh, M, mb_loss)
        m = mask if with_mask else None
        value, grads = jax.value_and_grad(
            lambda p, f, c: pl(to_stages(p, S), f, c, target, mask=m), argnums=(0, 1, 2))(
            stacked, feats, coors)
        refs[f"loss_{with_mask}"] = dict(loss=float(value), grads=grads[0], f_grad=grads[1],
                                         c_grad=grads[2])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(stacked), to_np(refs)


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    inputs = _inputs()
    stacked, refs = {}, {}
    for S in (2, 4):
        stacked[S], refs[S] = _jax_refs(S, inputs)
    # the stacked initialisation depends on the key alone, not on S
    for k in stacked[2]:
        np.testing.assert_array_equal(stacked[2][k], stacked[4][k])
    ranks = run_ranks(pipe_cases, 4, tmp_path_factory.mktemp("pipe"),
                      dict(inputs=inputs, stacked=stacked[2]))
    return dict(ranks=ranks, refs=refs, seq=ranks[0]["seq"], one=ranks[0]["one"])


def _stages(runs, S):
    return [r[S] for r in runs["ranks"][:S]]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("with_mask", [False, True])
def test_pipeline_output_parity(pipe_runs, S, with_mask):
    ref, seq = pipe_runs["refs"][S][f"apply_{with_mask}"], pipe_runs["seq"][f"apply_{with_mask}"]
    for st in _stages(pipe_runs, S):
        for field in ("f", "c"):
            _close(st[f"apply_{with_mask}"][field], ref[field], name=field)
            _close(st[f"apply_{with_mask}"][field], seq[field], name=f"sequential {field}")


def _check_grads(stages, ref, S):
    L = DEPTH // S
    for r, st in enumerate(stages):
        np.testing.assert_allclose(st["loss"], ref["loss"], rtol=1e-12)
        for k, g in st["stage"].items():
            _close(g, np.asarray(ref["grads"][k])[r * L:(r + 1) * L], name=f"stage {r} {k}")
    # the inputs' gradients come back to stage 0 alone
    _close(stages[0]["f_grad"], ref["f_grad"], name="feats gradient")
    _close(stages[0]["c_grad"], ref["c_grad"], name="coors gradient")
    assert all(st["f_grad"] is None for st in stages[1:])


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_gradient_parity(pipe_runs, S):
    _check_grads([st["apply_grad"] for st in _stages(pipe_runs, S)],
                 pipe_runs["refs"][S]["apply_grad"], S)


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_stage_param_shapes(pipe_runs, S):
    shapes = _stages(pipe_runs, S)[0]["stage_shape"]
    assert {v[:2] for v in shapes.values()} == {(1, DEPTH // S)}


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("with_mask", [False, True])
def test_pipeline_streaming_loss_parity(pipe_runs, S, with_mask):
    key = f"loss_{with_mask}"
    stages = [st[key] for st in _stages(pipe_runs, S)]
    _check_grads(stages, pipe_runs["refs"][S][key], S)
    seq = pipe_runs["seq"][key]
    np.testing.assert_allclose(stages[0]["loss"], seq["loss"], rtol=1e-12)
    L = DEPTH // S
    for r, st in enumerate(stages):
        for k, g in st["stage"].items():
            _close(g, seq["grads"][k][r * L:(r + 1) * L], name=f"sequential stage {r} {k}")


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_skips_bubble_ticks(pipe_runs, S):
    """Each stage runs its DEPTH / S layers on the M microbatches alone: M *
    DEPTH / S layer calls a forward, DEPTH * M over the stages, the
    sequential stack's count."""
    for st in _stages(pipe_runs, S):
        assert set(st["calls"].values()) == {M * DEPTH // S}


def test_pipeline_one_stage_bitwise_sequential(pipe_runs):
    one, seq = pipe_runs["one"], pipe_runs["seq"]
    np.testing.assert_array_equal(one["f"], seq["apply_True"]["f"])
    np.testing.assert_array_equal(one["c"], seq["apply_True"]["c"])
    assert one["loss"] == seq["loss_True"]["loss"]
    for k, g in seq["loss_True"]["grads"].items():
        np.testing.assert_array_equal(one["grads"][k], g, err_msg=k)
