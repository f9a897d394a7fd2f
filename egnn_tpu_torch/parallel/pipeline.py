"""GPipe-style pipeline parallelism for homogeneous EGNN depth stacks, the
counterpart of ``egnn_tpu/parallel/pipeline.py``.

The right axis for a deep model with small layers: each of S stages (the
ranks of a process group) holds only depth/S layers' parameters, and M
microbatches stream through the stages.

- ``stack_layer_params``: ``torch.func.stack_module_state`` over ``depth``
  initialised layers, each parameter a (depth, ...) tensor;
  ``to_stages`` cuts it into (S, depth/S, ...) blocks and ``stage_block``
  keeps this rank's (1, depth/S, ...) block. A stacked tree of the JAX
  package converts with ``utils/port_weights.py:load_stacked_flax_params``.
- The schedule runs T = M + S - 1 ticks. At tick t stage d computes
  microbatch m = t - d through its layers (``torch.func.functional_call``
  on a template layer): stage 0 pulls microbatch t, every other stage takes
  what ``collectives.ring_permute(..., wrap=False)`` brought from d - 1 at
  the tick before. The last stage writes drained microbatch t - (S - 1)
  into its (M, ...) result (``pipeline_apply``) or adds its loss to a
  scalar (``pipeline_loss``); one sum over the group replicates the result
  (``reduce_from_group``: every rank backpropagates its own share, so the
  gradients are not scaled by S).
- Bubble ticks (m < 0 or m >= M) compute nothing; their tick still joins
  the permute, whose message then carries what arrived (the JAX schedule
  computes a clamped microbatch there and masks it, as SPMD requires; here
  each rank runs its own program). So each rank runs its layers on M
  microbatches, not T: a kNN layer launches K1 M times a forward on every
  stage (M * depth/S launches a rank, M * depth over the group, the
  sequential stack's count), and K2 as often in the backward (stage 0's
  first layer M times fewer where the inputs need no gradient, as the
  sequential stack's first layer).
- Autograd: the permute's backward is the reverse permute. What every tick
  sends depends on what the tick before received (on stage 0, which
  computes on a fresh microbatch, through a join that passes no gradient
  back to what arrived), and every rank's result on its last tick's
  tensors, so every rank runs the T - 1 reverse permutes, in the reverse
  order of the ticks. Each stage's parameter gradients stay on its
  rank; the inputs' gradients come back to stage 0 (rank 0 of the group)
  through the reverse permutes. The loss is the mean over the microbatches,
  as the sequential stack's batch mean is when the batch splits evenly.

Where the JAX package takes a mesh axis name (``axis_name="pipe"``), the
port takes that axis's process group.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call, stack_module_state

from .collectives import check_group, reduce_from_group, ring_permute


def stack_layer_params(layers: Sequence[nn.Module]) -> dict[str, torch.Tensor]:
    """The parameters of ``depth`` initialised layers of one configuration
    (e.g. ``[EGNN(..., generator=g) for _ in range(depth)]``), stacked on a
    leading axis: the tree every pipeline entry point consumes, with
    ``layers[0]`` (or any layer of the configuration) as its template. The
    stacked tensors are new leaves that require gradients."""
    params, buffers = stack_module_state(list(layers))
    if buffers:
        raise ValueError(f"the layers hold buffers {sorted(buffers)}, which the pipeline "
                         "does not carry")
    return params


def to_stages(stacked: Mapping[str, torch.Tensor], n_stages: int) -> dict[str, torch.Tensor]:
    """(depth, ...) stacked parameters -> (S, depth/S, ...) stage blocks."""
    out = {}
    for name, x in stacked.items():
        depth = x.shape[0]
        if depth % n_stages:
            raise ValueError(f"depth {depth} does not split into {n_stages} stages")
        out[name] = x.reshape(n_stages, depth // n_stages, *x.shape[1:])
    return out


def stage_block(stages: Mapping[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """This rank's (1, depth/S, ...) block of ``to_stages``' output."""
    r = dist.get_rank(group)
    return {name: x[r:r + 1] for name, x in stages.items()}


class _Join(torch.autograd.Function):
    """``a``, with ``b`` made a dependency that receives a zero gradient:
    it keeps a received tensor that a stage does not use in the graph, so
    that its permute's backward runs on every rank."""

    @staticmethod
    def forward(ctx, a, *b):
        ctx.b = [(x.shape, x.dtype, x.device) for x in b]
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.b])


def _schedule(layer, stage_params, feats_mb, coors_mb, mask_mb, adj_mat, group, drain):
    """Run the ticks; ``drain(m, feats, coors)`` takes each microbatch the
    last stage finishes. Returns the tensors of the last tick (the end of
    this rank's chain of permutes)."""
    check_group(group, "group")
    S, d = dist.get_world_size(group), dist.get_rank(group)
    M = feats_mb.shape[0]
    T = M + S - 1
    names = list(stage_params)
    if any(stage_params[k].shape[0] != 1 for k in names):
        raise ValueError("stage_params is this rank's (1, L_local, ...) block (stage_block)")
    n_layers = stage_params[names[0]].shape[1]
    grad = torch.is_grad_enabled() and (
        feats_mb.requires_grad or coors_mb.requires_grad
        or any(p.requires_grad for p in stage_params.values()))
    # what arrives before the first tick: zeros, leaves that require a
    # gradient where the schedule does, so that every rank's first permute
    # is part of its graph
    f_in = torch.zeros_like(feats_mb[0]).requires_grad_(grad)
    c_in = torch.zeros_like(coors_mb[0]).requires_grad_(grad)
    for t in range(T):
        m = t - d
        fresh = d == 0 and t < M
        f, c = (feats_mb[t], coors_mb[t]) if fresh else (f_in, c_in)
        if 0 <= m < M:
            mask = mask_mb[m] if mask_mb is not None else None
            for i in range(n_layers):
                f, c = functional_call(layer, {k: stage_params[k][0, i] for k in names}, (f, c),
                                       dict(mask=mask, adj_mat=adj_mat))
        if fresh:   # what arrived is not this tick's input: keep it in the chain
            f, c = _Join.apply(f, f_in, c_in), _Join.apply(c, f_in, c_in)
        if 0 <= m < M and d == S - 1:
            drain(m, f, c)
        if t < T - 1:
            f_in, c_in = ring_permute((f, c), group, wrap=False)
    return f, c


def pipeline_apply(
    layer: nn.Module,
    stage_params: Mapping[str, torch.Tensor],   # (1, L_local, ...): this rank's block
    feats_mb: torch.Tensor,                     # (M, mb, n, d) microbatches, on every rank
    coors_mb: torch.Tensor,                     # (M, mb, n, c)
    mask_mb: Optional[torch.Tensor] = None,     # (M, mb, n) bool
    adj_mat: Optional[torch.Tensor] = None,     # (n, n) bool
    *,
    group,
):
    """The pipelined stack over ``group``'s ranks, each calling it with its
    stage's block and the same microbatches. Returns (feats (M, mb, n, d),
    coors (M, mb, n, c)), the whole result on every rank (the last stage's,
    summed over the group; the backward of that sum is the identity).
    T - 1 permutes and one sum a call."""
    f_out = [None] * feats_mb.shape[0]
    c_out = [None] * feats_mb.shape[0]

    def drain(m, f, c):
        f_out[m], c_out[m] = f, c

    f, c = _schedule(layer, stage_params, feats_mb, coors_mb, mask_mb, adj_mat, group, drain)
    if f_out[0] is not None:     # the last stage
        f_acc, c_acc = torch.stack(f_out), torch.stack(c_out)
    else:
        f_acc, c_acc = torch.zeros_like(feats_mb), torch.zeros_like(coors_mb)
    f_acc, c_acc = _Join.apply(f_acc, f, c), _Join.apply(c_acc, f, c)
    return reduce_from_group(f_acc, group), reduce_from_group(c_acc, group)


def pipeline_loss(
    layer: nn.Module,
    stage_params: Mapping[str, torch.Tensor],
    feats_mb: torch.Tensor,                     # (M, mb, n, d)
    coors_mb: torch.Tensor,                     # (M, mb, n, c)
    loss_fn: Callable,                          # (feats, coors, target, mask | None) -> scalar
    target_mb: torch.Tensor,                    # (M, mb, n, c)
    mask_mb: Optional[torch.Tensor] = None,
    adj_mat: Optional[torch.Tensor] = None,
    *,
    group,
) -> torch.Tensor:
    """The streaming-loss pipeline: the last stage adds each microbatch's
    ``loss_fn`` to a scalar at the tick it drains, so nothing of (M, ...)
    size is collected. Returns the mean over the microbatches on every rank
    (one scalar sum over the group); ``backward()`` on every rank gives
    each stage its parameters' gradients and stage 0 its inputs'. T - 1
    permutes and one scalar sum a call."""
    M = feats_mb.shape[0]
    acc = []

    def drain(m, f, c):
        acc.append(loss_fn(f, c, target_mb[m], mask_mb[m] if mask_mb is not None else None))

    f, c = _schedule(layer, stage_params, feats_mb, coors_mb, mask_mb, adj_mat, group, drain)
    local = torch.stack(acc).sum() / M if acc else feats_mb.new_zeros(())
    return reduce_from_group(_Join.apply(local, f, c), group)


def _microbatches(x: Optional[torch.Tensor], M: int) -> Optional[torch.Tensor]:
    if x is None:
        return None
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} does not split into {M} microbatches")
    return x.reshape(M, x.shape[0] // M, *x.shape[1:])


def make_pipelined_apply(layer: nn.Module, group, n_microbatches: int) -> Callable:
    """``apply(stage_params, feats, coors, mask=None, adj_mat=None)`` over
    whole batches (b divisible by ``n_microbatches``), ``stage_params`` this
    rank's block: the sequential stack's (feats (b, n, d), coors (b, n, c))
    on every rank. Under it, as under the JAX package's jitted apply, a
    layer with ``only_sparse_neighbors`` takes its given k
    (``ops/neighbors.py:static_k``)."""
    from ..ops.neighbors import static_k   # ops imports parallel
    check_group(group, "group")

    def apply(stage_params, feats, coors, mask=None, adj_mat=None):
        M = n_microbatches
        with static_k():
            fo, co = pipeline_apply(layer, stage_params, _microbatches(feats, M),
                                    _microbatches(coors, M), _microbatches(mask, M), adj_mat,
                                    group=group)
        return fo.reshape(feats.shape), co.reshape(coors.shape)

    return apply


def make_pipelined_loss(layer: nn.Module, group, n_microbatches: int,
                        loss_fn: Callable) -> Callable:
    """``loss(stage_params, feats, coors, target, mask=None, adj_mat=None)``
    over whole batches: the mean of the microbatches' ``loss_fn`` (the
    sequential stack's batch-mean loss where ``loss_fn`` is a mean and the
    batch splits evenly), on every rank; differentiate it on every rank.
    Static k as in ``make_pipelined_apply``."""
    from ..ops.neighbors import static_k   # ops imports parallel
    check_group(group, "group")

    def loss(stage_params, feats, coors, target, mask=None, adj_mat=None):
        M = n_microbatches
        with static_k():
            return pipeline_loss(layer, stage_params, _microbatches(feats, M),
                                 _microbatches(coors, M), loss_fn, _microbatches(target, M),
                                 _microbatches(mask, M), adj_mat, group=group)

    return loss
