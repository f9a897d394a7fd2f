"""Differentiable collectives over a process group: the port's counterparts
of the ``lax`` collectives that the JAX package calls inline under
``shard_map``.

- ``all_reduce_sum``: ``lax.psum``. Its backward is the sum of the
  cotangents over the group, as the psum's transpose: with every rank
  differentiating its own local loss, the gradients are then those of the
  sum of the ranks' losses, the JAX steps' psum-after-grad discipline
  (``egnn_tpu/training/state.py:186-204``).
- ``all_reduce_max``: ``lax.pmax``, without a gradient (the JAX code
  applies it under ``stop_gradient``, ``egnn_tpu/ops/segment.py:156-161``).
- ``all_gather_rows``: ``lax.all_gather(..., axis=0, tiled=True)``, the
  ranks' blocks of rows in rank order. Its backward sums the cotangents
  over the group and keeps this rank's block: ``reduce_scatter`` under
  NCCL, an ``all_reduce`` and a slice under gloo (the same sums).

The route is chosen from the group's backend. Under NCCL every collective
runs on the card. Under gloo a CUDA tensor is copied to host memory, reduced
or gathered there and copied back: gloo's CUDA paths do not cover every
collective, and the host copy is the one path they all share (two ranks
that share one card must use gloo, as NCCL refuses them). A group of one
rank still runs its collective, so that its results are the bits of a group
of many.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def check_group(group, name: str) -> None:
    """Raise ``TypeError`` unless ``group`` is ``None`` or a process group:
    where the JAX package takes a mesh axis name (``"graph"``), the port
    takes that axis's group (``mesh.get_group("graph")``)."""
    if group is not None and not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"{name} takes a torch.distributed process group (e.g. "
                        f"mesh.get_group('graph')), not {group!r}: the JAX package's mesh "
                        f"axis names have no meaning here")


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (no gradient); returns ``t``."""
    if _through_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """Overwrite ``t`` with the group's first rank's ``t`` (no gradient)."""
    src = dist.get_global_rank(group, 0)
    if _through_host(t, group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        return t.copy_(host)
    dist.broadcast(t, src=src, group=group)
    return t


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    if _through_host(x, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        gather(host, x.cpu(), group=group)
        out.copy_(host)
    else:
        gather(out, x, group=group)


def _reduce_scatter_rows(g: torch.Tensor, group) -> torch.Tensor:
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    rows = g.shape[0] // size
    if dist.get_backend(group) == dist.Backend.GLOO:
        return all_reduce_(g.clone(), group)[rank * rows:(rank + 1) * rows]
    out = torch.empty((rows,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, g, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty((x.shape[0] * dist.get_world_size(group),) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _all_gather(out, x, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_rows(g.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the backward sums the cotangents."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``; carries no gradient."""
    with torch.no_grad():
        return all_reduce_(x.detach().contiguous().clone(), group, dist.ReduceOp.MAX)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(rows, ...) on each rank -> (size * rows, ...), rank r's rows at
    [r * rows, (r + 1) * rows); the backward keeps this rank's block of the
    summed cotangents."""
    return _AllGatherRows.apply(x, group)
