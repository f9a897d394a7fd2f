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
  ranks' blocks of rows in rank order (``dim=1``: of a batch's nodes, the
  node-sharded dense layer's table). Its backward sums the cotangents over
  the group and keeps this rank's block: ``reduce_scatter`` under NCCL, an
  ``all_reduce`` and a slice under gloo (the same sums).
- ``ring_permute``: ``lax.ppermute`` around the ring (rank r sends to r + 1
  and receives from r - 1), for one tensor or several in one message. Its
  backward is the reverse permute. Point to point only: no rank ever holds
  more than its own block and the visiting one.
- The Megatron pair for tensor parallelism, where every rank of the group
  holds the whole loss (not a share of it): ``copy_to_group`` is the
  identity with a summing backward (the input of a column-parallel
  product), ``reduce_from_group`` the sum with an identity backward (the
  output of a row-parallel product); ``gather_from_group`` concatenates
  the ranks' shards along a dimension and its backward keeps this rank's
  slice of the cotangent. ``all_reduce_sum`` in their place would scale the
  gradients by the group's size.

The route is chosen from the group's backend. Under NCCL every collective
runs on the card. Under gloo a CUDA tensor is copied to host memory, reduced
or gathered there and copied back: gloo's CUDA paths do not cover every
collective, and the host copy is the one path they all share (two ranks
that share one card must use gloo, as NCCL refuses them). A group of one
rank still runs its collective, so that its results are the bits of a group
of many.
"""
from __future__ import annotations

import math

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


def all_gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """(rows, ...) on each rank -> (size * rows, ...), rank r's rows at
    [r * rows, (r + 1) * rows); the backward keeps this rank's block of the
    summed cotangents. ``dim``: the dimension gathered (1: the nodes of a
    (b, n_local, ...) block)."""
    if dim == 0:
        return _AllGatherRows.apply(x, group)
    return _AllGatherRows.apply(x.movedim(dim, 0), group).movedim(0, dim)


def shard_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` split along ``dim`` over ``group``."""
    size = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * size, size)


def shard_cols(group, width: int) -> tuple[int, int]:
    """Where this rank holds ``width`` columns of a tensor split evenly over
    ``group``: its first column and the whole width, ``(c0, w)``."""
    return dist.get_rank(group) * width, width * dist.get_world_size(group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] * dist.get_world_size(group),) + tuple(moved.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _all_gather(out, moved, group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return shard_along(g, ctx.group, ctx.dim).contiguous(), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; the backward sums the cotangents over ``group``
    (Megatron's f: every rank's column block sees a share of ``x``'s
    gradient)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the backward passes the cotangent on
    unchanged (Megatron's g: every rank holds the whole loss)."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' shards of a tensor concatenated along ``dim`` in rank
    order; the backward keeps this rank's slice of the cotangent (every rank
    holds the whole loss, so nothing is summed)."""
    return _GatherFromGroup.apply(x, group, dim)


def _permute_bytes(buf: torch.Tensor, group, wrap: bool, reverse: bool) -> torch.Tensor:
    """Send ``buf`` (uint8) one rank on around the group (back, with
    ``reverse``) and return the buffer that arrives; zeros where none does
    (``wrap=False``: nothing crosses from the last rank to the first)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    step = -1 if reverse else 1
    dst, src = (rank + step) % size, (rank - step) % size
    send = wrap or 0 <= rank + step < size
    recv = wrap or 0 <= rank - step < size
    out = torch.zeros_like(buf)
    if size == 1 and wrap:
        return out.copy_(buf)
    if not (send or recv):
        return out
    if dist.get_backend(group) == dist.Backend.GLOO:
        host_in = buf.cpu() if send else None
        host_out = torch.zeros(buf.shape, dtype=buf.dtype) if recv else None
        works = ([dist.isend(host_in, dist.get_global_rank(group, dst), group=group)]
                 if send else [])
        works += ([dist.irecv(host_out, dist.get_global_rank(group, src), group=group)]
                  if recv else [])
        for w in works:
            w.wait()
        return out.copy_(host_out) if recv else out
    ops = ([dist.P2POp(dist.isend, buf, dist.get_global_rank(group, dst), group)] if send else [])
    ops += ([dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)] if recv else [])
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def _pack(ts) -> torch.Tensor:
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in ts])


def _unpack(buf: torch.Tensor, metas) -> list:
    out, off = [], 0
    for shape, dtype in metas:
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        out.append(buf[off:off + nbytes].view(dtype).view(shape))
        off += nbytes
    return out


class _RingPermute(torch.autograd.Function):
    """Forward: the tensors to rank + 1, in one message; backward: the
    floating tensors' cotangents to rank - 1, in one message. Tensors go in
    the order of falling element size, so that each starts aligned in the
    byte buffer."""

    @staticmethod
    def forward(ctx, group, wrap, *xs):
        ctx.group, ctx.wrap = group, wrap
        ctx.metas = [(tuple(x.shape), x.dtype) for x in xs]
        ctx.grad_of = [i for i, x in enumerate(xs) if x.is_floating_point()]
        outs = _unpack(_permute_bytes(_pack(xs), group, wrap, False), ctx.metas)
        ctx.mark_non_differentiable(*[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        # every floating tensor's cotangent travels, whether or not its input
        # needs it here, so that both ends of each message agree on its size
        metas = [ctx.metas[i] for i in ctx.grad_of]
        back = _unpack(_permute_bytes(_pack([gs[i] for i in ctx.grad_of]), ctx.group,
                                      ctx.wrap, True), metas)
        grads = [None] * len(ctx.metas)
        for i, g in zip(ctx.grad_of, back):
            grads[i] = g if ctx.needs_input_grad[2 + i] else None
        return (None, None, *grads)


def ring_permute(x, group, wrap: bool = True):
    """``lax.ppermute`` over the ring of ``group``: every rank sends ``x`` to
    rank + 1 and returns what rank - 1 sent. ``x`` is a tensor or a tuple of
    tensors (sent as one message, returned as a tuple), of the same shapes
    and dtypes on every rank. With ``wrap=False`` the last rank sends
    nothing and rank 0 receives zeros, as ``ppermute`` gives a device that
    no pair names. The backward is the reverse permute (the cotangents go
    to rank - 1), one message for all the floating tensors. Every rank must
    call it, forward and backward, in the same order: each call is one
    message each way. Under NCCL the messages are one
    ``batch_isend_irecv``, under gloo an ``isend`` and an ``irecv`` of a
    host copy."""
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    order = sorted(range(len(xs)), key=lambda i: -xs[i].element_size())
    outs = _RingPermute.apply(group, wrap, *[xs[i] for i in order])
    result = [None] * len(xs)
    for j, i in enumerate(order):
        result[i] = outs[j]
    return result[0] if single else tuple(result)
