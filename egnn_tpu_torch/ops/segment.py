"""Segment (scatter) sums, differentiable.

PyTorch counterpart of ``egnn_tpu/ops/segment.py:21-77``: ``segment_sum``
over one edge list and ``batched_segment_sum`` over a batch of graphs whose
ids each address their own graph's rows. Both run kernel K2
(``ops/cuda/segment.py``) on a CUDA tensor and its plain version on a CPU
tensor. K2 takes the batch as a grid dimension, so the batched form needs
neither the JAX package's vmap nor its flattening.

The backward is the gather ``g[ids]`` of ``segment_sum_pallas``'s VJP
(``egnn_tpu/ops/pallas/segment.py:141-143``), index quirk included: a
negative id wraps once (-1 reads the last segment) and the result is clamped
into [0, S), so an id >= S reads segment S - 1.

The sparse path's reductions follow ``egnn_tpu/ops/segment.py:80-292``:
``segment_count``, ``segment_mean``, ``segment_max``, ``segment_aggregate``,
``segment_softmax``, ``graph_layer_norm`` and ``uniform_aggregate``. Every
floating-point segment sum among them goes through ``segment_sum`` (K2 on
the card), the per-node reads of per-graph statistics through
``ops/core.py:gather_rows`` (whose backward is K2 too). The max reductions
are ``scatter_reduce`` / ``amax``, as the JAX package leaves them to XLA;
their gradient splits evenly among tied maxima, JAX's rule for
``segment_max`` and ``max``. ``segment_softmax`` and ``graph_layer_norm``
take a process group as ``axis_name`` (the JAX package takes a mesh axis
name): the node rows are then block-sharded over its ranks, and their
statistics are summed (and the softmax's shift maxed) over the group through
``parallel/collectives.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.collectives import all_reduce_max, all_reduce_sum, check_group
from .cuda import segment as seg_kernels


def _apply_edge_mask(data: torch.Tensor, mask: torch.Tensor, fill) -> torch.Tensor:
    """Fill masked rows; handles both (E,) and (E, d) data."""
    m = mask if mask.dim() == data.dim() else mask[..., None]
    # torch.full, not a host tensor: a CUDA graph may capture this
    return torch.where(m, data, torch.full((), fill, dtype=data.dtype, device=data.device))


def _gather_segments(g: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(b, S, D) rows at (b, E) ids, read as JAX indexing reads them."""
    idx = torch.where(ids < 0, ids + num_segments, ids).clamp(0, num_segments - 1)
    return torch.gather(g, 1, idx.long()[..., None].expand(-1, -1, g.shape[-1]))


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        return seg_kernels.segment_sum(data.contiguous(), ids.contiguous(), num_segments)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _gather_segments(g, ids, ctx.num_segments), None, None


def batched_segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-graph segment sum: ``data`` (b, E, D) + ``segment_ids`` (b, E) ->
    (b, num_segments, D); ids outside [0, num_segments) add nothing."""
    return _SegmentSum.apply(data, segment_ids, num_segments)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum ``data`` (E, ...) into ``num_segments`` rows keyed by
    ``segment_ids`` (E,); rows where ``mask`` is False add nothing."""
    if mask is not None:
        data = _apply_edge_mask(data, mask, 0)
    e, rest = data.shape[0], tuple(data.shape[1:])
    out = batched_segment_sum(data.reshape(1, e, math.prod(rest)),
                              segment_ids.reshape(1, e), num_segments)
    return out.reshape((num_segments,) + rest)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(num_segments,) count of the ids in each segment, rows where ``mask``
    is False left out."""
    ones = torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Segment sum over the valid rows divided by their count, at least 1."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask, dtype=data.dtype)
    if total.dim() > count.dim():
        count = count[..., None]
    return total / count.clamp(min=1.0)


def _rows_of(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` along the first axis, ids read as ``_gather_segments`` reads them."""
    from .core import gather_rows

    n = x.shape[0]
    return gather_rows(x, torch.where(ids < 0, ids + n, ids).clamp(0, n - 1))


class _SegmentMax(torch.autograd.Function):
    """The segment max (empty segments -inf) whose gradient goes to the rows
    that equal their segment's max, split evenly among them."""

    @staticmethod
    def forward(ctx, data, ids, num_segments):
        idx = ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
        out = torch.full((num_segments,) + tuple(data.shape[1:]), -math.inf,
                         dtype=data.dtype, device=data.device)
        out = out.scatter_reduce(0, idx, data, "amax", include_self=True)
        ctx.save_for_backward(data, ids, out)
        ctx.num_segments = num_segments
        return out

    @staticmethod
    def backward(ctx, g):
        data, ids, out = ctx.saved_tensors
        hit = (data == _rows_of(out, ids)).to(g.dtype)
        ties = segment_sum(hit, ids, ctx.num_segments)
        return hit * _rows_of(g / ties.clamp(min=1.0), ids), None, None


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Segment max over the valid rows; empty segments give 0 (torch-scatter's
    fill in PyG)."""
    if mask is not None:
        data = _apply_edge_mask(data, mask, -math.inf)
    out = _SegmentMax.apply(data, segment_ids, num_segments)
    return torch.where(torch.isneginf(out), torch.zeros((), dtype=out.dtype, device=out.device),
                       out)


def segment_aggregate(
    aggr: str,
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """EGNN_Sparse's ``aggr in {add, sum, max, mean}`` (egnn_pytorch_geometric.py:123)."""
    if aggr in ("add", "sum"):
        return segment_sum(data, segment_ids, num_segments, mask)
    if aggr == "mean":
        return segment_mean(data, segment_ids, num_segments, mask)
    if aggr == "max":
        return segment_max(data, segment_ids, num_segments, mask)
    raise ValueError(f"unknown aggr {aggr!r}; must be add/sum/max/mean")


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    axis_name=None,
) -> torch.Tensor:
    """Softmax within each segment, shifted by the segment's max (which
    carries no gradient: the softmax does not depend on it); masked entries
    get 0.

    ``axis_name``: a process group over whose ranks the rows are
    block-sharded; the max and the normaliser are then the group's, so that
    every rank's rows are normalised by the global per-segment statistics."""
    check_group(axis_name, "axis_name")
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), -math.inf, dtype=logits.dtype,
                                                      device=logits.device))
    with torch.no_grad():
        seg_max = _SegmentMax.apply(logits.detach(), segment_ids, num_segments)
        if axis_name is not None:
            seg_max = all_reduce_max(seg_max, axis_name)
        seg_max = torch.where(torch.isneginf(seg_max), 0.0, seg_max)
    shifted = logits - _rows_of(seg_max, segment_ids)
    ex = torch.exp(shifted)
    if mask is not None:
        ex = torch.where(mask, ex, torch.zeros((), dtype=ex.dtype, device=ex.device))
    denom = segment_sum(ex, segment_ids, num_segments)
    if axis_name is not None:
        denom = all_reduce_sum(denom, axis_name)
    return ex / _rows_of(denom, segment_ids).clamp(min=torch.finfo(ex.dtype).tiny)


def graph_layer_norm(
    x: torch.Tensor,
    batch: Optional[torch.Tensor],
    num_graphs: int,
    gamma: Optional[torch.Tensor],
    beta: Optional[torch.Tensor],
    eps: float = 1e-5,
    node_mask: Optional[torch.Tensor] = None,
    axis_name=None,
    uniform_size: Optional[int] = None,
) -> torch.Tensor:
    """PyG's graph-mode LayerNorm (egnn_pytorch_geometric.py:156): statistics
    over all node x channel entries of each graph, biased variance, the
    rows where ``node_mask`` is False left out of them.

    ``uniform_size``: rows [g*s, (g+1)*s) all belong to graph g (a
    contiguous ``batch`` of equal-size graphs); the statistics then reduce
    by reshape, with no segment sum. The same math; the sums run in another
    order.

    ``axis_name``: a process group over whose ranks the rows are
    block-sharded; each graph's count and sums are then the group's, so that
    every rank normalises with the global statistics. ``uniform_size`` is
    ignored then, as in the JAX package."""
    check_group(axis_name, "axis_name")
    psum = (lambda v: all_reduce_sum(v, axis_name)) if axis_name is not None else (lambda v: v)
    n, d = x.shape
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if batch is None:
        batch = torch.zeros((n,), dtype=torch.int64, device=x.device)
        num_graphs = 1
    if uniform_size is not None and axis_name is None:
        s = uniform_size
        if n != num_graphs * s:
            raise ValueError(f"uniform_size={s} needs n = num_graphs*s = {num_graphs * s}, "
                             f"got {n}")
        xr = x.reshape(num_graphs, s * d)
        if node_mask is not None:
            mr = node_mask.reshape(num_graphs, s).repeat_interleave(d, dim=1)
            cnt = mr.sum(dim=1).to(x.dtype).clamp(min=1.0)[:, None]
            xm = torch.where(mr, xr, zero)
        else:
            cnt = float(s * d)
            xm = xr
        mean = xm.sum(dim=1, keepdim=True) / cnt
        centered = xr - mean
        if node_mask is not None:
            centered = torch.where(mr, centered, zero)
        var = (centered ** 2).sum(dim=1, keepdim=True) / cnt
        out = ((xr - mean) * torch.rsqrt(var + eps)).reshape(n, d)
    else:
        count = (psum(segment_count(batch, num_graphs, node_mask, dtype=x.dtype)) * d).clamp(
            min=1.0)
        total = psum(segment_sum(x, batch, num_graphs, node_mask).sum(dim=-1))
        mean = _rows_of(total / count, batch)[:, None]
        centered = x - mean
        if node_mask is not None:
            centered = torch.where(node_mask[:, None], centered, zero)
        sq = psum(segment_sum(centered ** 2, batch, num_graphs, node_mask).sum(dim=-1))
        var = _rows_of(sq / count, batch)[:, None]
        out = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out


def uniform_aggregate(
    aggr: str,
    data: torch.Tensor,
    degree: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Aggregation over a receiver-major uniform-degree edge layout: edge
    rows [i*degree, (i+1)*degree) belong to receiver i by position (what
    every ``ops/graph.py`` kNN builder emits). A reshape-reduce, no
    scatter; equal to ``segment_aggregate`` over ``repeat(arange(n),
    degree)``, PyG's mean and max conventions included."""
    e, w = data.shape
    n = e // degree
    if n * degree != e:
        raise ValueError(f"edge count {e} not divisible by degree {degree}")
    d3 = data.reshape(n, degree, w)
    m3 = None if mask is None else mask.reshape(n, degree, 1)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if aggr in ("add", "sum", "mean"):
        s = (torch.where(m3, d3, zero) if m3 is not None else d3).sum(dim=1)
        if aggr == "mean":
            if m3 is not None:
                s = s / m3.sum(dim=1).to(data.dtype).clamp(min=1.0)
            else:
                s = s / degree
        return s
    if aggr == "max":
        if m3 is not None:
            d3 = torch.where(m3, d3, torch.full((), -math.inf, dtype=data.dtype,
                                                device=data.device))
        out = d3.amax(dim=1)   # the gradient splits evenly among tied maxima
        return torch.where(torch.isneginf(out), zero, out)
    raise ValueError(f"unknown aggr {aggr!r}; must be add/sum/max/mean")
