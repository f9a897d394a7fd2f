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

The mean, max, softmax and graph-norm reductions of the JAX module belong to
the sparse path and are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .cuda import segment as seg_kernels


def _apply_edge_mask(data: torch.Tensor, mask: torch.Tensor, fill) -> torch.Tensor:
    """Fill masked rows; handles both (E,) and (E, d) data."""
    m = mask if mask.dim() == data.dim() else mask[..., None]
    return torch.where(m, data, torch.as_tensor(fill, dtype=data.dtype, device=data.device))


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
