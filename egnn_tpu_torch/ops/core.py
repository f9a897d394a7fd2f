"""Primitive numerics shared by the EGNN layer and the kNN selection.

PyTorch counterparts of ``egnn_tpu/ops/core.py``: the same behaviour (the
reference library's helpers, egnn_pytorch.py:10-77) as plain tensor
functions. ``gather_nodes``, ``gather_rows`` and ``gather_rows_blocked``
have a backward of their own: the segment sum of ``ops/segment.py`` (kernel
K2 on the card), as the JAX package's custom VJPs route it.
"""
from __future__ import annotations

from typing import Optional

import torch

from .segment import batched_segment_sum, segment_sum


def exists(val) -> bool:
    return val is not None


def safe_div(num: torch.Tensor, den: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Masked-mean division: clamp the denominator to ``eps``, zero where it
    is 0 (egnn_pytorch.py:13-16)."""
    res = num / den.clamp(min=eps)
    return torch.where(den == 0, torch.zeros((), dtype=res.dtype, device=res.device), res)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            whole: Optional[tuple] = None, slices=()) -> torch.Tensor:
    """Inverted dropout, Flax's ``nn.Dropout``: each entry kept with
    probability 1 - rate and then divided by it, else 0. The mask is drawn
    from ``generator``, never from the global one.

    A sharded call passes ``whole``, the shape of the tensor of which ``x``
    is a part, and ``slices``, the part as ``(dim, start, length)`` triples:
    the mask of the whole is drawn, as the one-process call draws it from
    the same generator state, and the part kept (``sharded_part`` gives
    both)."""
    keep_p = 1.0 - rate
    u = torch.rand(x.shape if whole is None else whole, generator=generator, device=x.device,
                   dtype=torch.float32)
    for dim, start, length in slices:
        u = u.narrow(dim, start, length)
    if u.shape != x.shape:
        raise ValueError(f"the part {tuple(u.shape)} of the whole {whole} is not x's "
                         f"{tuple(x.shape)}")
    return torch.where(u < keep_p, x / keep_p, torch.zeros((), dtype=x.dtype, device=x.device))


def sharded_part(shape, rows: Optional[tuple[int, int]] = None,
                 cols: Optional[tuple[int, int]] = None) -> tuple:
    """``(whole, slices)`` for ``dropout`` of a tensor of ``shape`` that holds
    the rows r0 .. on dim 1 of a whole of n rows (``rows = (r0, n)``, the
    graph axis) and the columns c0 .. on its last dim of a whole of w
    (``cols = (c0, w)``, tensor parallelism); ``()`` with neither, which
    leaves ``dropout`` its one-process draw."""
    if rows is None and cols is None:
        return ()
    whole, slices = list(shape), []
    if rows is not None:
        whole[1] = rows[1]
        slices.append((1, rows[0], shape[1]))
    if cols is not None:
        whole[-1] = cols[1]
        slices.append((len(shape) - 1, cols[0], shape[-1]))
    return tuple(whole), tuple(slices)


def fourier_encode_dist(
    x: torch.Tensor, num_encodings: int = 4, include_self: bool = True
) -> torch.Tensor:
    """(...,) -> (..., 2*num_encodings + include_self): ``[sin(x/s), cos(x/s), x]``
    with scales ``2**arange(num_encodings)`` (egnn_pytorch.py:34-41)."""
    x = x[..., None]
    scales = 2 ** torch.arange(num_encodings, dtype=x.dtype, device=x.device)
    xs = x / scales
    out = torch.cat([torch.sin(xs), torch.cos(xs)], dim=-1)
    if include_self:
        out = torch.cat([out, x], dim=-1)
    return out


def batched_index_select(values: torch.Tensor, indices: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Gather ``values`` along ``axis`` with a batched index tensor
    (egnn_pytorch.py:18-32): ``indices`` has the batch dims of
    ``values[:axis]`` plus any extra dims, and the result keeps ``values``'
    trailing dims. values (b, n, d), indices (b, i, k), axis=1 ->
    (b, i, k, d) with out[b, i, k] = values[b, indices[b, i, k]]."""
    value_dims = values.shape[axis + 1:]
    n_extra = indices.dim() - axis
    v = values
    for _ in range(n_extra - 1):
        v = v.unsqueeze(axis)
    idx = indices.reshape(indices.shape + (1,) * len(value_dims))
    gather_axis = axis + n_extra - 1
    # take_along_axis broadcasts; torch.gather needs the shapes spelled out
    shape = [max(a, b) for a, b in zip(v.shape, idx.shape)]
    v_shape, idx_shape = list(shape), list(shape)
    v_shape[gather_axis] = v.shape[gather_axis]
    idx_shape[gather_axis] = idx.shape[gather_axis]
    return torch.gather(v.expand(v_shape), gather_axis, idx.long().expand(idx_shape))


def gather_bool(mask: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Boolean gather of a (b, n) mask at (b, n, k) indices."""
    return batched_index_select(mask.float(), indices, axis=1) > 0.5


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, indices):
        ctx.save_for_backward(indices)
        ctx.num_nodes = values.shape[1]
        return batched_index_select(values, indices, axis=1)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        b, d = g.shape[0], g.shape[-1]
        dv = batched_segment_sum(
            g.contiguous().reshape(b, -1, d), indices.reshape(b, -1), ctx.num_nodes)
        return dv, None


def gather_nodes(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Neighbour gather (b, n, d) x (b, n, k) -> (b, n, k, d), the
    counterpart of ``egnn_tpu/ops/core.py:79-102``: the forward is a plain
    index; the backward sums the rows' cotangents into node rows with
    ``batched_segment_sum`` (kernel K2 on the card)."""
    return _GatherNodes.apply(values, indices)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, indices):
        ctx.save_for_backward(indices)
        ctx.num_rows = values.shape[0]
        return values[indices.long()]

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        return segment_sum(g.contiguous(), indices, ctx.num_rows), None


def gather_rows(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather (n, ...) x (e,) -> (e, ...) for the COO path, the
    counterpart of ``egnn_tpu/ops/core.py:106-124``: the forward is a plain
    index; the backward sums the rows' cotangents into ``values``' rows with
    ``segment_sum`` (kernel K2 on the card)."""
    return _GatherRows.apply(values, indices)


def gather_rows_blocked(
    values: torch.Tensor,
    indices: torch.Tensor,
    num_blocks: int,
    rows_per_block: int,
) -> torch.Tensor:
    """Row gather for block-local index sets (``egnn_tpu/ops/core.py:127``):
    the g-th block of edge rows, positions [g*e_b, (g+1)*e_b), reads value
    rows [g*r_b, (g+1)*r_b), the layout of batched graphs of one size. An
    index outside its block gathers zeros. The JAX package takes a one-hot
    matmul per block on the TPU; here it is the indexed load of
    ``gather_rows`` under that contract, with K2 as its backward."""
    n = values.shape[0]
    if n != num_blocks * rows_per_block:
        raise ValueError(f"{n} rows are not {num_blocks} blocks of {rows_per_block}")
    e = indices.shape[0]
    if e % num_blocks:
        raise ValueError(f"{e} edge rows do not split into {num_blocks} blocks")
    block = torch.arange(e, device=indices.device) // (e // num_blocks)
    ok = (indices >= block * rows_per_block) & (indices < (block + 1) * rows_per_block)
    rows = gather_rows(values, torch.where(ok, indices, 0))
    ok = ok.reshape((e,) + (1,) * (values.dim() - 1))
    return torch.where(ok, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


def coors_norm(coors: torch.Tensor, scale: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """CoorsNorm (egnn_pytorch.py:67-77): unit-length rows rescaled by a
    learned (1,) scalar. The clamp sits inside the sqrt, as in the JAX
    package, so the gradient at the zero self-pair vector is 0."""
    sum_sq = (coors**2).sum(dim=-1, keepdim=True)
    norm = torch.sqrt(sum_sq.clamp(min=eps * eps))
    return coors / norm * scale


def layer_norm(
    x: torch.Tensor,
    gamma: Optional[torch.Tensor],
    beta: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> torch.Tensor:
    """torch.nn.LayerNorm semantics over the last axis (biased variance)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out


def embed_tokens(x: torch.Tensor, dims, tables) -> torch.Tensor:
    """Replace the last ``len(dims)`` columns of ``x`` (integer token ids)
    by their embeddings, left to right, each ``tables[i][token]``
    concatenated on the right (egnn_pytorch.py:43-52,
    ``egnn_tpu/ops/core.py:205``). The lookups are ``gather_rows``."""
    if not dims:
        return x
    stop_concat = -len(dims)
    to_embed = x[:, stop_concat:].long()
    for i, table in enumerate(tables):
        x = torch.cat([x[:, :stop_concat], gather_rows(table, to_embed[:, i]).to(x.dtype)],
                      dim=-1)
        stop_concat = x.shape[-1]
    return x
