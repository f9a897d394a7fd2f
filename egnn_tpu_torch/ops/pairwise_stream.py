"""Streamed all-pairs EGNN messages: the dense layer without (n, n) tensors.

Counterpart of ``egnn_tpu/ops/pairwise_stream.py``. The dense layer's
all-pairs branch materialises every pairwise intermediate (rel_coors
(b, n, n, c), the edge-MLP's (b, n, n, hidden), m_ij (b, n, n, m)), which
caps n at a few thousand nodes. Here the same math runs as a loop over
j-chunks: only (b, n, CJ, ·) intermediates exist, and each chunk is
recomputed in the backward (``torch.utils.checkpoint``) instead of stored,
so peak memory is O(b·n·CJ·hidden) for any n.

The caller passes the factorised first layer's per-node projections
``proj_i`` (bias folded in) and ``proj_j``; only the distance term stays
pairwise. Semantics are the reference's all-pairs branch without kNN or
dense ``edges``: fourier features, soft-edge gate, CoorsNorm, clamp, pair
mask, sum pooling (the caller divides for the mean), dropout and
``compute_dtype``. Under ``compute_dtype`` the message MLP runs in that dtype
while every piece of geometry (rel_coors, distances, CoorsNorm, the
coordinate weighting) and the cross-chunk sums stay float32 or wider.

There is no kernel here: the JAX package computes this path in XLA outside
any Pallas kernel, and the port's chunks are torch operators on cuBLAS.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import copy_to_group, reduce_from_group, shard_cols
from .core import dropout, fourier_encode_dist, sharded_part


class PairwiseParams(NamedTuple):
    """Weights of the pairwise message pipeline (names as in models/egnn.py)."""

    w_d: torch.Tensor                 # (dist_dim, hidden) distance rows of edge_mlp_0
    edge_w2: torch.Tensor             # (hidden, m_dim)
    edge_b2: torch.Tensor             # (m_dim,)
    gate_w: Optional[torch.Tensor]    # (m_dim, 1) | None: soft_edges
    gate_b: Optional[torch.Tensor]
    coors_w1: Optional[torch.Tensor]  # (m_dim, 4*m_dim) | None: update_coors
    coors_b1: Optional[torch.Tensor]
    coors_w2: Optional[torch.Tensor]  # (4*m_dim, 1)
    coors_b2: Optional[torch.Tensor]
    cn_scale: Optional[torch.Tensor]  # (1,) CoorsNorm scale | None


class PairwiseResult(NamedTuple):
    m_i: torch.Tensor                   # (b, n, m_dim) summed messages
    coors_delta: torch.Tensor           # (b, n, c) sum_j w_ij rel_ij (0 without update_coors)
    pair_count: Optional[torch.Tensor]  # (b, n) valid pairs of each i (None without mask)


def _auto_chunk(b: int, n: int, hidden: int, budget_bytes: int = 64 * 1024 * 1024) -> int:
    """Largest power-of-two j-chunk whose (b, n, CJ, hidden) f32 intermediate
    fits the budget."""
    cj = 128
    while cj > 8 and b * n * cj * hidden * 4 > budget_bytes:
        cj //= 2
    return cj


def pairwise_block(
    coors_i: torch.Tensor,     # (b, ni, c)
    proj_i: torch.Tensor,      # (b, ni, hidden): feats_i @ W_i + edge_b1
    coors_j: torch.Tensor,     # (b, nj, c)
    proj_j: torch.Tensor,      # (b, nj, hidden): feats_j @ W_j
    pair_valid: Optional[torch.Tensor],   # (b, ni, nj) bool, or None: all valid
    params: PairwiseParams,
    *,
    fourier_features: int = 0,
    update_coors: bool = True,
    update_feats: bool = True,
    soft_edges: bool = False,
    norm_coors: bool = False,
    coor_weights_clamp_value: Optional[float] = None,
    coors_norm_eps: float = 1e-8,
    compute_dtype: Optional[torch.dtype] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    edge_group=None,
    coors_group=None,
    rows: Optional[tuple[int, int]] = None,
):
    """One (i-block x j-block) of the dense pairwise pipeline: distance
    features -> edge MLP -> [gate] -> coordinate weights and message sums.

    Returns the partial sums ``(m_sum (b, ni, m), coors_delta (b, ni, c),
    count (b, ni))`` that the caller accumulates over j-blocks, in the
    reference's order of masking (egnn_pytorch.py:282-333). With
    ``dropout_rate > 0`` and a ``generator``, inverted dropout acts after
    the edge MLP's and the coordinate MLP's first layers (egnn_pytorch.py:
    178-208), the first mask drawn first.

    ``edge_group`` / ``coors_group``: the model group under tensor
    parallelism where this rank holds a shard of the edge / coordinate MLP
    (``params``' widths are then the shards', ``proj_i`` and ``proj_j`` this
    rank's columns): the second product's partial sums are summed over the
    group (``reduce_from_group``) and the first product's input gradient
    too (``copy_to_group``). ``rows = (r0, n)``: the i-block is the rows r0
    .. r0 + ni - 1 of n (the ring's). A sharded block draws each dropout
    mask at the whole block's shape (all n rows, the whole hidden width)
    and keeps its part, so that its masks are those of the unsharded
    block."""
    # the caller sums these partials over many blocks: keep them >= f32 even
    # when compute_dtype (and so proj_i) is bf16, whose integers stop at 256
    acc_dtype = torch.promote_types(proj_i.dtype, torch.float32)
    b, ni, c = coors_i.shape
    mp = (lambda x: x) if compute_dtype is None else (lambda x: x.to(compute_dtype))
    if dropout_rate > 0.0 and generator is not None:
        def drop(x, group):
            cols = None if group is None else shard_cols(group, x.shape[-1])
            return dropout(x, dropout_rate, generator, *sharded_part(x.shape, rows, cols))
    else:
        def drop(x, group):
            return x

    rel = coors_i[:, :, None, :] - coors_j[:, None, :, :]   # (b, ni, nj, c)
    dist = (rel * rel).sum(dim=-1)                          # (b, ni, nj)
    dist_feats = fourier_encode_dist(dist, num_encodings=fourier_features) \
        if fourier_features > 0 else dist[..., None]

    if edge_group is not None:
        dist_feats = copy_to_group(dist_feats, edge_group)
    h1 = (mp(proj_i)[:, :, None, :] + mp(proj_j)[:, None, :, :]
          + mp(dist_feats) @ mp(params.w_d))
    m_ij = F.silu(drop(h1, edge_group))
    m_ij = m_ij @ mp(params.edge_w2)
    if edge_group is not None:
        m_ij = reduce_from_group(m_ij, edge_group)
    m_ij = F.silu(m_ij + mp(params.edge_b2))                          # (b, ni, nj, m)
    if soft_edges:
        m_ij = m_ij * torch.sigmoid(m_ij @ mp(params.gate_w) + mp(params.gate_b))

    if update_coors:
        m_c = m_ij if coors_group is None else copy_to_group(m_ij, coors_group)
        cw = F.silu(drop(m_c @ mp(params.coors_w1) + mp(params.coors_b1), coors_group))
        w_ij = cw @ mp(params.coors_w2)
        if coors_group is not None:
            w_ij = reduce_from_group(w_ij, coors_group)
        # back to full precision before weighting the geometry
        w_ij = (w_ij + mp(params.coors_b2))[..., 0].to(coors_i.dtype)
        if norm_coors:
            norm = torch.sqrt(dist.clamp(min=coors_norm_eps * coors_norm_eps))[..., None]
            rel_n = rel / norm * params.cn_scale.to(rel.dtype)
        else:
            rel_n = rel
        if pair_valid is not None:
            w_ij = torch.where(pair_valid, w_ij, torch.zeros((), dtype=w_ij.dtype,
                                                             device=w_ij.device))
        if coor_weights_clamp_value is not None:
            w_ij = w_ij.clamp(-coor_weights_clamp_value, coor_weights_clamp_value)
        coors_delta = torch.einsum("bij,bijc->bic", w_ij, rel_n)
    else:
        coors_delta = torch.zeros((b, ni, c), dtype=coors_i.dtype, device=coors_i.device)

    if update_feats:
        if pair_valid is not None:
            m_ij = torch.where(pair_valid[..., None], m_ij,
                               torch.zeros((), dtype=m_ij.dtype, device=m_ij.device))
            count = pair_valid.sum(dim=-1).to(acc_dtype)
        else:
            count = torch.full((b, ni), m_ij.shape[-2], dtype=acc_dtype, device=m_ij.device)
        m_sum = m_ij.sum(dim=-2).to(acc_dtype)
    else:
        m_sum = torch.zeros((b, ni, m_ij.shape[-1]), dtype=acc_dtype, device=coors_i.device)
        count = torch.zeros((b, ni), dtype=acc_dtype, device=coors_i.device)

    return m_sum, coors_delta, count


def streamed_pairwise(
    coors: torch.Tensor,       # (b, n, c)
    proj_i: torch.Tensor,      # (b, n, hidden): feats @ W_i + edge_b1
    proj_j: torch.Tensor,      # (b, n, hidden): feats @ W_j
    params: PairwiseParams,
    mask: Optional[torch.Tensor] = None,   # (b, n) bool
    *,
    fourier_features: int = 0,
    update_coors: bool = True,
    update_feats: bool = True,
    soft_edges: bool = False,
    norm_coors: bool = False,
    coor_weights_clamp_value: Optional[float] = None,
    chunk: Optional[int] = None,
    coors_norm_eps: float = 1e-8,
    compute_dtype: Optional[torch.dtype] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    edge_group=None,
    coors_group=None,
) -> PairwiseResult:
    """All-pairs messages and their sums without (n, n) intermediates.

    Returns the summed messages (mean pooling divides by ``pair_count``, the
    reference's masked mean, egnn_pytorch.py:324-333) and the equivariant
    coordinate delta sum_j w_ij rel_ij (egnn_pytorch.py:315). n is padded up
    to a multiple of the chunk (``_auto_chunk`` when ``chunk`` is None) and
    the padded j's are left out of every sum.

    Dropout: ``generator`` gives one seed a chunk (the JAX package's
    ``fold_in(rng, chunk)``), read once in the forward; each chunk draws its
    masks from a generator of its own made from that seed, and so does its
    recompute in the backward. A fixed ``generator`` state gives the same
    masks, outputs and gradients. ``edge_group`` / ``coors_group``: tensor
    parallelism, as in ``pairwise_block``.
    """
    b, n, c = coors.shape
    hidden = proj_i.shape[-1]
    m_dim = params.edge_w2.shape[-1]
    acc_dtype = torch.promote_types(proj_i.dtype, torch.float32)
    dev = coors.device

    cj = chunk or _auto_chunk(b, n, hidden)
    n_pad = -(-n // cj) * cj
    pad = n_pad - n
    coors_p = F.pad(coors, (0, 0, 0, pad))
    proj_j_p = F.pad(proj_j, (0, 0, 0, pad))
    jvalid = torch.arange(n_pad, device=dev) < n
    if mask is not None:
        mask_j_p = torch.cat([mask, torch.zeros((b, pad), dtype=torch.bool, device=dev)], dim=1)
    num_chunks = n_pad // cj
    dropping = dropout_rate > 0.0 and generator is not None
    seeds = torch.randint(0, 2**62, (num_chunks,), generator=generator,
                          device=generator.device).tolist() if dropping else [None] * num_chunks
    opts = dict(fourier_features=fourier_features, update_coors=update_coors,
                update_feats=update_feats, soft_edges=soft_edges, norm_coors=norm_coors,
                coor_weights_clamp_value=coor_weights_clamp_value,
                coors_norm_eps=coors_norm_eps, compute_dtype=compute_dtype,
                dropout_rate=dropout_rate if dropping else 0.0,
                edge_group=edge_group, coors_group=coors_group)

    def body(coors_j, pj, pv, seed):
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        return pairwise_block(coors, proj_i, coors_j, pj, pv, params, generator=gen, **opts)

    acc_m = torch.zeros((b, n, m_dim), dtype=acc_dtype, device=dev)
    acc_c = torch.zeros((b, n, c), dtype=coors.dtype, device=dev)
    acc_cnt = torch.zeros((b, n), dtype=acc_dtype, device=dev)
    for ci in range(num_chunks):
        js = slice(ci * cj, (ci + 1) * cj)
        # pair validity: a real j, and mask_i & mask_j with a mask
        # (the reference's order, egnn_pytorch.py:292-300)
        pv = jvalid[js][None, None, :].expand(b, n, cj)
        if mask is not None:
            pv = pv & (mask[:, :, None] & mask_j_p[:, None, js])
        args = (coors_p[:, js], proj_j_p[:, js], pv, seeds[ci])
        if torch.is_grad_enabled():
            m_sum, c_delta, cnt = checkpoint(body, *args, use_reentrant=False,
                                             preserve_rng_state=False)
        else:
            m_sum, c_delta, cnt = body(*args)
        acc_m, acc_c, acc_cnt = acc_m + m_sum, acc_c + c_delta, acc_cnt + cnt

    return PairwiseResult(m_i=acc_m, coors_delta=acc_c,
                          pair_count=acc_cnt if mask is not None else None)
