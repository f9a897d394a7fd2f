"""Ring-rotated all-pairs messages for the node-sharded dense layer, the
counterpart of ``egnn_tpu/parallel/ring.py``.

The graph analogue of ring attention: the nodes are block-sharded over a
process group; each rank keeps its resident i-block of coordinates and
projections and, over ``g`` (the group's size) steps, computes the
(i-block x visiting j-block) interactions while the j-block's payload
``(coors, proj_j, mask)`` goes one rank on around the ring
(``collectives.ring_permute``, point to point). All n^2 pairs are covered and
no rank ever holds the whole node set.

Each step's block is ``ops/pairwise_stream.py:pairwise_block``, recomputed
in the backward (``torch.utils.checkpoint``) as the one-process streamed
path's chunks are, so that a layer keeps no (b, n_local, n_local, hidden)
tensor for the backward. Dropout draws the one-process streamed layer's
masks at ``pairwise_chunk = n_local``: one seed a j-block from the caller's
generator, the same on every rank, and each block's masks as its rows of
that chunk's whole draw. There is no kernel here: the JAX package computes
this path outside any Pallas kernel too.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .collectives import check_group, ring_permute


def ring_pairwise(
    coors: torch.Tensor,        # (b, n_local, c): the resident i-block
    proj_i: torch.Tensor,       # (b, n_local, hidden): feats @ W_i + edge_b1
    proj_j: torch.Tensor,       # (b, n_local, hidden): feats @ W_j
    params,                     # ops/pairwise_stream.py:PairwiseParams
    mask: Optional[torch.Tensor] = None,   # (b, n_local) bool
    *,
    group,
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
):
    """All-pairs messages of the local i-block against every j-block.

    The same sums as ``ops/pairwise_stream.py:streamed_pairwise`` on the
    gathered node set, restricted to the local rows, in the same order of
    masking; only the order of the j-blocks differs (the ring's, from this
    rank's own block on), which changes the order of the floating-point
    sums. ``group`` takes the place of the JAX function's ``axis_name``.
    Every rank of the group calls it with blocks of one shape; each step
    but the first permutes the visiting payload once (g - 1 messages each
    way a call). Returns a ``PairwiseResult``.

    With ``dropout_rate > 0`` and a ``generator`` (on every rank in the
    same state), the masks are those of ``streamed_pairwise`` on the
    gathered nodes with ``chunk = n_local``: g seeds are read from the
    generator, the j-block of rank s takes seed s, and its masks are this
    rank's rows of the (b, n, n_local, ·) draws from that seed, in the
    forward and in the recompute. ``edge_group`` / ``coors_group``: tensor
    parallelism, as in ``pairwise_block``."""
    # imported here: ops/ imports this package's collectives while it loads
    from ..ops.pairwise_stream import PairwiseResult, pairwise_block

    check_group(group, "group")
    g = dist.get_world_size(group)
    # the cross-ring sums stay >= f32 under a bf16 compute_dtype, as
    # pairwise_block's partials do (bf16 counts stop at 256)
    acc_dtype = torch.promote_types(proj_i.dtype, torch.float32)
    b, n_local, c = coors.shape
    m_dim = params.edge_w2.shape[-1]
    dev = coors.device
    rank = dist.get_rank(group)
    dropping = dropout_rate > 0.0 and generator is not None
    seeds = torch.randint(0, 2**62, (g,), generator=generator,
                          device=generator.device).tolist() if dropping else [None] * g
    opts = dict(fourier_features=fourier_features, update_coors=update_coors,
                update_feats=update_feats, soft_edges=soft_edges, norm_coors=norm_coors,
                coor_weights_clamp_value=coor_weights_clamp_value,
                coors_norm_eps=coors_norm_eps, compute_dtype=compute_dtype,
                dropout_rate=dropout_rate if dropping else 0.0, edge_group=edge_group,
                coors_group=coors_group, rows=(rank * n_local, n_local * g))

    def block(coors_j, pj, mask_j, seed):
        pv = None if mask is None else mask[:, :, None] & mask_j[:, None, :]
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        return pairwise_block(coors, proj_i, coors_j, pj, pv, params, generator=gen, **opts)

    acc_m = torch.zeros((b, n_local, m_dim), dtype=acc_dtype, device=dev)
    acc_c = torch.zeros((b, n_local, c), dtype=coors.dtype, device=dev)
    acc_cnt = torch.zeros((b, n_local), dtype=acc_dtype, device=dev)
    # the visiting payload starts as this rank's own block
    visiting = (coors, proj_j) + ((mask,) if mask is not None else ())
    for step in range(g):
        if step > 0:
            visiting = ring_permute(visiting, group)
        # the visiting j-block is rank - step's, the chunk of that index
        args = (*(visiting if mask is not None else (*visiting, None)),
                seeds[(rank - step) % g])
        if torch.is_grad_enabled():
            m_sum, c_delta, cnt = checkpoint(block, *args, use_reentrant=False,
                                             preserve_rng_state=False)
        else:
            m_sum, c_delta, cnt = block(*args)
        acc_m, acc_c, acc_cnt = acc_m + m_sum, acc_c + c_delta, acc_cnt + cnt
    return PairwiseResult(m_i=acc_m, coors_delta=acc_c,
                          pair_count=acc_cnt if mask is not None else None)
