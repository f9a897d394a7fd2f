"""The EGNN layer and the EGNN_Network stack, in PyTorch.

Counterpart of ``egnn_tpu/models/egnn.py`` (the reference's dense path,
egnn_pytorch.py:148-454), with the same math, option names, parameter
names and (in, out) weight layout:

- The edge MLP's first layer is factorised: with input
  ``[f_i, f_j, dist_feats, edges]`` and weight rows ``[Wi; Wj; Wd; We]``,
  ``h1_ij = f_i @ Wi + f_j @ Wj + dist_ij @ Wd + e_ij @ We + b1``.
- kNN selection and the gather of the neighbours' ``[coors | mask | feats]``
  rows are one call (``ops/neighbors.py:knn_select_gather(wide=True)``):
  on the card the grid route (K7, repaired by K8 and K9) for a 3-D cloud
  without an adjacency from 8192 nodes on, else kernel K1 within the
  full-band reach and K4 or K5 beyond it; their plain versions on the CPU.
  Where the packed-key route (K5) engages, the layer runs over kc = k + 4
  candidate slots under the winner mask instead of compacting them to k;
  every other route, the grid included, returns k slots and no winner
  mask. The rest of the layer is plain torch (matmuls on cuBLAS), unless
  one of the fused flags takes it:
- ``fused_pairs=True`` feeds that gather to the fused pair pipeline (kernels
  K10f and K10b, ``ops/cuda/pair_messages.py:fused_pair_messages``): geometry,
  edge MLP, gate, coordinate-weight MLP, CoorsNorm, clamp and both
  aggregations in one kernel over the k or kc slots, with nothing of
  (b, n, k, hidden) size in device memory, forward or backward.
- ``fused_knn=True`` (tested first, as in the reference) selects only
  (K3) and lets K11f and K11b gather ``coors[idx]`` and ``proj_j[idx]``
  themselves (``fused_knn_messages``).
  Both engage only with kNN, without dense ``edges``, with ``update_feats``
  and ``update_coors``, without dropout in training mode, and inside the
  kernel's gate (``supports_fused_pair_messages`` /
  ``supports_fused_knn_layer``: k <= 64, c <= 8, widths that fit a block's
  shared memory); otherwise the layer takes the unfused pipeline silently,
  as the reference does. They ignore ``compute_dtype``: operands go to the
  kernel in float32. On the card under
  ``torch.set_float32_matmul_precision("medium")`` K10 runs its tensor-core
  mode (``pair_messages.mxu_bf16_for``), as the JAX layer runs it on the TPU;
  on an H100 that mode is slower than float32 today (K10f 1.1-1.4x, K10b
  1.6-1.9x; ``PERF.md``).
- Without kNN and without dense ``edges``, from n = 1024 on (or with
  ``stream_pairwise=True``) the all-pairs layer streams: j-chunks of
  ``ops/pairwise_stream.py``, recomputed in the backward, so that nothing
  of (b, n, n, ·) size exists (plain torch operators; the JAX package
  computes this path outside any Pallas kernel too).
- ``compute_dtype`` (e.g. ``torch.bfloat16``) casts the message path (edge,
  gate, coordinate-weight and node MLPs) on the unfused and the streamed
  paths; the geometry and the coordinate weighting stay float32.
- Dropout acts in training mode (``module.training``, the JAX package's
  ``deterministic=False``), at the reference's three sites (after the first
  layer of the edge, coordinate and node MLPs), its masks drawn from the
  ``generator`` passed to ``forward``. A module built with ``dropout > 0``
  and called without ``.eval()`` drops; ``make_denoise_train_step`` runs
  the forward in eval mode, as the JAX step applies no dropout.
- ``EGNNNetwork(global_linear_attn_every=...)`` interleaves
  ``models/attention.py:GlobalLinearAttention`` blocks (plain torch).

Reference quirks kept on purpose: ``valid_radius`` acts only with a
``mask``; with ``only_sparse_neighbors`` k is the max row degree including
the self slot (in a direct call; under a train step, as under the JAX
package's ``jax.jit``, k is the given ``num_nearest_neighbors``:
``ops/neighbors.py:static_k``); without a mask the mean divisor is k (n on
the all-pairs paths).

Model parallelism (``egnn_tpu_torch.parallel``):
- ``ring_axis=group`` (a ``torch.distributed`` process group, where the JAX
  package takes a mesh axis name) shards the nodes over the group: the
  layer takes the streamed all-pairs branch, with its j-blocks visiting
  around the ring (``parallel/ring.py:ring_pairwise``); without a mask the
  mean divisor is n_local times the group's size. kNN,
  ``only_sparse_neighbors``, dense ``edges`` and dropout in training mode
  are refused with ``ValueError``, as the JAX layer asserts: each would
  compute shard-local neighbourhoods only (the graph axis below runs them
  all).
- ``parallel/tp.py:tp_shard_module`` leaves each rank of a ``model`` group
  its shards of the MLPs' weights (``tp_group``, ``tp_sharded``); the
  layer then computes the Megatron split of each sharded MLP pair (the
  first product on the local columns, the nonlinearity, the second on the
  local rows, one sum over the group, the replicated bias) on every path.
  The fused kernels take whole weights: under a fused flag the sharded
  weights are gathered whole first (``gather_from_group``). Dropout draws
  a sharded MLP's hidden mask at the whole (padded) width and keeps the
  rank's columns, so that it is the replicated module's mask.
- ``parallel/mesh.py:shard_nodes`` (which ``make_sharded_denoise_train_step``
  calls on a mesh with ``graph > 1``) sets ``node_group`` on the network and
  its layers, the JAX step's node sharding: each rank holds a block of the
  nodes and the whole adjacency. A kNN layer gathers the ranks'
  ``[coors | mask | feats]`` rows once and selects its own rows against
  them in the selection kernels' row-block mode
  (``ops/neighbors.py:knn_select_gather_rows``; ``fused_knn``'s K11 reads
  the gathered cloud as its j table), then computes its messages and node
  update on its own rows; an all-pairs layer takes the ring over the same
  group, or with dense ``edges`` (the rank's (b, n_local, n, e) rows) the
  materialised pairs of its rows against the gathered cloud.
- Dropout on the graph axis: every rank draws the masks of the whole
  (b, n, ...) tensor from its generator, in the one-process layer's order,
  and keeps its rows (``ops/core.py:dropout``, ``sharded_part``). With
  every rank's generator in the one-process call's state the masks are
  that call's wherever both take the same route: kNN where the one-process
  layer selects k slots by K1 or K4 (with an adjacency; without one below
  8192 nodes in 3-D and up to 16 384 otherwise; beyond, it takes the grid
  or the kc-slot packed route while the sharded layer ranks k slots), dense
  edges at any n, and the ring against the streamed layer at
  ``pairwise_chunk = n_local`` (``parallel/ring.py``), not against the
  materialised pairs that the one-process layer takes below n = 1024. Each
  rank draws g times its share of random numbers.
"""
from __future__ import annotations

import inspect
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import neighbors as nb
from ..ops.core import (
    batched_index_select,
    coors_norm,
    dropout,
    fourier_encode_dist,
    gather_bool,
    layer_norm,
    safe_div,
    sharded_part,
)
from ..ops.cuda import pair_messages as pm
from ..ops.pairwise_stream import PairwiseParams, streamed_pairwise
from ..parallel.collectives import all_gather_rows, check_group
from ..parallel.ring import ring_pairwise
from ..parallel.tp import ShardedMLPs
from . import init as inits
from .attention import GlobalLinearAttention
from .init import ParamFactory


class EGNN(ShardedMLPs, nn.Module):
    """One E(n)-equivariant message-passing layer (egnn_pytorch.py:148-222).

    Keyword options keep the reference's names and defaults. ``device``
    (default ``"cuda"``), ``dtype`` and ``generator`` say where and how the
    parameters are made.
    """

    # the graph axis (parallel/mesh.py:shard_nodes sets it): the group over
    # whose ranks the nodes are block-sharded, this rank's rows the block
    # rank * n_local .. (rank + 1) * n_local - 1 (tensor parallelism's hooks
    # are parallel/tp.py:ShardedMLPs')
    node_group = None

    def __init__(
        self,
        dim: int,
        edge_dim: int = 0,
        m_dim: int = 16,
        fourier_features: int = 0,
        num_nearest_neighbors: int = 0,
        dropout: float = 0.0,
        init_eps: float = 1e-3,
        norm_feats: bool = False,
        norm_coors: bool = False,
        norm_coors_scale_init: float = 1e-2,
        update_feats: bool = True,
        update_coors: bool = True,
        only_sparse_neighbors: bool = False,
        valid_radius: float = float("inf"),
        m_pool_method: str = "sum",
        soft_edges: bool = False,
        coor_weights_clamp_value: Optional[float] = None,
        stream_pairwise: Optional[bool] = None,
        pairwise_chunk: Optional[int] = None,
        ring_axis=None,
        fused_knn: bool = False,
        fused_pairs: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        tp_hidden_multiple: Optional[int] = None,
        *,
        device=None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        param = ParamFactory(self, device, dtype, generator)
        if m_pool_method not in ("sum", "mean"):
            raise ValueError("pool method must be either sum or mean")
        if not (update_feats or update_coors):
            raise ValueError("you must update either features, coordinates, or both")
        check_group(ring_axis, "ring_axis")
        if ring_axis is not None and (num_nearest_neighbors > 0 or only_sparse_neighbors):
            raise ValueError("ring_axis takes the all-pairs layer: no kNN or "
                             "only_sparse_neighbors, which would select shard-local "
                             "neighbourhoods only")
        self.dim = dim
        self.edge_dim = edge_dim
        self.m_dim = m_dim
        self.fourier_features = fourier_features
        self.num_nearest_neighbors = num_nearest_neighbors
        self.dropout = dropout
        self.norm_feats = norm_feats
        self.norm_coors = norm_coors
        self.update_feats = update_feats
        self.update_coors = update_coors
        self.only_sparse_neighbors = only_sparse_neighbors
        self.valid_radius = valid_radius
        self.m_pool_method = m_pool_method
        self.soft_edges = soft_edges
        self.coor_weights_clamp_value = coor_weights_clamp_value
        self.stream_pairwise = stream_pairwise
        self.pairwise_chunk = pairwise_chunk
        self.ring_axis = ring_axis
        self.fused_knn = fused_knn
        self.fused_pairs = fused_pairs
        self.compute_dtype = compute_dtype

        d = dim
        self.dist_dim = 2 * fourier_features + 1
        ein = self.dist_dim + 2 * d + edge_dim
        hidden = ein * 2
        hidden_pad = -(-hidden // tp_hidden_multiple) * tp_hidden_multiple \
            if tp_hidden_multiple else hidden
        self.hidden = hidden_pad

        if hidden_pad != hidden:
            # zero-padded inert hidden units (JAX egnn.py:146-175)
            param("edge_mlp_0_w", inits.zero_pad_axis(
                inits.normal_init(init_eps), 1, hidden), (ein, hidden_pad))
            param("edge_mlp_0_b", inits.zero_pad_axis(
                inits.torch_linear_bias_init(ein), 0, hidden), (hidden_pad,))
            param("edge_mlp_1_w", inits.zero_pad_axis(
                inits.normal_init(init_eps), 0, hidden), (hidden_pad, m_dim))
            param("edge_mlp_1_b", inits.torch_linear_bias_init(hidden), (m_dim,))
        else:
            param.linear("edge_mlp_0", ein, hidden, init_eps)
            param.linear("edge_mlp_1", hidden, m_dim, init_eps)
        if soft_edges:
            param.linear("edge_gate", m_dim, 1, init_eps)
        if norm_feats:
            param("node_norm_gamma", inits.ones_init, (d,))
            param("node_norm_beta", inits.zeros_init, (d,))
        if norm_coors:
            param("coors_norm_scale", inits.constant_init(norm_coors_scale_init), (1,))
        if update_feats:
            param.linear("node_mlp_0", d + m_dim, d * 2, init_eps)
            param.linear("node_mlp_1", d * 2, d, init_eps)
        if update_coors:
            param.linear("coors_mlp_0", m_dim, m_dim * 4, init_eps)
            param.linear("coors_mlp_1", m_dim * 4, 1, init_eps)

    def _mp(self, x):
        """Mixed-precision cast of the message path (identity by default)."""
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _edge_weights(self, whole: bool = False):
        """The blocks of the edge MLP's first weight, [Wi; Wj; Wd; We], and
        its bias (this rank's columns under tensor parallelism, or whole)."""
        d = self.dim
        w1 = self._whole("edge_mlp_0_w") if whole else self.edge_mlp_0_w
        b1 = self._whole("edge_mlp_0_b") if whole else self.edge_mlp_0_b
        return (w1[:d], w1[d:2 * d], w1[2 * d:2 * d + self.dist_dim],
                w1[2 * d + self.dist_dim:], b1)

    def _node_update(self, feats, m_i, mp=None, drop=None):
        """LayerNorm? -> concat with the pooled message -> node MLP ->
        residual (egnn_pytorch.py:335-337). ``mp`` is the mixed-precision
        cast: the layer's by default, the identity on the fused paths;
        ``drop(x, mlp)`` the dropout after the first layer (none by
        default)."""
        mp = self._mp if mp is None else mp
        normed = layer_norm(feats, self.node_norm_gamma, self.node_norm_beta) \
            if self.norm_feats else feats
        h = self._col("node_mlp", torch.cat([mp(normed), m_i.to(mp(normed).dtype)], dim=-1))
        h = h @ mp(self.node_mlp_0_w) + mp(self.node_mlp_0_b)
        h = F.silu(h if drop is None else drop(h, "node_mlp"))
        return (self._row("node_mlp", h @ mp(self.node_mlp_1_w))
                + mp(self.node_mlp_1_b)).to(feats.dtype) + feats

    def _pair_weights(self, w_d, coors):
        """The fused kernels' weights after Wj; dummies stand for the gate
        without ``soft_edges`` and for the scale without ``norm_coors``."""
        if self.soft_edges:
            gate_w, gate_b = self.edge_gate_w, self.edge_gate_b
        else:
            gate_w = torch.zeros(self.m_dim, 1, dtype=coors.dtype, device=coors.device)
            gate_b = gate_w[:1, 0]
        scale = self.coors_norm_scale if self.norm_coors else torch.ones(
            1, dtype=coors.dtype, device=coors.device)
        return (w_d, self._whole("edge_mlp_1_w"), self.edge_mlp_1_b, gate_w, gate_b,
                self._whole("coors_mlp_0_w"), self._whole("coors_mlp_0_b"),
                self._whole("coors_mlp_1_w"), self.coors_mlp_1_b, scale)

    def _pool_kernel_messages(self, m_sum, pv, mask, num_nearest):
        """Mean or sum pooling of the kernels' summed messages. Without a
        mask the mean's divisor is the number of selected slots k
        (egnn_pytorch.py:330-333), which is also the winner count of a wide
        kc-slot result."""
        if self.m_pool_method != "mean":
            return m_sum
        if mask is not None:
            return safe_div(m_sum, pv.sum(dim=-1).to(m_sum.dtype)[..., None])
        return m_sum / num_nearest

    def _node_table(self, feats, coors, mask):
        """On the graph axis: the ranks' ``[coors | mask | feats]`` rows
        gathered once (their backward keeps this rank's block of the summed
        cotangents) as the whole cloud's (coors, mask, feats), and this
        rank's row block (r0, n_local) of it."""
        group, n, c = self.node_group, coors.shape[1], coors.shape[-1]
        table = all_gather_rows(nb._table(coors, mask, feats), group, dim=1)
        mask_all = None if mask is None else table[..., c] > 0.5
        return (table[..., :c], mask_all, table[..., c + (mask is not None):],
                (dist.get_rank(group) * n, n))

    def _forward_fused_knn(self, feats, coors, mask, adj_b, num_nearest, valid_radius):
        """The layer through K11: selection only, then one kernel that
        gathers its neighbours' rows itself. On the graph axis the rank's
        rows are selected against the gathered cloud (K3's row block), and
        K11 reads its j side from that cloud (its j-table form)."""
        w_i, w_j, w_d, _, b1 = self._edge_weights(whole=True)
        if self.node_group is None:
            nbhd = nb.knn_select(coors, num_nearest, valid_radius, mask=mask, adj_mat=adj_b)
            coors_j, mask_j, feats_j = None, mask, feats
        else:
            coors_j, mask_j, feats_j, rows = self._node_table(feats, coors, mask)
            nbhd, _ = nb.knn_select_gather_rows(coors_j, num_nearest, valid_radius, rows,
                                                mask=mask_j, adj_mat=adj_b)
        if mask is not None:
            pv = (mask[:, :, None] & gather_bool(mask_j, nbhd.indices)) & nbhd.valid
        else:
            # the reference's quirk: validity counts only under a mask
            pv = torch.ones_like(nbhd.indices, dtype=torch.bool)
        m_sum, coors_delta = pm.fused_knn_messages(
            coors, feats @ w_i + b1, feats_j @ w_j, nbhd.indices, pv,
            self.fourier_features, self.soft_edges, self.norm_coors,
            self.coor_weights_clamp_value, 1e-8, *self._pair_weights(w_d, coors),
            coors_j=coors_j)
        m_i = self._pool_kernel_messages(m_sum, pv, mask, num_nearest)
        return self._node_update(feats, m_i, mp=lambda v: v), coors + coors_delta

    def _forward_streamed(self, feats, coors, mask, generator, drop, ring=None):
        """The all-pairs layer as j-chunks recomputed in the backward
        (``ops/pairwise_stream.py``), or as the ring's j-blocks over the
        group ``ring`` (``ring_axis``, or the graph axis's ``node_group``;
        ``parallel/ring.py``), with the reference's mean divisor n without a
        mask (egnn_tpu/models/egnn.py:262-284): under the ring n is the
        whole node count, n_local times the group's size. ``generator`` is
        None unless dropout acts; the ring then draws the masks of the
        streamed layer at ``pairwise_chunk = n_local``."""
        mp = self._mp
        w_i, w_j, w_d, _, b1 = self._edge_weights()
        pp = PairwiseParams(
            w_d=w_d, edge_w2=self.edge_mlp_1_w, edge_b2=self.edge_mlp_1_b,
            gate_w=self.edge_gate_w if self.soft_edges else None,
            gate_b=self.edge_gate_b if self.soft_edges else None,
            coors_w1=self.coors_mlp_0_w if self.update_coors else None,
            coors_b1=self.coors_mlp_0_b if self.update_coors else None,
            coors_w2=self.coors_mlp_1_w if self.update_coors else None,
            coors_b2=self.coors_mlp_1_b if self.update_coors else None,
            cn_scale=self.coors_norm_scale if self.norm_coors else None)
        xf = mp(self._col("edge_mlp", feats))
        proj_i, proj_j = xf @ mp(w_i) + mp(b1), xf @ mp(w_j)
        opts = dict(fourier_features=self.fourier_features, update_coors=self.update_coors,
                    update_feats=self.update_feats, soft_edges=self.soft_edges,
                    norm_coors=self.norm_coors,
                    coor_weights_clamp_value=self.coor_weights_clamp_value,
                    compute_dtype=self.compute_dtype)
        opts.update(dropout_rate=self.dropout, generator=generator,
                    edge_group=self.tp_group if "edge_mlp" in self.tp_sharded else None,
                    coors_group=self.tp_group if "coors_mlp" in self.tp_sharded else None)
        n_total = feats.shape[1]
        if ring is not None:
            res = ring_pairwise(coors, proj_i, proj_j, pp, mask=mask, group=ring, **opts)
            n_total *= dist.get_world_size(ring)
        else:
            res = streamed_pairwise(coors, proj_i, proj_j, pp, mask=mask,
                                    chunk=self.pairwise_chunk, **opts)
        coors_out = coors + res.coors_delta if self.update_coors else coors
        if not self.update_feats:
            return feats, coors_out
        m_i = res.m_i
        if self.m_pool_method == "mean":
            m_i = safe_div(m_i, res.pair_count[..., None]) if mask is not None \
                else m_i / n_total
        return self._node_update(feats, m_i, drop=drop), coors_out

    def forward(
        self,
        feats: torch.Tensor,                    # (b, n, dim)
        coors: torch.Tensor,                    # (b, n, c)
        edges: Optional[torch.Tensor] = None,   # (b, n, n, edge_dim)
        mask: Optional[torch.Tensor] = None,    # (b, n) bool
        adj_mat: Optional[torch.Tensor] = None,  # (n, n) or (b, n, n) bool
        generator: Optional[torch.Generator] = None,
    ):
        """In training mode with ``dropout > 0`` the dropout masks are drawn
        from ``generator`` (on the inputs' device), which is then required;
        a fixed generator state gives bit-identical outputs. In eval mode, or
        at ``dropout=0``, no mask is drawn (the JAX package's
        ``deterministic=True``). A sharded layer (the graph axis, tensor
        parallelism) draws each mask at the whole tensor's shape and keeps
        its part: with every rank's generator in the state the one-process
        call's would hold, the masks are that call's (see the module's
        docstring for where the routes differ)."""
        b, n, d = feats.shape
        if d != self.dim:
            raise ValueError(f"feats dim {d} != configured dim {self.dim}")
        mp = self._mp
        num_nearest = self.num_nearest_neighbors
        valid_radius = self.valid_radius
        use_nearest = num_nearest > 0 or self.only_sparse_neighbors
        dropping = self.dropout > 0.0 and self.training
        if dropping and generator is None:
            raise ValueError("dropout in training mode draws its masks from generator=, a "
                             "torch.Generator on the inputs' device; call .eval() to serve")
        if self.ring_axis is not None and (edges is not None or dropping):
            raise ValueError("ring_axis takes the all-pairs streamed layer: no dense edges "
                             "and no dropout in training mode")
        # the graph axis: kNN selects this rank's rows against the gathered
        # cloud; an all-pairs layer takes the ring over the same group, or
        # with dense edges its rows against the gathered cloud
        node_group = self.node_group
        ring = self.ring_axis
        node_rows = None    # this rank's rows (r0, n_total) of the dropout masks
        if node_group is not None:
            node_rows = (dist.get_rank(node_group) * n, n * dist.get_world_size(node_group))
            if not use_nearest and edges is None:
                ring = node_group

        def drop(x, mlp):
            if not dropping:
                return x
            return dropout(x, self.dropout, generator,
                           *sharded_part(x.shape, node_rows, self._cols(mlp, x.shape[-1])))

        # ---- the streamed all-pairs path: no (n, n) intermediates ----
        do_stream = ring is not None or (
            self.stream_pairwise if self.stream_pairwise is not None else n >= 1024)
        if not use_nearest and edges is None and do_stream:
            return self._forward_streamed(feats, coors, mask,
                                          generator if dropping else None, drop, ring)
        w_i, w_j, w_d, w_e, b1 = self._edge_weights()

        # ---- pairwise geometry ----
        if use_nearest:
            if self.only_sparse_neighbors:
                if adj_mat is None:
                    raise ValueError("only_sparse_neighbors requires adj_mat")
                # the reference overrides k with the max row degree; under a
                # train step (a jitted call in the JAX package) k is static
                derived = nb.try_max_degree(adj_mat)
                if derived is not None:
                    num_nearest = derived
                elif num_nearest == 0:
                    raise ValueError("only_sparse_neighbors under a train step needs a static "
                                     "k: pass num_nearest_neighbors explicitly")
                valid_radius = 0.0
            adj_b = None
            if adj_mat is not None:
                n_adj = adj_mat.shape[-1]   # all the nodes: n_local times the graph axis
                adj_b = adj_mat if adj_mat.dim() == 3 else adj_mat.expand(b, n_adj, n_adj)
            # the fused paths take the whole layer: kNN, no dense edges, both
            # updates, no dropout in training mode
            fusable = edges is None and self.update_coors and self.update_feats and not dropping
            if (self.fused_knn and fusable and pm.supports_fused_knn_layer(
                    num_nearest, self.hidden, self.m_dim, coors.shape[-1],
                    self.fourier_features, self.soft_edges)):
                return self._forward_fused_knn(feats, coors, mask, adj_b, num_nearest,
                                               valid_radius)
            if node_group is not None:
                # this rank's rows against the gathered cloud (K1's row
                # block); the gathered rows' backward sums into the whole
                # table (K2), then the all-gather's keeps this rank's block
                coors_all, mask_all, feats_all, rows = self._node_table(feats, coors, mask)
                nbhd, g = nb.knn_select_gather_rows(
                    coors_all, num_nearest, valid_radius, rows, mask=mask_all, adj_mat=adj_b,
                    payload=feats_all)
            else:
                nbhd, g = nb.knn_select_gather(
                    coors, num_nearest, valid_radius, mask=mask, adj_mat=adj_b,
                    payload=feats, wide=True)
            c_sp = coors.shape[-1]
            coors_j = g[..., :c_sp]
            off = c_sp
            if mask is not None:
                mask_j = g[..., off] > 0.5
                off += 1
            feats_j = g[..., off:].to(feats.dtype)             # (b, n, k or kc, d)
            if (self.fused_pairs and fusable and pm.supports_fused_pair_messages(
                    g.shape[2], self.hidden, self.m_dim, d, c_sp, self.fourier_features,
                    self.soft_edges)):
                # pair validity in the reference's order; a wide result's
                # ``valid`` already lies inside its winner mask
                if mask is not None:
                    pvm = (mask[:, :, None] & mask_j) & nbhd.valid
                elif nbhd.winner is not None:
                    pvm = nbhd.winner
                else:
                    pvm = torch.ones(g.shape[:3], dtype=torch.bool, device=g.device)
                kk = g.shape[2]
                fw_i, fw_j, fw_d, _, fb1 = self._edge_weights(whole=True)
                m_sum, coors_delta = pm.fused_pair_messages(
                    coors, coors_j.reshape(b, n * kk, c_sp), feats_j.reshape(b, n * kk, d),
                    feats @ fw_i + fb1,
                    pvm.reshape(b, n * kk, 1).to(coors.dtype),
                    self.fourier_features, self.soft_edges, self.norm_coors,
                    self.coor_weights_clamp_value, 1e-8, pm.mxu_bf16_for(coors.device), False,
                    fw_j, *self._pair_weights(fw_d, coors))
                m_i = self._pool_kernel_messages(m_sum, pvm, mask, num_nearest)
                return (self._node_update(feats, m_i.to(feats.dtype), mp=lambda v: v),
                        coors + coors_delta.to(coors.dtype))
            rel_coors = coors[:, :, None, :] - coors_j
            rel_dist = (rel_coors**2).sum(dim=-1)
            if edges is not None:
                edges = batched_index_select(edges, nbhd.indices, axis=2)
        elif node_group is not None:
            # dense edges on the graph axis: this rank's rows against the
            # gathered cloud, (b, n_local, n_total, ·); the all-gather's
            # backward keeps this rank's block of the summed cotangents
            coors_all, mask_all, feats_all, _ = self._node_table(feats, coors, mask)
            feats_all = feats_all.to(feats.dtype)
            rel_coors, rel_dist = nb.pairwise_geometry(coors, coors_all)
        else:
            rel_coors, rel_dist = nb.pairwise_geometry(coors)   # (b,n,n,c), (b,n,n)

        # ---- distance features ----
        if self.fourier_features > 0:
            dist_feats = fourier_encode_dist(rel_dist, num_encodings=self.fourier_features)
        else:
            dist_feats = rel_dist[..., None]

        # ---- factorised edge MLP layer 1 ----
        xf = mp(self._col("edge_mlp", feats))
        dist_term = mp(self._col("edge_mlp", dist_feats)) @ mp(w_d)
        if use_nearest:
            kk = feats_j.shape[2]
            proj_j = mp(self._col("edge_mlp", feats_j)) @ mp(w_j)
            proj_i = xf[:, :, None, :].expand(b, n, kk, d) @ mp(w_i)
            h1 = proj_i + proj_j + dist_term + mp(b1)
        else:
            xf_j = xf if node_group is None else mp(self._col("edge_mlp", feats_all))
            proj_i = xf @ mp(w_i)                               # (b, n, hidden)
            proj_j = (xf_j @ mp(w_j))[:, None, :, :]            # (b, 1, n, hidden)
            h1 = proj_i[:, :, None, :] + proj_j + dist_term + mp(b1)
        if edges is not None:
            h1 = h1 + mp(self._col("edge_mlp", edges)) @ mp(w_e)

        m_ij = F.silu(drop(h1, "edge_mlp"))
        m_ij = F.silu(self._row("edge_mlp", m_ij @ mp(self.edge_mlp_1_w))
                      + mp(self.edge_mlp_1_b))
        if self.soft_edges:
            m_ij = m_ij * torch.sigmoid(m_ij @ mp(self.edge_gate_w) + mp(self.edge_gate_b))

        # ---- pair mask (reference order: mask_i * mask_j [& nbhd]) ----
        pair_mask = None
        if mask is not None:
            if use_nearest:
                pair_mask = (mask[:, :, None] & mask_j) & nbhd.valid
            else:
                pair_mask = mask[:, :, None] & (
                    mask if node_group is None else mask_all)[:, None, :]
        elif use_nearest and nbhd.winner is not None:
            # a wide kc-slot result without a node mask: the reference sums
            # its k selected slots whatever their radius, so exactly the
            # winner slots take part (mean pool: their count is k)
            pair_mask = nbhd.winner

        # ---- coordinate update (equivariant) ----
        if self.update_coors:
            cw = F.silu(drop(self._col("coors_mlp", m_ij) @ mp(self.coors_mlp_0_w)
                             + mp(self.coors_mlp_0_b), "coors_mlp"))
            coor_weights = (self._row("coors_mlp", cw @ mp(self.coors_mlp_1_w))
                            + mp(self.coors_mlp_1_b)).to(coors.dtype)
            rel_coors_n = coors_norm(rel_coors, self.coors_norm_scale) \
                if self.norm_coors else rel_coors
            if pair_mask is not None:
                coor_weights = torch.where(pair_mask[..., None], coor_weights, 0.0)
            if self.coor_weights_clamp_value is not None:
                clamp = self.coor_weights_clamp_value
                coor_weights = coor_weights.clamp(-clamp, clamp)
            coors_out = (coor_weights * rel_coors_n).sum(dim=-2) + coors
        else:
            coors_out = coors

        # ---- feature update (invariant) ----
        if self.update_feats:
            if pair_mask is not None:
                m_ij = torch.where(pair_mask[..., None], m_ij, 0.0)
            if self.m_pool_method == "mean":
                if pair_mask is not None:
                    mask_sum = pair_mask[..., None].sum(dim=-2).to(m_ij.dtype)
                    m_i = safe_div(m_ij.sum(dim=-2), mask_sum)
                else:
                    m_i = m_ij.mean(dim=-2)
            else:
                m_i = m_ij.sum(dim=-2)
            node_out = self._node_update(feats, m_i, drop=drop)
        else:
            node_out = feats
        return node_out, coors_out


class EGNNNetwork(nn.Module):
    """Depth-N EGNN stack with token, position, edge and adjacency-degree
    embeddings and interleaved global linear attention (egnn_pytorch.py:
    343-454). ``layer_kwargs`` go to every ``EGNN``; ``norm_feats=True`` is
    forced, as in the reference. Layers are the submodules ``egnn_0`` ...
    ``egnn_{depth-1}``; with ``global_linear_attn_every`` > 0 a
    ``GlobalLinearAttention`` ``global_attn_{i}`` runs before every layer i
    with i % global_linear_attn_every == 0, over the tokens
    ``global_tokens``."""

    # Parameters that the reference creates on first use, only when their
    # branch runs (``edge_emb`` when edges reach the call, ``global_tokens``
    # when the network is called), so that its tree may lack them. The port
    # makes them at construction, so that an optimiser built before the
    # first call holds them; ``load_flax_params`` leaves them as they are
    # where the reference's tree has none.
    lazy_parameters = ("edge_emb", "global_tokens")
    # the graph axis (parallel/mesh.py:shard_nodes sets it, and its layers'):
    # the inputs are this rank's block of nodes, the adjacency whole
    node_group = None

    def __init__(
        self,
        depth: int,
        dim: int,
        num_tokens: Optional[int] = None,
        num_edge_tokens: Optional[int] = None,
        num_positions: Optional[int] = None,
        edge_dim: int = 0,
        num_adj_degrees: Optional[int] = None,
        adj_dim: int = 0,
        global_linear_attn_every: int = 0,
        global_linear_attn_heads: int = 8,
        global_linear_attn_dim_head: int = 64,
        num_global_tokens: int = 4,
        layer_kwargs: Optional[dict[str, Any]] = None,
        *,
        device=None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        param = ParamFactory(self, device, dtype, generator)
        if num_adj_degrees is not None and num_adj_degrees < 1:
            raise ValueError("make sure adjacent degrees is greater than 1")
        self.depth = depth
        self.dim = dim
        self.num_tokens = num_tokens
        self.num_edge_tokens = num_edge_tokens
        self.num_positions = num_positions
        self.num_adj_degrees = num_adj_degrees
        self.global_linear_attn_every = global_linear_attn_every

        if num_tokens is not None:
            param("token_emb", inits.unit_normal_init, (num_tokens, dim))
        if num_positions is not None:
            param("pos_emb", inits.unit_normal_init, (num_positions, dim))
        if num_edge_tokens is not None:
            param("edge_emb", inits.unit_normal_init, (num_edge_tokens, edge_dim))
        adj_dim = adj_dim if num_adj_degrees is not None else 0
        if adj_dim > 0:
            param("adj_emb", inits.unit_normal_init, (num_adj_degrees + 1, adj_dim))
        self.adj_dim = adj_dim
        if global_linear_attn_every > 0:
            param("global_tokens", inits.unit_normal_init, (num_global_tokens, dim))
        layer_edge_dim = (edge_dim if edge_dim > 0 else 0) + adj_dim
        for ind in range(depth):
            if self._is_global_layer(ind):
                self.add_module(f"global_attn_{ind}", GlobalLinearAttention(
                    dim, global_linear_attn_heads, global_linear_attn_dim_head,
                    device=param.device, dtype=dtype, generator=param.gen))
            self.add_module(f"egnn_{ind}", EGNN(
                dim=dim, edge_dim=layer_edge_dim, norm_feats=True,
                **(layer_kwargs or {}), device=param.device, dtype=dtype,
                generator=param.gen))

    def _is_global_layer(self, ind: int) -> bool:
        every = self.global_linear_attn_every
        return every > 0 and ind % every == 0

    def forward(
        self,
        feats: torch.Tensor,
        coors: torch.Tensor,
        adj_mat: Optional[torch.Tensor] = None,
        edges: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        return_coor_changes: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """``generator``: the dropout masks' source in training mode (see
        ``EGNN.forward``).

        On the graph axis (``node_group``, set by ``parallel.shard_nodes``)
        ``feats``, ``coors`` and ``mask`` are this rank's block of n_local
        nodes, rows r0 = rank * n_local on; ``adj_mat`` is whole (the JAX
        step replicates it) and dense ``edges`` are the block's rows, (b,
        n_local, n, e). The positions are the block's global ones, and the
        adjacency degrees are expanded on the whole adjacency."""
        b, n = feats.shape[:2]
        r0, n_total = 0, n
        if self.node_group is not None:
            r0 = dist.get_rank(self.node_group) * n
            n_total = n * dist.get_world_size(self.node_group)
        if self.num_tokens is not None:
            feats = self.token_emb[feats]
        if self.num_positions is not None:
            if n_total > self.num_positions:
                raise ValueError(
                    f"given sequence length {n_total} must be less than the number "
                    f"of positions {self.num_positions} set at init")
            feats = feats + self.pos_emb[None, r0:r0 + n, :]
        if edges is not None and self.num_edge_tokens is not None:
            edges = self.edge_emb[edges]

        # Nth-degree adjacency expansion with per-degree embedding
        # (egnn_pytorch.py:414-432); the layers see the expanded adjacency.
        if self.num_adj_degrees is not None:
            if adj_mat is None:
                raise ValueError(
                    "adjacency matrix must be passed in (keyword argument adj_mat)")
            if adj_mat.dim() == 2:
                adj_mat = adj_mat.expand(b, *adj_mat.shape)
            adj_mat, adj_indices = nb.expand_adjacency_degrees(adj_mat, self.num_adj_degrees)
            if self.adj_dim > 0:
                adj_feats = self.adj_emb[adj_indices[:, r0:r0 + n]]
                edges = torch.cat([edges, adj_feats], dim=-1) if edges is not None \
                    else adj_feats

        if self.global_linear_attn_every > 0:
            global_tokens = self.global_tokens.expand(b, *self.global_tokens.shape)
        coor_changes = [coors]
        for ind in range(self.depth):
            if self._is_global_layer(ind):
                feats, global_tokens = getattr(self, f"global_attn_{ind}")(
                    feats, global_tokens, mask=mask)
            feats, coors = getattr(self, f"egnn_{ind}")(
                feats, coors, edges=edges, mask=mask, adj_mat=adj_mat, generator=generator)
            coor_changes.append(coors)
        if return_coor_changes:
            return feats, coors, coor_changes
        return feats, coors


def EGNN_Network(**kwargs) -> EGNNNetwork:
    """Reference-style constructor: keyword arguments that ``EGNNNetwork``
    does not take go to every layer, as the reference's ``**kwargs``
    passthrough does (egnn_pytorch.py:344,387)."""
    fields = set(inspect.signature(EGNNNetwork.__init__).parameters) - {"self"}
    layer_kwargs = dict(kwargs.pop("layer_kwargs", None) or {})
    extra = {k: kwargs.pop(k) for k in list(kwargs) if k not in fields}
    return EGNNNetwork(**kwargs, layer_kwargs={**extra, **layer_kwargs})
