"""The sparse (COO) E(n)-equivariant layer and network, in PyTorch.

Counterpart of ``egnn_tpu/models/egnn_sparse.py`` (the reference's PyG path,
egnn_pytorch_geometric.py:99-439) with the same math, option names,
parameter names and (in, out) weight layout. Messages are computed per edge
of a static-capacity COO list (``edge_index`` (2, E), ``edge_mask`` for
padding) and aggregated by the segment reductions of ``ops/segment.py``.

The layout contract is PyG's: ``x`` is (N, pos_dim + feats_dim), coordinates
first; messages flow j = edge_index[0] -> i = edge_index[1] with
``rel_coors = coors[j] - coors[i]``; the edge MLP reads ``[x_i, x_j,
edge_attr, dist_feats]``; the soft-edge gate acts on the feature aggregation
only; the node norm is PyG's graph-mode LayerNorm; weights are xavier-normal
and biases zero. ``coor_weights_clamp_value`` is honoured and the global
attention interleave works (the JAX package's fix-forwards of the
reference).

On the card:

- every row gather (``ops/core.py:gather_rows``, the embeddings, the
  per-graph statistics) is an indexed load whose backward is the segment sum
  K2, and so is every floating-point segment sum of the general path;
- ``uniform_degree`` (a receiver-major layout of k edges a node, what
  ``ops/graph.py:knn_graph`` emits) turns the receiver side into broadcasts
  and the aggregations into reshape-reduces;
- ``uniform_graph_size`` (equal graphs of s nodes, rows [g*s, (g+1)*s))
  makes the graph LayerNorm a reshape. The sender gather stays
  ``gather_rows``: the TPU's block-local one-hot gather buys nothing on the
  card, and padding rows are masked before anything reads them. The layout
  is checked on the inputs, in one host read, once for each edge set (the
  network checks at entry and after each ``recalc_edge``, a bare layer on
  every call) and not while a CUDA graph is being captured, as the JAX
  package checks concrete inputs and lets traced ones pass;
- ``fused_uniform=True`` with ``uniform_degree`` runs the per-edge pipeline
  through kernels K10f and K10b (``ops/cuda/pair_messages.py``, with the
  sparse gate semantics ``gate_feats_only``) where their gate takes the
  widths, without ``edge_attr``, with both updates and aggr add, sum or
  mean; otherwise the layer takes the per-edge path silently, as the JAX
  package does. The kernel computes in float32 and ignores
  ``compute_dtype``; on the card under
  ``torch.set_float32_matmul_precision("medium")`` it runs its tensor-core
  mode (``pair_messages.mxu_bf16_for``), as the JAX layer does on the TPU,
  slower than float32 on an H100 today (K10f 1.1-1.4x, K10b 1.6-1.9x;
  ``PERF.md``).
  ``None`` and ``False`` take the per-edge path.

Dropout acts in training mode (``module.training``, the JAX package's
``deterministic=False``), its masks drawn from the ``generator`` passed to
``forward``.

``shard_axis`` (the network's and the layer's; ``axis_name`` of the
attention block) is the edge-partitioned multi-process layout of
``parallel/sparse_partition.py``: a process group, where the JAX package
takes a mesh axis name. Each rank holds a block of the nodes and the edges
whose receivers it owns, receivers local and senders global. A layer
gathers the node rows of every rank once (``all_gather_rows``) and reads
the senders there, through ``gather_rows`` (its backward K2 on the gathered
rows); the graph LayerNorm's and the attention's statistics are summed over
the group. ``uniform_graph_size`` is ignored under it, as in the JAX
package; ``uniform_degree`` and ``fused_uniform`` work on the rank's own
nodes (K10 at the local n).

``parallel/tp.py:tp_shard_module`` shards the layer's three MLP pairs over
a ``model`` group, as the dense layer's (``ShardedMLPs``): each rank holds
the first weight's columns and the second's rows, computes the per-edge
products on them and sums the second product over the group; under
``fused_uniform`` K10 takes the weights gathered whole and the node MLP
stays split. Dropout in training mode draws a sharded MLP's hidden mask at
the whole width and keeps the rank's columns: the replicated layer's mask.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.core import (
    coors_norm,
    dropout,
    embed_tokens,
    fourier_encode_dist,
    gather_rows,
    layer_norm,
    sharded_part,
)
from ..ops.cuda import pair_messages as pm
from ..ops.segment import (
    graph_layer_norm,
    segment_aggregate,
    segment_softmax,
    segment_sum,
    uniform_aggregate,
)
from ..parallel.collectives import all_gather_rows, all_reduce_sum, check_group
from ..parallel.tp import ShardedMLPs
from . import init as inits
from .attention import Attention, GlobalLinearAttention
from .init import ParamFactory


def _check_uniform_layout(edge_index, edge_mask, batch, n, k, s) -> None:
    """The positional contract of ``uniform_graph_size`` (and, with
    ``uniform_degree``, of the receiver-major layout) on the live rows; one
    read on the host, skipped while a CUDA graph is captured."""
    if edge_index.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    dev = edge_index.device
    ok = [torch.ones((), dtype=torch.bool, device=dev)] * 3
    if batch is not None:
        ok[0] = (batch == torch.arange(n, device=dev) // s).all()
    if k is not None:
        e = edge_index.shape[1]
        dead = torch.zeros(e, dtype=torch.bool, device=dev) if edge_mask is None \
            else ~edge_mask.bool()
        ok[1] = ((edge_index[1] == torch.arange(e, device=dev) // k) | dead).all()
        ok[2] = ((edge_index[0] // s == edge_index[1] // s) | dead).all()
    ok = torch.stack(ok).tolist()
    if not ok[0]:
        raise ValueError("uniform_graph_size requires a contiguous equal-size batch layout: "
                         "batch[i] == i // uniform_graph_size")
    if not ok[1]:
        raise ValueError("uniform_degree + uniform_graph_size requires the positional "
                         "receiver-major layout (row e has receiver e // k): use the kNN builders")
    if not ok[2]:
        raise ValueError("uniform_graph_size requires block-local edges (sender and receiver "
                         "in the same graph block)")


class EGNNSparse(ShardedMLPs, nn.Module):
    """One COO-edge E(n)-equivariant message-passing layer
    (egnn_pytorch_geometric.py:99-271). Keyword options keep the JAX
    package's names and defaults; ``device`` (default ``"cuda"``), ``dtype``
    and ``generator`` say where and how the parameters are made."""

    def __init__(
        self,
        feats_dim: int,
        pos_dim: int = 3,
        edge_attr_dim: int = 0,
        m_dim: int = 16,
        fourier_features: int = 0,
        soft_edge: int = 0,
        norm_feats: bool = False,
        norm_coors: bool = False,
        norm_coors_scale_init: float = 1e-2,
        update_feats: bool = True,
        update_coors: bool = True,
        dropout: float = 0.0,
        coor_weights_clamp_value: Optional[float] = None,
        aggr: str = "add",
        compute_dtype: Optional[torch.dtype] = None,
        uniform_degree: Optional[int] = None,
        fused_uniform: Optional[bool] = None,
        uniform_graph_size: Optional[int] = None,
        shard_axis=None,
        *,
        device=None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        check_group(shard_axis, "shard_axis")
        if aggr not in ("add", "sum", "max", "mean"):
            raise ValueError("pool method must be a valid option")
        if not (update_feats or update_coors):
            raise ValueError("you must update either features, coordinates, or both")
        param = ParamFactory(self, device, dtype, generator)
        self.feats_dim = feats_dim
        self.pos_dim = pos_dim
        self.edge_attr_dim = edge_attr_dim
        self.m_dim = m_dim
        self.fourier_features = fourier_features
        self.soft_edge = soft_edge
        self.norm_feats = norm_feats
        self.norm_coors = norm_coors
        self.update_feats = update_feats
        self.update_coors = update_coors
        self.dropout = dropout
        self.coor_weights_clamp_value = coor_weights_clamp_value
        self.aggr = aggr
        self.compute_dtype = compute_dtype
        self.uniform_degree = uniform_degree
        self.fused_uniform = fused_uniform
        self.uniform_graph_size = uniform_graph_size
        self.shard_axis = shard_axis

        d = feats_dim
        self.dist_dim = 2 * fourier_features + 1
        ein = self.dist_dim + edge_attr_dim + 2 * d
        self.hidden = hidden = 2 * ein

        def linear(name, d_in, d_out):
            param(f"{name}_w", inits.xavier_normal_init, (d_in, d_out))
            param(f"{name}_b", inits.zeros_init, (d_out,))

        linear("edge_mlp_0", ein, hidden)
        linear("edge_mlp_1", hidden, m_dim)
        if soft_edge:
            linear("edge_weight", m_dim, 1)
        if norm_feats:
            param("node_norm_gamma", inits.ones_init, (d,))
            param("node_norm_beta", inits.zeros_init, (d,))
        if norm_coors:
            param("coors_norm_scale", inits.constant_init(norm_coors_scale_init), (1,))
        if update_feats:
            linear("node_mlp_0", d + m_dim, d * 2)
            linear("node_mlp_1", d * 2, d)
        if update_coors:
            linear("coors_mlp_0", m_dim, m_dim * 4)
            linear("coors_mlp_1", m_dim * 4, 1)

    def _mp(self, x):
        """Mixed-precision cast of the message path (identity by default)."""
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _uses_fused(self) -> bool:
        return (bool(self.fused_uniform) and self.uniform_degree is not None
                and self.edge_attr_dim == 0 and self.update_coors and self.update_feats
                and self.aggr in ("add", "sum", "mean")
                and pm.supports_fused_pair_messages(
                    self.uniform_degree, self.hidden, self.m_dim, self.feats_dim, self.pos_dim,
                    self.fourier_features, bool(self.soft_edge)))

    def forward(
        self,
        x: torch.Tensor,                              # (N, pos_dim + feats_dim)
        edge_index: torch.Tensor,                     # (2, E) [senders j; receivers i]
        edge_attr: Optional[torch.Tensor] = None,     # (E, edge_attr_dim)
        batch: Optional[torch.Tensor] = None,         # (N,) graph ids
        edge_mask: Optional[torch.Tensor] = None,     # (E,) bool, False on padding
        num_graphs: int = 1,
        node_mask: Optional[torch.Tensor] = None,     # (N,) bool, False on padding
        check_layout: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``check_layout=False`` skips the ``uniform_graph_size`` layout check
        for an edge set that the caller has checked already. In training mode
        with ``dropout > 0`` the masks are drawn from ``generator`` (on the
        inputs' device), which is then required; ``fused_uniform`` gives way
        to the per-edge path meanwhile."""
        dropping = self.dropout > 0.0 and self.training
        if dropping and generator is None:
            raise ValueError("dropout in training mode draws its masks from generator=, a "
                             "torch.Generator on the inputs' device; call .eval() to serve")

        def drop(v, mlp):
            # under tensor parallelism v holds this rank's columns of the
            # hidden: the whole width's mask is drawn and the columns kept
            if not dropping:
                return v
            return dropout(v, self.dropout, generator,
                           *sharded_part(v.shape, cols=self._cols(mlp, v.shape[-1])))

        n, d, pos = x.shape[0], self.feats_dim, self.pos_dim
        # under shard_axis: n is this rank's node count, senders index x_full
        x_full = x if self.shard_axis is None else all_gather_rows(x, self.shard_axis)
        uk = self.uniform_degree
        ugs = self.uniform_graph_size if self.shard_axis is None else None
        if uk is not None and edge_index.shape[1] != n * uk:
            raise ValueError(f"uniform_degree={uk} needs exactly n*k={n * uk} edge rows, got "
                             f"{edge_index.shape[1]}")
        if ugs is not None:
            if n % ugs:
                raise ValueError(f"uniform_graph_size={ugs} must divide the node count {n}")
            if check_layout:
                _check_uniform_layout(edge_index, edge_mask, batch, n, uk, ugs)

        coors, feats = x[:, :pos], x[:, pos:]
        j_idx, i_idx = edge_index[0], edge_index[1]
        fused = self._uses_fused() and not dropping
        # this rank's columns under tensor parallelism; K10 takes them whole
        w1 = self._whole("edge_mlp_0_w") if fused else self.edge_mlp_0_w
        w_i, w_j = w1[:d], w1[d:2 * d]
        w_e = w1[2 * d:2 * d + self.edge_attr_dim]
        w_d = w1[2 * d + self.edge_attr_dim:]

        if fused:
            return self._forward_fused(x, x_full, coors, feats, j_idx, batch, edge_mask,
                                       num_graphs, node_mask, w_i, w_j, w_d)

        # one row gather an edge end carrying [coors | feats]; a uniform
        # layout broadcasts the receiver's rows instead
        if uk is not None:
            coors_i_e = coors[:, None, :].expand(n, uk, pos).reshape(n * uk, pos)
            feats_i_e = feats[:, None, :].expand(n, uk, d).reshape(n * uk, d)
        else:
            xg_i = gather_rows(x, i_idx)
            coors_i_e, feats_i_e = xg_i[:, :pos], xg_i[:, pos:]
        xg_j = gather_rows(x_full, j_idx)
        coors_j_e, feats_j_e = xg_j[:, :pos], xg_j[:, pos:]
        rel_coors = coors_j_e - coors_i_e
        rel_dist = (rel_coors ** 2).sum(dim=-1, keepdim=True)
        dist_feats = fourier_encode_dist(rel_dist[..., 0], num_encodings=self.fourier_features) \
            if self.fourier_features > 0 else rel_dist

        mp = self._mp

        def col(v):   # an input of the edge MLP's first (column-parallel) product
            return mp(self._col("edge_mlp", v))

        h1 = col(feats_i_e) @ mp(w_i) + col(feats_j_e) @ mp(w_j) \
            + col(dist_feats) @ mp(w_d) + mp(self.edge_mlp_0_b)
        if self.edge_attr_dim > 0:
            if edge_attr is None:
                raise ValueError(f"layer built with edge_attr_dim={self.edge_attr_dim} but no "
                                 f"edge_attr given")
            h1 = h1 + col(edge_attr) @ mp(w_e)
        m_ij = F.silu(drop(h1, "edge_mlp"))
        m_ij = F.silu(self._row("edge_mlp", m_ij @ mp(self.edge_mlp_1_w))
                      + mp(self.edge_mlp_1_b))                                  # (E, m_dim)

        def aggregate(data):
            if uk is not None:
                return uniform_aggregate(self.aggr, data, uk, mask=edge_mask)
            return segment_aggregate(self.aggr, data, i_idx, n, mask=edge_mask)

        if self.update_coors:
            cw = F.silu(drop(self._col("coors_mlp", m_ij) @ mp(self.coors_mlp_0_w)
                             + mp(self.coors_mlp_0_b), "coors_mlp"))
            # back to full precision before weighting the geometry
            coor_wij = (self._row("coors_mlp", cw @ mp(self.coors_mlp_1_w))
                        + mp(self.coors_mlp_1_b)).to(coors.dtype)
            if self.coor_weights_clamp_value is not None:
                clamp = self.coor_weights_clamp_value
                coor_wij = coor_wij.clamp(-clamp, clamp)
            rel_out = coors_norm(rel_coors, self.coors_norm_scale) if self.norm_coors \
                else rel_coors
            coors_out = coors + aggregate(coor_wij * rel_out)
        else:
            coors_out = coors

        if self.update_feats:
            if self.soft_edge:
                m_ij = m_ij * torch.sigmoid(m_ij @ mp(self.edge_weight_w) + mp(self.edge_weight_b))
            m_i = aggregate(m_ij.to(feats.dtype))
            hidden_out = self._feature_update(feats, m_i, batch, num_graphs, node_mask, drop)
        else:
            hidden_out = feats
        return torch.cat([coors_out, hidden_out], dim=-1)

    def _forward_fused(self, x, x_full, coors, feats, j_idx, batch, edge_mask, num_graphs,
                       node_mask, w_i, w_j, w_d):
        """The uniform layout is the dense path's i-major pair layout (row e
        belongs to receiver e // k): the gathered sender rows go to K10 with
        the sparse gate semantics; the row gather and its backward (K2) stay
        outside the kernel."""
        n, uk, pos = x.shape[0], self.uniform_degree, self.pos_dim
        xg_j = gather_rows(x_full, j_idx)
        proj_i = (feats @ w_i + self._whole("edge_mlp_0_b"))[None]   # (1, N, hidden)
        pv = edge_mask.to(coors.dtype)[None, :, None] if edge_mask is not None \
            else torch.ones((1, n * uk, 1), dtype=coors.dtype, device=coors.device)
        if self.soft_edge:
            gate_w, gate_b = self.edge_weight_w, self.edge_weight_b
        else:
            gate_w = torch.zeros((self.m_dim, 1), dtype=coors.dtype, device=coors.device)
            gate_b = gate_w[:1, 0]
        scale = self.coors_norm_scale if self.norm_coors else \
            torch.ones((1,), dtype=coors.dtype, device=coors.device)
        m_sum, cd = pm.fused_pair_messages(
            coors[None], xg_j[None, :, :pos], xg_j[None, :, pos:], proj_i, pv,
            self.fourier_features, bool(self.soft_edge), self.norm_coors,
            self.coor_weights_clamp_value, 1e-8, pm.mxu_bf16_for(coors.device), True,
            w_j, w_d, self._whole("edge_mlp_1_w"), self.edge_mlp_1_b, gate_w, gate_b,
            self._whole("coors_mlp_0_w"), self._whole("coors_mlp_0_b"),
            self._whole("coors_mlp_1_w"), self.coors_mlp_1_b, scale)
        m_i, cd = m_sum[0], cd[0]
        if self.aggr == "mean":
            cnt = pv[0].reshape(n, uk).sum(dim=1, keepdim=True).clamp(min=1.0) \
                if edge_mask is not None else float(uk)
            m_i, cd = m_i / cnt, cd / cnt
        # the sparse sign convention: rel = c_j - c_i, the kernel's with a minus
        coors_out = coors - cd.to(coors.dtype)
        return torch.cat([coors_out, self._feature_update(
            feats, m_i.to(feats.dtype), batch, num_graphs, node_mask)], dim=-1)

    def _feature_update(self, feats, m_i, batch, num_graphs, node_mask, drop=lambda v, mlp: v):
        """Graph LayerNorm (padding left out of its statistics), then the node
        MLP residual (egnn_pytorch_geometric.py:259-266), ``drop`` after its
        first layer."""
        hidden = graph_layer_norm(feats, batch, num_graphs, self.node_norm_gamma,
                                  self.node_norm_beta, node_mask=node_mask,
                                  axis_name=self.shard_axis,
                                  uniform_size=self.uniform_graph_size) \
            if self.norm_feats else feats
        h = F.silu(drop(self._col("node_mlp", torch.cat([hidden, m_i], dim=-1))
                        @ self.node_mlp_0_w + self.node_mlp_0_b, "node_mlp"))
        return feats + (self._row("node_mlp", h @ self.node_mlp_1_w) + self.node_mlp_1_b)


class AttentionSparse(Attention):
    """Multi-head cross attention between per-graph global tokens and packed
    node sets (egnn_pytorch_geometric.py:32-57), by segment softmax instead
    of the reference's per-graph loop; the dense ``Attention``'s
    parameters."""

    def queries_to_nodes(self, queries, x, batch, num_graphs, node_mask=None, axis_name=None):
        """Tokens (G, g, dim) attend over their graph's nodes (N, dim) ->
        (G, g, dim). ``axis_name``: a process group over whose ranks the
        node rows are block-sharded; the softmax's statistics and the induced
        tokens are then summed over it (the queries are replicated)."""
        h, dh = self.heads, self.dim_head
        G, g, _ = queries.shape
        n = x.shape[0]
        q = (queries @ self.to_q_w).reshape(G, g, h, dh)
        k, v = (x @ self.to_kv_w).chunk(2, dim=-1)
        k, v = k.reshape(n, h, dh), v.reshape(n, h, dh)
        logits = torch.einsum("nghd,nhd->ngh", gather_rows(q, batch), k) * dh ** -0.5
        flat = logits.reshape(n, g * h)
        m = None if node_mask is None else node_mask[:, None].expand(n, g * h)
        attn = segment_softmax(flat, batch, num_graphs, mask=m, axis_name=axis_name)
        ctx = torch.einsum("ngh,nhd->nghd", attn.reshape(n, g, h), v).reshape(n, g * h * dh)
        induced = segment_sum(ctx, batch, num_graphs)
        if axis_name is not None:
            induced = all_reduce_sum(induced, axis_name)
        return induced.reshape(G, g, h * dh) @ self.to_out_w + self.to_out_b

    def nodes_to_queries(self, x, context, batch):
        """Nodes (N, dim) attend over their graph's tokens (G, g, dim) ->
        (N, dim)."""
        h, dh = self.heads, self.dim_head
        G, g, _ = context.shape
        n = x.shape[0]
        q = (x @ self.to_q_w).reshape(n, h, dh)
        k, v = (context @ self.to_kv_w).chunk(2, dim=-1)
        k = gather_rows(k.reshape(G, g, h, dh), batch)
        v = gather_rows(v.reshape(G, g, h, dh), batch)
        attn = torch.softmax(torch.einsum("nhd,nghd->ngh", q, k) * dh ** -0.5, dim=1)
        out = torch.einsum("ngh,nghd->nhd", attn, v).reshape(n, h * dh)
        return out @ self.to_out_w + self.to_out_b


class GlobalLinearAttentionSparse(GlobalLinearAttention):
    """Per-graph induced-token attention block for packed node sets
    (egnn_pytorch_geometric.py:60-94): the dense block's parameters, graph
    LayerNorms on the node stream, the sparse variant's feed-forward residual
    ``ff(x_norm) + x_norm``."""

    attention = AttentionSparse

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 axis_name=None, uniform_graph_size: Optional[int] = None, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        check_group(axis_name, "axis_name")
        super().__init__(dim, heads, dim_head, device=device, dtype=dtype, generator=generator)
        self.axis_name = axis_name
        self.uniform_graph_size = uniform_graph_size

    def forward(self, x, queries, batch, num_graphs, node_mask=None):
        axis, ugs = self.axis_name, self.uniform_graph_size
        xn = graph_layer_norm(x, batch, num_graphs, self.norm_seq_gamma, self.norm_seq_beta,
                              node_mask=node_mask, axis_name=axis, uniform_size=ugs)
        qn = layer_norm(queries, self.norm_queries_gamma, self.norm_queries_beta)
        induced = self.attn1.queries_to_nodes(qn, xn, batch, num_graphs, node_mask=node_mask,
                                              axis_name=axis)
        x = self.attn2.nodes_to_queries(xn, induced, batch) + x
        queries = induced + queries
        x_norm = graph_layer_norm(x, batch, num_graphs, self.ff_norm_gamma, self.ff_norm_beta,
                                  node_mask=node_mask, axis_name=axis, uniform_size=ugs)
        x = F.gelu(x_norm @ self.ff_w1 + self.ff_b1) @ self.ff_w2 + self.ff_b2 + x_norm
        return x, queries


class EGNNSparseNetwork(nn.Module):
    """A stack of ``EGNNSparse`` layers (``mpnn_0`` ...) with categorical
    node and edge embeddings (``emb_i``, ``edge_emb_i``), optional per-graph
    global attention every ``global_linear_attn_every`` layers
    (``global_attn_i``, tokens ``global_tokens``) and a dynamic-edge hook
    (egnn_pytorch_geometric.py:274-439): every ``recalc`` layers
    ``recalc_edge(x)`` gives new ``(edge_index, edge_attr, edge_mask)``, of
    static shape (``ops/graph.py:knn_graph`` keeps a uniform layout)."""

    # Parameters that a reference tree may lack: ``load_flax_params`` leaves
    # them as they are then (the port makes them at construction, so that an
    # optimiser built before the first call holds them).
    lazy_parameters = ("global_tokens",)

    def __init__(
        self,
        n_layers: int,
        feats_dim: int,
        pos_dim: int = 3,
        edge_attr_dim: int = 0,
        m_dim: int = 16,
        fourier_features: int = 0,
        soft_edge: int = 0,
        embedding_nums: Sequence[int] = (),
        embedding_dims: Sequence[int] = (),
        edge_embedding_nums: Sequence[int] = (),
        edge_embedding_dims: Sequence[int] = (),
        update_coors: bool = True,
        update_feats: bool = True,
        norm_feats: bool = True,
        norm_coors: bool = False,
        norm_coors_scale_init: float = 1e-2,
        dropout: float = 0.0,
        coor_weights_clamp_value: Optional[float] = None,
        aggr: str = "add",
        global_linear_attn_every: int = 0,
        global_linear_attn_heads: int = 8,
        global_linear_attn_dim_head: int = 64,
        num_global_tokens: int = 4,
        recalc: int = 0,
        shard_axis=None,
        uniform_degree: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
        fused_uniform: Optional[bool] = None,
        uniform_graph_size: Optional[int] = None,
        *,
        device=None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        check_group(shard_axis, "shard_axis")
        param = ParamFactory(self, device, dtype, generator)
        self.n_layers = n_layers
        self.pos_dim = pos_dim
        self.embedding_dims = list(embedding_dims)
        self.edge_embedding_dims = list(edge_embedding_dims)
        self.global_linear_attn_every = global_linear_attn_every
        self.recalc = recalc
        # each categorical column becomes its embedding (egnn_pytorch_geometric.py:334-342)
        feats_dim = feats_dim + sum(dm - 1 for dm in embedding_dims)
        edge_attr_dim = edge_attr_dim + sum(dm - 1 for dm in edge_embedding_dims)
        for i, (num, dim) in enumerate(zip(embedding_nums, embedding_dims)):
            param(f"emb_{i}", inits.unit_normal_init, (num, dim))
        for i, (num, dim) in enumerate(zip(edge_embedding_nums, edge_embedding_dims)):
            param(f"edge_emb_{i}", inits.unit_normal_init, (num, dim))
        if global_linear_attn_every > 0:
            param("global_tokens", inits.unit_normal_init, (num_global_tokens, feats_dim))
        sub = dict(device=param.device, dtype=dtype, generator=param.gen)
        for i in range(n_layers):
            if global_linear_attn_every > 0 and i % global_linear_attn_every == 0:
                self.add_module(f"global_attn_{i}", GlobalLinearAttentionSparse(
                    feats_dim, global_linear_attn_heads, global_linear_attn_dim_head,
                    axis_name=shard_axis, uniform_graph_size=uniform_graph_size, **sub))
            self.add_module(f"mpnn_{i}", EGNNSparse(
                feats_dim=feats_dim, pos_dim=pos_dim, edge_attr_dim=edge_attr_dim, m_dim=m_dim,
                fourier_features=fourier_features, soft_edge=soft_edge, norm_feats=norm_feats,
                norm_coors=norm_coors, norm_coors_scale_init=norm_coors_scale_init,
                update_feats=update_feats, update_coors=update_coors, dropout=dropout,
                coor_weights_clamp_value=coor_weights_clamp_value, aggr=aggr,
                compute_dtype=compute_dtype, uniform_degree=uniform_degree,
                fused_uniform=fused_uniform, uniform_graph_size=uniform_graph_size,
                shard_axis=shard_axis, **sub))

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor,
        batch: Optional[torch.Tensor] = None,
        edge_attr: Optional[torch.Tensor] = None,
        edge_mask: Optional[torch.Tensor] = None,
        num_graphs: int = 1,
        node_mask: Optional[torch.Tensor] = None,
        recalc_edge: Optional[Callable] = None,
        bsize: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``generator``: the dropout masks' source in training mode (see
        ``EGNNSparse.forward``)."""
        # the reference's vestigial ``size`` hint (egnn_pytorch_geometric.py:395,423)
        if bsize is not None and bsize != x.shape[0]:
            raise ValueError(f"bsize={bsize} disagrees with the static node count "
                             f"{x.shape[0]}; static-capacity batches size via padding")
        pos = self.pos_dim
        if self.global_linear_attn_every > 0:
            global_tokens = self.global_tokens.expand(num_graphs, *self.global_tokens.shape)
        batch_ids = batch if batch is not None else torch.zeros(
            x.shape[0], dtype=torch.int64, device=x.device)
        emb = [getattr(self, f"emb_{i}") for i in range(len(self.embedding_dims))]
        x = torch.cat([x[:, :pos], embed_tokens(x[:, pos:], self.embedding_dims, emb)], dim=-1)
        edge_emb = [getattr(self, f"edge_emb_{i}") for i in range(len(self.edge_embedding_dims))]

        edges_need_embedding = check_layout = True
        for i in range(self.n_layers):
            if edges_need_embedding and edge_attr is not None:
                edge_attr = embed_tokens(edge_attr, self.edge_embedding_dims, edge_emb)
                edges_need_embedding = False
            if self.global_linear_attn_every > 0 and i % self.global_linear_attn_every == 0:
                feats, global_tokens = getattr(self, f"global_attn_{i}")(
                    x[:, pos:], global_tokens, batch_ids, num_graphs, node_mask=node_mask)
                x = torch.cat([x[:, :pos], feats], dim=-1)
            x = getattr(self, f"mpnn_{i}")(
                x, edge_index, edge_attr=edge_attr, batch=batch, edge_mask=edge_mask,
                num_graphs=num_graphs, node_mask=node_mask, check_layout=check_layout,
                generator=generator)
            check_layout = False      # each edge set is checked once, by its first layer
            if (self.recalc and recalc_edge is not None and i % self.recalc == 0
                    and i != self.n_layers - 1):
                edge_index, edge_attr, edge_mask = recalc_edge(x)
                edges_need_embedding = check_layout = True
        return x


EGNN_Sparse = EGNNSparse
EGNN_Sparse_Network = EGNNSparseNetwork
