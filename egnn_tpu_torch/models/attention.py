"""Global attention blocks for the dense EGNN network, in PyTorch.

Counterpart of ``egnn_tpu/models/attention.py`` (the reference's
``Attention`` / ``GlobalLinearAttention``, egnn_pytorch.py:81-144): cross
attention through a few induced global tokens (Set-Transformer style), so
that global context costs O(n), not O(n^2). Plain torch operators (einsum,
softmax, exact GELU), the JAX package's parameter names and (in, out)
weight layout. The reference never applies the EGNN's init to these blocks,
so their weights carry torch.nn.Linear's defaults.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.core import layer_norm
from ..parallel.collectives import all_gather_rows
from . import init as inits
from .init import ParamFactory


class Attention(nn.Module):
    """Multi-head cross attention: queries from ``x``, keys and values from
    ``context``, an optional boolean key mask (egnn_pytorch.py:81-110)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, *, device=None,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        param = ParamFactory(self, device, dtype, generator)
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        param("to_q_w", inits.torch_linear_weight_init, (dim, inner))
        param("to_kv_w", inits.torch_linear_weight_init, (dim, inner * 2))
        param("to_out_w", inits.torch_linear_weight_init, (inner, dim))
        param("to_out_b", inits.torch_linear_bias_init(inner), (dim,))

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (b, i, dim), context (b, j, dim), mask (b, j) -> (b, i, dim)."""
        h, dh = self.heads, self.dim_head

        def split_heads(t):
            return t.reshape(t.shape[0], t.shape[1], h, dh).transpose(1, 2)

        k, v = (context @ self.to_kv_w).chunk(2, dim=-1)
        q, k, v = map(split_heads, (x @ self.to_q_w, k, v))
        dots = torch.einsum("bhid,bhjd->bhij", q, k) * dh ** -0.5
        if mask is not None:
            # the largest finite negative, not -inf: a row whose keys are all
            # masked gets a uniform softmax, as in the JAX package
            dots = torch.where(mask[:, None, None, :], dots, -torch.finfo(dots.dtype).max)
        out = torch.einsum("bhij,bhjd->bhid", dots.softmax(dim=-1), v)
        out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], h * dh)
        return out @ self.to_out_w + self.to_out_b


class GlobalLinearAttention(nn.Module):
    """Induced-set global attention and feed-forward (egnn_pytorch.py:112-144):
    the global tokens attend over the nodes (``attn1``), the nodes attend back
    over the result (``attn2``); pre-LayerNorm and a residual on both
    streams, then a 4x exact-GELU MLP with a residual on the nodes."""

    attention = Attention
    # the graph axis (parallel/mesh.py:shard_nodes sets it): the nodes are
    # block-sharded over this group; the tokens attend over every rank's
    # nodes, gathered, and each rank's nodes attend back locally
    node_group = None

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, *, device=None,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        param = ParamFactory(self, device, dtype, generator)
        d = dim
        param("norm_seq_gamma", inits.ones_init, (d,))
        param("norm_seq_beta", inits.zeros_init, (d,))
        param("norm_queries_gamma", inits.ones_init, (d,))
        param("norm_queries_beta", inits.zeros_init, (d,))
        for name in ("attn1", "attn2"):
            self.add_module(name, self.attention(d, heads, dim_head, device=param.device,
                                                 dtype=dtype, generator=param.gen))
        param("ff_norm_gamma", inits.ones_init, (d,))
        param("ff_norm_beta", inits.zeros_init, (d,))
        param("ff_w1", inits.torch_linear_weight_init, (d, d * 4))
        param("ff_b1", inits.torch_linear_bias_init(d), (d * 4,))
        param("ff_w2", inits.torch_linear_weight_init, (d * 4, d))
        param("ff_b2", inits.torch_linear_bias_init(d * 4), (d,))

    def forward(self, x: torch.Tensor, queries: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """x (b, n, dim) nodes, queries (b, g, dim) global tokens, mask (b, n)
        -> (nodes, tokens)."""
        xn = layer_norm(x, self.norm_seq_gamma, self.norm_seq_beta)
        qn = layer_norm(queries, self.norm_queries_gamma, self.norm_queries_beta)
        keys, key_mask = xn, mask
        if self.node_group is not None:
            keys = all_gather_rows(xn, self.node_group, dim=1)
            if mask is not None:
                key_mask = all_gather_rows(mask.to(xn.dtype), self.node_group, dim=1) > 0.5
        induced = self.attn1(qn, keys, mask=key_mask)
        x = self.attn2(xn, induced) + x
        queries = induced + queries
        ff = layer_norm(x, self.ff_norm_gamma, self.ff_norm_beta)
        ff = F.gelu(ff @ self.ff_w1 + self.ff_b1) @ self.ff_w2 + self.ff_b2
        return ff + x, queries
