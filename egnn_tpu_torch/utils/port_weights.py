"""Carry weights into the port's modules: a Flax parameter tree of the JAX
package, or a module of the reference torch package ``egnn-pytorch``.

The counterpart, in the other direction, of ``egnn_tpu/utils/port_weights.py``:
``load_flax_params(module, params)`` copies the ``params`` tree of an
``egnn_tpu`` module (``EGNN``, ``EGNNNetwork``, ``EGNNSparse``,
``EGNNSparseNetwork``, ``Attention``, ``GlobalLinearAttention``,
``GlobalLinearAttentionSparse``: nested dicts of numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, variables["params"])``) into the
port's module of the same configuration (``load_stacked_flax_params`` does
the same for the pipeline's stacked layer tree). Both sides use the same names and
the (in, out) layout, so nothing is transposed: Flax's ``egnn_0`` /
``edge_mlp_0_w`` is the torch parameter ``egnn_0.edge_mlp_0_w``, a dense or
sparse network's ``global_attn_0`` / ``attn1`` / ``to_q_w`` and
``global_tokens`` are ``global_attn_0.attn1.to_q_w`` and ``global_tokens``,
and a sparse network's ``mpnn_0`` / ``edge_mlp_0_w`` and ``emb_0`` are
``mpnn_0.edge_mlp_0_w`` and ``emb_0``.

The ``*_params_from_torch`` functions are the counterparts of
``egnn_tpu/utils/port_weights.py``'s: each maps a reference module's
weights onto the port's names as such a tree (numpy arrays, (in, out)
layout), so ``load_flax_params(port_module, egnn_network_params_from_torch(
reference_network))`` carries a trained reference checkpoint over. A torch
``nn.Linear`` holds its weight as (out, in), so it is transposed; the
reference's MLPs interleave Dropout and SiLU, and their ``Linear`` layers sit
at ``Sequential`` positions 0 and 3 in the dense (egnn_pytorch.py:178-208)
and sparse (egnn_pytorch_geometric.py:143-172) layers alike.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name + "."))
        else:
            flat[name] = np.array(value)  # a writable copy
    return flat


def _lazy_names(module: nn.Module) -> set[str]:
    """The full names of the parameters that the submodules list in their
    ``lazy_parameters``: those the reference creates on first use."""
    return {f"{prefix}.{name}" if prefix else name
            for prefix, sub in module.named_modules()
            for name in getattr(sub, "lazy_parameters", ())}


def load_flax_params(module: nn.Module, params: Mapping[str, Any]) -> None:
    """Copy ``params`` into ``module``'s parameters, in place.

    A parameter that the reference creates on first use (a submodule's
    ``lazy_parameters``: ``EGNNNetwork``'s ``edge_emb`` and
    ``global_tokens``, ``EGNNSparseNetwork``'s ``global_tokens``) and that
    ``params`` lacks is left as it is. Raises ``KeyError`` for any other
    parameter missing from ``params`` or a key of ``params`` the module
    lacks, and ``ValueError`` for a shape mismatch; nothing is copied then.
    """
    flat = _flatten(params)
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(flat) - _lazy_names(module))
    unknown = sorted(set(flat) - set(own))
    if missing or unknown:
        raise KeyError(f"parameter names differ: missing {missing}, unknown {unknown}")
    for name, value in flat.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                             f"{tuple(own[name].shape)}")
    with torch.no_grad():
        for name, value in flat.items():
            p = own[name]
            p.copy_(torch.as_tensor(value, dtype=p.dtype, device=p.device))


def load_stacked_flax_params(layer: nn.Module, stacked: Mapping[str, Any]) -> dict:
    """The JAX package's stacked layer tree (``egnn_tpu.parallel.
    stack_layer_params``' output: each parameter of one layer with a leading
    (depth,) axis, numpy arrays) -> the port's stacked tensors, what
    ``egnn_tpu_torch.parallel.stack_layer_params`` gives, with ``layer`` as
    the template: the same names, the (in, out) layout, ``layer``'s dtype
    and device; new leaves that require gradients. Raises ``KeyError`` where
    the names differ and ``ValueError`` where a layer's shape does."""
    flat = _flatten(stacked)
    own = dict(layer.named_parameters())
    if set(flat) != set(own):
        raise KeyError(f"parameter names differ: missing {sorted(set(own) - set(flat))}, "
                       f"unknown {sorted(set(flat) - set(own))}")
    depths = {v.shape[0] for v in flat.values()}
    if len(depths) != 1:
        raise ValueError(f"the stacked parameters hold different depths {sorted(depths)}")
    out = {}
    for name, p in own.items():
        if tuple(flat[name].shape[1:]) != tuple(p.shape):
            raise ValueError(f"{name}: a layer's shape {tuple(flat[name].shape[1:])} != "
                             f"{tuple(p.shape)}")
        out[name] = torch.as_tensor(flat[name], dtype=p.dtype, device=p.device).requires_grad_()
    return out


def _t2n(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _copy_mlp(params: dict, prefix: str, seq, linear_positions=(0, 3)) -> None:
    for our_idx, pos in enumerate(linear_positions):
        lin = seq[pos]
        params[f"{prefix}_{our_idx}_w"] = _t2n(lin.weight).T.copy()
        params[f"{prefix}_{our_idx}_b"] = _t2n(lin.bias)


def egnn_params_from_torch(torch_layer) -> dict:
    """Reference ``EGNN`` (the dense layer) -> the tree of the port's
    ``EGNN``."""
    p: dict = {}
    _copy_mlp(p, "edge_mlp", torch_layer.edge_mlp)
    if torch_layer.coors_mlp is not None:
        _copy_mlp(p, "coors_mlp", torch_layer.coors_mlp)
    if torch_layer.node_mlp is not None:
        _copy_mlp(p, "node_mlp", torch_layer.node_mlp)
    if torch_layer.edge_gate is not None:
        p["edge_gate_w"] = _t2n(torch_layer.edge_gate[0].weight).T.copy()
        p["edge_gate_b"] = _t2n(torch_layer.edge_gate[0].bias)
    if isinstance(torch_layer.node_norm, nn.LayerNorm):
        p["node_norm_gamma"] = _t2n(torch_layer.node_norm.weight)
        p["node_norm_beta"] = _t2n(torch_layer.node_norm.bias)
    if hasattr(torch_layer.coors_norm, "scale"):
        p["coors_norm_scale"] = _t2n(torch_layer.coors_norm.scale)
    return p


def egnn_sparse_params_from_torch(torch_layer) -> dict:
    """Reference ``EGNN_Sparse`` -> the tree of the port's ``EGNNSparse``."""
    p: dict = {}
    _copy_mlp(p, "edge_mlp", torch_layer.edge_mlp)
    if torch_layer.coors_mlp is not None:
        _copy_mlp(p, "coors_mlp", torch_layer.coors_mlp)
    if torch_layer.node_mlp is not None:
        _copy_mlp(p, "node_mlp", torch_layer.node_mlp)
    if torch_layer.edge_weight is not None:
        p["edge_weight_w"] = _t2n(torch_layer.edge_weight[0].weight).T.copy()
        p["edge_weight_b"] = _t2n(torch_layer.edge_weight[0].bias)
    if torch_layer.node_norm is not None:
        p["node_norm_gamma"] = _t2n(torch_layer.node_norm.weight)
        p["node_norm_beta"] = _t2n(torch_layer.node_norm.bias)
    if hasattr(torch_layer.coors_norm, "scale"):
        p["coors_norm_scale"] = _t2n(torch_layer.coors_norm.scale)
    return p


def _attention_params_from_torch(attn) -> dict:
    return {
        "to_q_w": _t2n(attn.to_q.weight).T.copy(),
        "to_kv_w": _t2n(attn.to_kv.weight).T.copy(),
        "to_out_w": _t2n(attn.to_out.weight).T.copy(),
        "to_out_b": _t2n(attn.to_out.bias),
    }


def egnn_network_params_from_torch(torch_net) -> dict:
    """Reference ``EGNN_Network`` -> the tree of the port's ``EGNNNetwork``:
    the token, position, edge and adjacency-degree embeddings, the global
    tokens, every layer and the interleaved ``GlobalLinearAttention`` blocks
    (egnn_pytorch.py:343-454)."""
    p: dict = {}
    for name in ("token_emb", "pos_emb", "edge_emb", "adj_emb"):
        emb = getattr(torch_net, name)
        if emb is not None:
            p[name] = _t2n(emb.weight)
    if torch_net.global_tokens is not None:
        p["global_tokens"] = _t2n(torch_net.global_tokens)
    for ind, (gattn, egnn) in enumerate(torch_net.layers):
        p[f"egnn_{ind}"] = egnn_params_from_torch(egnn)
        if gattn is not None:
            p[f"global_attn_{ind}"] = {
                "norm_seq_gamma": _t2n(gattn.norm_seq.weight),
                "norm_seq_beta": _t2n(gattn.norm_seq.bias),
                "norm_queries_gamma": _t2n(gattn.norm_queries.weight),
                "norm_queries_beta": _t2n(gattn.norm_queries.bias),
                "attn1": _attention_params_from_torch(gattn.attn1),
                "attn2": _attention_params_from_torch(gattn.attn2),
                # the reference's ff: [LayerNorm, Linear, GELU, Linear]
                "ff_norm_gamma": _t2n(gattn.ff[0].weight),
                "ff_norm_beta": _t2n(gattn.ff[0].bias),
                "ff_w1": _t2n(gattn.ff[1].weight).T.copy(),
                "ff_b1": _t2n(gattn.ff[1].bias),
                "ff_w2": _t2n(gattn.ff[3].weight).T.copy(),
                "ff_b2": _t2n(gattn.ff[3].bias),
            }
    return p


def egnn_sparse_network_params_from_torch(torch_net) -> dict:
    """Reference ``EGNN_Sparse_Network`` -> the tree of the port's
    ``EGNNSparseNetwork``: the embedding tables ``emb_i`` / ``edge_emb_i``
    and each layer ``mpnn_i`` of the reference's ``mpnn_layers``
    (egnn_pytorch_geometric.py:334-346). A layer stored as a ``ModuleList``
    with attention (``global_linear_attn_every > 0``) raises ``ValueError``:
    the reference's sparse global-attention forward is itself broken, so
    those checkpoints carry no attention weights to carry over."""
    p: dict = {}
    for i, emb in enumerate(torch_net.emb_layers):
        p[f"emb_{i}"] = _t2n(emb.weight)
    for i, emb in enumerate(torch_net.edge_emb_layers):
        p[f"edge_emb_{i}"] = _t2n(emb.weight)
    for i, layer in enumerate(torch_net.mpnn_layers):
        if not hasattr(layer, "edge_mlp"):
            raise ValueError(
                f"mpnn_layers[{i}] is not a plain EGNN_Sparse (a ModuleList from "
                "global_linear_attn_every > 0?); the reference's sparse global-attention "
                "checkpoints cannot be carried over: carry entry [0] by hand if that is "
                "what you want")
        p[f"mpnn_{i}"] = egnn_sparse_params_from_torch(layer)
    return p
