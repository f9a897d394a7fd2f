"""Carry a Flax parameter tree of the JAX package into a torch module.

The counterpart, in the other direction, of ``egnn_tpu/utils/port_weights.py``:
``load_flax_params(module, params)`` copies the ``params`` tree of an
``egnn_tpu`` module (``EGNN``, ``EGNNNetwork``, ``EGNNSparse``,
``EGNNSparseNetwork``, ``Attention``, ``GlobalLinearAttention``,
``GlobalLinearAttentionSparse``: nested dicts of numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, variables["params"])``) into the
port's module of the same configuration. Both sides use the same names and
the (in, out) layout, so nothing is transposed: Flax's ``egnn_0`` /
``edge_mlp_0_w`` is the torch parameter ``egnn_0.edge_mlp_0_w``, a dense or
sparse network's ``global_attn_0`` / ``attn1`` / ``to_q_w`` and
``global_tokens`` are ``global_attn_0.attn1.to_q_w`` and ``global_tokens``,
and a sparse network's ``mpnn_0`` / ``edge_mlp_0_w`` and ``emb_0`` are
``mpnn_0.edge_mlp_0_w`` and ``emb_0``.
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
