"""Tensor parallelism for the dense EGNN MLPs, the counterpart of
``egnn_tpu/parallel/tp.py``.

Every MLP of the dense layer is two products with a nonlinearity between
(edge MLP: ein -> 2*ein -> m_dim; coordinate MLP: m_dim -> 4*m_dim -> 1;
node MLP: dim + m_dim -> 2*dim -> dim). That is Megatron's column-then-row
split: the first weight's output dimension and the second weight's input
dimension are sharded over a ``model`` axis, the activations stay
replicated, and one sum over the axis follows the second product.

The JAX package states the rule as parameter shardings and lets GSPMD
partition the products. torch has no GSPMD, so here the rule is applied by
hand: ``tp_param_sharding`` gives each parameter its placement
(``Shard(1)``, ``Shard(0)`` or ``Replicate()``), ``tp_shard_module`` keeps
each rank's shards in the module (the counterpart of
``jax.device_put(params, tp_param_sharding(params, mesh))``), and the layer
(``models/egnn.py:EGNN``) computes the split on every path, its collectives
Megatron's pair (``parallel/collectives.py``: ``copy_to_group`` before the
first product, ``reduce_from_group`` after the second), which keep the
gradients unscaled where every rank holds the whole loss. Every rank of the
model group runs the whole forward and backward on the same inputs; a
parameter's gradient is this rank's shard of the replicated module's.

The sparse layer (``models/egnn_sparse.py:EGNNSparse``: edge MLP ein ->
2*ein -> m_dim, coordinate MLP m_dim -> 4*m_dim -> 1, node MLP dim + m_dim
-> 2*dim -> dim) takes the same split through the same hooks
(``ShardedMLPs``); its per-edge products split as the dense layer's pair
products do, and ``fused_uniform`` (K10) takes the weights gathered whole.

Divisibility: the edge MLP's hidden width is ``2*(2*dim + 2F + 1 + e)``,
2 mod 4 for even dim with F = e = 0, so it shards at most 2 ways; a
parameter whose sharded dimension the axis does not divide stays
replicated (``tp_hidden_multiple`` pads the width to shard). Worth it only
at wide layers (dim 512 and up): at dim 32 the sums cost more than the
products save. ``tp_shard_module`` raises for a module whose sharded
parameters belong to a layer without the hooks.
"""
from __future__ import annotations

import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.device import resolve_device
from .collectives import (copy_to_group, gather_from_group, reduce_from_group, shard_along,
                          shard_cols)


class ShardedMLPs:
    """The hooks of a layer whose MLP pairs ``tp_shard_module`` may shard
    (the dense ``EGNN`` and the sparse ``EGNNSparse``): the model group and
    the MLPs (``"edge_mlp"``, ``"coors_mlp"``, ``"node_mlp"``) whose weights
    this rank holds a shard of, both set by ``tp_shard_module``; with none
    sharded every hook is the identity."""

    tp_group = None
    tp_sharded: frozenset = frozenset()

    def _col(self, mlp: str, x):
        """The input of ``mlp``'s first (column-parallel) product: under
        tensor parallelism its gradient is summed over the model group."""
        return copy_to_group(x, self.tp_group) if mlp in self.tp_sharded else x

    def _row(self, mlp: str, y):
        """``mlp``'s second (row-parallel) product before its bias: under
        tensor parallelism the ranks' partial products are summed."""
        return reduce_from_group(y, self.tp_group) if mlp in self.tp_sharded else y

    def _cols(self, mlp: str, width: int):
        """Where ``mlp`` is sharded, its hidden's columns on this rank out of
        the whole (padded) width, ``(c0, w)``, for a sharded dropout
        (``ops/core.py:sharded_part``), given the rank's ``width``; else
        None."""
        return shard_cols(self.tp_group, width) if mlp in self.tp_sharded else None

    def _whole(self, name: str):
        """A parameter whole: a shard (``<mlp>_0_w`` of columns, ``<mlp>_0_b``,
        ``<mlp>_1_w`` of rows) gathered over the model group, for the fused
        kernels."""
        p = getattr(self, name)
        mlp, part = name.rsplit("_", 2)[0], name[-3:]
        if mlp not in self.tp_sharded or part not in ("0_w", "0_b", "1_w"):
            return p
        return gather_from_group(p, self.tp_group, 1 if part == "0_w" else 0)


def make_tp_mesh(data: int = 1, model: int = 1, device=None) -> DeviceMesh:
    """A (data, model) mesh over the processes of the default group, which
    must number ``data * model`` (``parallel.initialize()`` first);
    ``data`` outermost. ``device``: where the ranks compute (the card
    unless ``"cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_tp_mesh needs a process group: call parallel.initialize() first")
    size = dist.get_world_size()
    if data * model != size:
        raise ValueError(f"mesh size data*model={data * model} != process count {size}")
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def tp_param_spec(name: str):
    """The placement of one parameter over the ``model`` axis, by its name
    (the last part of a dotted name): ``<mlp>_0_w`` is column-parallel
    (``Shard(1)``, its output dimension), ``<mlp>_0_b`` sharded
    (``Shard(0)``), ``<mlp>_1_w`` row-parallel (``Shard(0)``, its input
    dimension); everything else (the second bias, norms, gates, embeddings,
    the CoorsNorm scale) is ``Replicate()``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("_0_w"):
        return Shard(1)
    if leaf.endswith(("_0_b", "_1_w")):
        return Shard(0)
    return Replicate()


def tp_param_sharding(module: nn.Module, mesh: DeviceMesh) -> dict:
    """Each parameter's placement (``tp_param_spec``) by its dotted name, a
    sharded one replaced by ``Replicate()`` where the ``model`` axis does
    not divide its dimension (e.g. dim 64: edge hidden 258 does not split 4
    ways)."""
    axis = mesh.size(mesh.mesh_dim_names.index("model"))
    out = {}
    for name, p in module.named_parameters():
        spec = tp_param_spec(name)
        if isinstance(spec, Shard) and p.shape[spec.dim] % axis:
            spec = Replicate()
        out[name] = spec
    return out


def tp_shard_module(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Keep this rank's shards of ``module``'s parameters (in place) and set
    up its dense layers to compute the Megatron split over the mesh's
    ``model`` group; returns ``module``.

    Call it on every rank of the model group, on a module whose parameters
    are the same on every rank (e.g. loaded with ``load_flax_params``). A
    layer's MLP is sharded where its three sharded parameters are (an
    indivisible width leaves the MLP replicated, with no collective).
    Raises ``NotImplementedError`` where a sharded parameter belongs to a
    module other than a layer with the hooks (``ShardedMLPs``: the dense
    ``EGNN``, the sparse ``EGNNSparse``)."""
    group = mesh.get_group("model")
    placements = tp_param_sharding(module, mesh)
    for prefix, sub in module.named_modules():
        own = {name: p for name, p in sub.named_parameters(recurse=False)}
        sharded = {name for name in own
                   if isinstance(placements[f"{prefix}.{name}" if prefix else name], Shard)}
        if not sharded:
            continue
        if not isinstance(sub, ShardedMLPs):
            raise NotImplementedError(
                f"tensor parallelism covers the EGNN and EGNNSparse layers; "
                f"{type(sub).__name__} ({prefix or 'the module'}) holds {sorted(sharded)}")
        for name in sharded:
            spec = tp_param_spec(name)
            p = own[name]
            shard = shard_along(p.detach(), group, spec.dim).clone()
            sub._parameters[name] = nn.Parameter(shard, requires_grad=p.requires_grad)
        sub.tp_group = group
        sub.tp_sharded = frozenset(name[:-4] for name in sharded)
    return module
