"""Training state, loss, optimizers and the denoising train step.

PyTorch counterpart of ``egnn_tpu/training/state.py:21-132``: the masked
MSE of the reference's denoising loop (denoise_sparse.py:68-74), Adam as
optax computes it (with global-norm clipping and ``optax.MultiSteps``
gradient accumulation), the flat-buffer Adam, and a train step that runs
zero-grad, forward, loss, backward and the optimizer step. The optimizers
are ``torch.optim.Optimizer`` subclasses whose update is the JAX code's
arithmetic, step for step. They keep their Adam step counts on the
parameters' device, so a step syncs nothing to the host, and a step with
``FusedAdam`` can be captured in a CUDA graph.

Two multi-process steps (``egnn_tpu/training/state.py:135-164, 229-304``)
run one process a rank over ``torch.distributed``: the data-parallel dense
step, ``make_sharded_denoise_train_step`` (the batch split over the mesh's
``data`` axis, parameters replicated), and the edge-partitioned sparse step,
``make_partitioned_sparse_train_step``; the dense step also shards the nodes
over a ``graph`` axis, where each kNN layer ranks its rank's rows against
the gathered cloud. Each rank differentiates its share
of the global loss, the gradients are summed over the group in one
``all_reduce``, and every rank's optimizer takes the same step. The ring
step, ``make_ring_denoise_train_step`` (``egnn_tpu/training/state.py:
167-229``), adds the node-sharded dense path: the batch on ``data``, the
nodes on ``graph``, the layers' all-pairs messages around the ring.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..parallel.collectives import all_reduce_, all_reduce_sum, broadcast_
from ..parallel.mesh import shard_nodes


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """MSE over valid entries (reference: F.mse_loss(denoised[masks],
    coords[masks]), denoise_sparse.py:72): the denominator is the mask count
    times the coordinate width, clamped at 1.

    ``group``: a process group whose ranks each hold a block of the batch.
    The denominator is then the group's (summed over it), and the result is
    this rank's share of the global loss: the shares sum to it."""
    err = (pred - target) ** 2
    if mask is None:
        if group is None:
            return err.mean()
        count = torch.full((), err.numel(), dtype=err.dtype, device=err.device)
        return err.sum() / all_reduce_sum(count, group)
    m = mask[..., None].to(err.dtype)
    den = mask.sum().to(err.dtype) * pred.shape[-1]
    if group is not None:
        den = all_reduce_sum(den, group)
    return (err * m).sum() / den.clamp(min=1.0)


def _load_state_exactly(opt: torch.optim.Optimizer, state_dict: dict) -> None:
    """``Optimizer.load_state_dict`` that restores each state tensor as it
    was saved: torch's casts a parameter's floating state to the
    parameter's dtype (which would turn the int32 step counts into floats)
    and leaves a key that is not a parameter (``FusedAdam``'s ``"flat"``)
    on the device it was loaded to. Here every tensor is copied to its
    parameter's device (the first parameter's for ``"flat"``) in its saved
    dtype."""
    torch.optim.Optimizer.load_state_dict(opt, state_dict)
    params = [p for group in opt.param_groups for p in group["params"]]
    for key, st in state_dict["state"].items():
        target = params[key] if isinstance(key, int) else key
        device = (target if isinstance(target, torch.Tensor) else params[0]).device
        opt.state[target] = {name: v.to(device=device, copy=True)
                             if isinstance(v, torch.Tensor) else v
                             for name, v in st.items()}


def _grads(params: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each parameter's gradient, zeros where it has none (as JAX's
    gradient of an unused parameter)."""
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


class FusedAdam(torch.optim.Optimizer):
    """Adam with its moments held as one flat buffer per order over all
    parameters (``egnn_tpu/training/state.py:make_fused_adam``): a handful
    of elementwise ops over one buffer in place of several per parameter.
    The parameters share one device and dtype."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        ps = self.param_groups[0]["params"]
        if len(self.param_groups) != 1 or len({(p.device, p.dtype) for p in ps}) != 1:
            raise ValueError("FusedAdam takes one group of parameters of one device and dtype")
        total = sum(p.numel() for p in ps)
        zeros = dict(dtype=ps[0].dtype, device=ps[0].device)
        self.state["flat"] = dict(count=torch.zeros((), dtype=torch.int32, device=ps[0].device),
                                  m=torch.zeros(total, **zeros), v=torch.zeros(total, **zeros))

    @torch.no_grad()
    def step(self, closure: Optional[Callable[[], torch.Tensor]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        params = group["params"]
        lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
        st = self.state["flat"]
        g = torch.cat([x.reshape(-1) for x in _grads(params)])
        st["count"] += 1
        m = st["m"].mul_(b1).add_((1.0 - b1) * g)
        v = st["v"].mul_(b2).add_((1.0 - b2) * g * g)
        c = st["count"].to(g.dtype)
        mhat = m / (1.0 - b1 ** c)
        vhat = v / (1.0 - b2 ** c)
        upd = (-lr) * mhat / (torch.sqrt(vhat) + eps)
        torch._foreach_add_(params, [u.view_as(p) for u, p in
                                     zip(upd.split([p.numel() for p in params]), params)])
        return loss

    def load_state_dict(self, state_dict: dict) -> None:
        _load_state_exactly(self, state_dict)


def make_fused_adam(params: Iterable[torch.Tensor], learning_rate: float = 1e-3,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> FusedAdam:
    """Adam with one flat first-moment and one flat second-moment buffer."""
    return FusedAdam(params, lr=learning_rate, b1=b1, b2=b2, eps=eps)


class Adam(torch.optim.Optimizer):
    """``optax.adam`` with optional ``optax.clip_by_global_norm`` before it
    and ``optax.MultiSteps`` around it (``make_adam``): the gradients of
    ``grad_accum`` calls are averaged (Welford: ``acc += (g - acc) / (i + 1)``)
    and the parameters move on every ``grad_accum``-th call only. The
    accumulation counter (``mini_step``, a host int, so that a step reads
    nothing back from the card) travels in ``state_dict()``, so a run
    resumed inside an accumulation window goes on as if never stopped."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 grad_accum: int = 1, clip_norm: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.grad_accum = grad_accum
        self.clip_norm = clip_norm
        self.mini_step = 0
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = dict(count=torch.zeros((), dtype=torch.int32, device=p.device),
                                     m=torch.zeros_like(p), v=torch.zeros_like(p),
                                     acc=torch.zeros_like(p))

    @torch.no_grad()
    def step(self, closure: Optional[Callable[[], torch.Tensor]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        items = [(group, p) for group in self.param_groups for p in group["params"]]
        params = [p for _, p in items]
        grads = _grads(params)
        if self.grad_accum > 1:
            i = self.mini_step
            for p, g in zip(params, grads):
                acc = self.state[p]["acc"]
                acc.add_((g - acc) / (i + 1))
            self.mini_step = (i + 1) % self.grad_accum
            if self.mini_step != 0:
                return loss
            grads = [self.state[p]["acc"].clone() for p in params]
            for p in params:
                self.state[p]["acc"].zero_()
        if self.clip_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            grads = [torch.where(norm < self.clip_norm, g, g / norm * self.clip_norm)
                     for g in grads]
        for (group, p), g in zip(items, grads):
            b1, b2 = group["b1"], group["b2"]
            st = self.state[p]
            st["count"] += 1
            m = st["m"].mul_(b1).add_((1.0 - b1) * g)
            v = st["v"].mul_(b2).add_((1.0 - b2) * g * g)
            c = st["count"].to(g.dtype)
            upd = (m / (1.0 - b1 ** c)) / (torch.sqrt(v / (1.0 - b2 ** c)) + group["eps"])
            p.add_((-group["lr"]) * upd)
        return loss

    def state_dict(self) -> dict:
        return {**super().state_dict(), "mini_step": self.mini_step}

    def load_state_dict(self, state_dict: dict) -> None:
        _load_state_exactly(self, state_dict)
        self.mini_step = int(state_dict["mini_step"])


def make_adam(params: Iterable[torch.Tensor], learning_rate: float = 1e-3,
              grad_accum: int = 1, clip_norm: Optional[float] = None) -> Adam:
    """Adam matching the example's optimizer, with optional gradient
    accumulation (the reference accumulates 16 micro-steps) and global-norm
    clipping."""
    return Adam(params, lr=learning_rate, grad_accum=grad_accum, clip_norm=clip_norm)


@dataclasses.dataclass
class TrainState:
    """A module, its optimizer and the count of optimizer steps taken.
    ``gate``, where set, decides from the loss whether the optimizer steps
    (``utils.finite_or_skip_step`` sets it for the length of a call)."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    gate: Optional[Callable[[torch.Tensor], bool]] = None

    def apply_gradients(self, loss: Optional[torch.Tensor] = None) -> bool:
        """One optimizer step on the gradients the module holds, unless
        ``gate(loss)`` says no; returns whether the optimizer stepped."""
        if self.gate is not None and not self.gate(loss):
            return False
        self.optimizer.step()
        self.step += 1
        return True


def make_denoise_train_step(
    net: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable = masked_mse,
) -> Callable:
    """Denoising train step for the dense network: predict clean coordinates
    from noised ones, loss on the masked coordinates (the reference's
    end-to-end workload, denoise_sparse.py:68-74).

    Returns ``step(tokens, noised_coors, target_coors, adj_mat, mask)``,
    which runs zero-grad, forward, loss, backward and ``optimizer.step()``
    and returns the loss as a 0-d tensor without waiting for the device.
    The step's ``TrainState`` is ``step.state``; where its gate skips the
    optimizer, the step returns a NaN loss.

    The forward and backward run in eval mode, and the module's mode is
    restored after: the JAX step calls the network without
    ``deterministic=False``, so a network built with ``dropout > 0`` trains
    there without dropout, and here too.
    """
    def loss(tokens, noised_coors, target_coors, adj_mat, mask):
        _, denoised = net(tokens, noised_coors, adj_mat=adj_mat, mask=mask)
        return loss_fn(denoised, target_coors, mask)

    return _make_step(net, optimizer, loss)


def _replicate(params: list[torch.Tensor], group) -> None:
    """Every rank's parameters set to the group's first rank's, in one
    broadcast of one flat buffer."""
    with torch.no_grad():
        flat = broadcast_(torch.cat([p.reshape(-1) for p in params]), group)
        for p, v in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(v.view_as(p))


def _sum_grads(params: list[torch.Tensor], group) -> None:
    """Each parameter's gradient summed over ``group`` (zeros where a rank
    has none), in one ``all_reduce`` of one flat buffer."""
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in _grads(params)]), group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def _make_step(net: nn.Module, optimizer: torch.optim.Optimizer, local_loss: Callable,
               group=None) -> Callable:
    """``step(*batch)``: zero-grad, ``local_loss(*batch)`` in eval mode,
    backward, then the optimizer step through ``TrainState`` and its gate;
    the loss comes back detached. Under a process group ``local_loss`` is
    this rank's share of the global loss, and the loss and the gradients are
    summed over the group before the gate reads them (so that every rank
    decides alike); the parameters are made equal to the group's first
    rank's when the step is built."""
    state = TrainState(net, optimizer)
    params = list(net.parameters())
    if group is not None:
        _replicate(params, group)

    def step(*batch):
        optimizer.zero_grad(set_to_none=True)
        mode = net.training
        net.eval()
        try:
            loss = local_loss(*batch)
            loss.backward()
        finally:
            net.train(mode)
        loss = loss.detach()
        if group is not None:
            loss = all_reduce_(loss.clone(), group)
            _sum_grads(params, group)
        return loss if state.apply_gradients(loss) else torch.full_like(loss, float("nan"))

    step.state = state
    return step


def make_sharded_denoise_train_step(
    net: nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh,
    loss_fn: Callable = masked_mse,
) -> Callable:
    """The data-parallel denoising step (``egnn_tpu/training/state.py:
    make_sharded_denoise_train_step``): the batch split over the mesh's
    ``data`` axis, the parameters replicated. A (data, model) mesh of
    ``parallel.make_tp_mesh``, with ``net`` sharded by ``tp_shard_module``,
    adds tensor parallelism: the parameters are then replicated over
    ``data`` and sharded over ``model``, and the gradients summed over
    ``data`` alone.

    Returns ``step(tokens, noised_coors, target_coors, adj_mat, mask)``,
    called on every rank with its block of the batch
    (``parallel.dense_batch_block``) and the whole adjacency. Each rank's
    loss is ``loss_fn(denoised, target, mask, group=...)``, its share of the
    global loss (``masked_mse`` divides by the mask count summed over the
    group); the gradients are summed over the group, so that the step is the
    one-process step on the whole batch, and the returned loss is the global
    masked MSE. The same ``TrainState`` and gate as
    ``make_denoise_train_step`` (``step.state``); on a mesh of one rank the
    two steps give the same bits.

    A (data, graph) mesh whose ``graph`` axis is longer than 1 adds the
    node sharding of the JAX step's ``P("data", "graph")`` inputs: the step
    sets ``net`` up for the axis (``parallel.shard_nodes`` with the axis's
    group), each rank's tokens, coordinates and mask are its block of the
    batch and of the nodes (``dense_batch_block``) and the adjacency is
    whole. A kNN layer ranks the rank's rows against the gathered cloud
    (the row-block selection), an all-pairs layer takes the ring, global
    attention attends over the gathered nodes. The loss's denominator and
    the gradients are then summed over both axes; the mesh must span every
    process.
    """
    if mesh.mesh_dim_names[1] == "graph" and mesh.size(1) > 1:
        if mesh.size() != dist.get_world_size():
            raise ValueError("the node-sharded step sums over the whole mesh: it must span "
                             "every process")
        shard_nodes(net, mesh.get_group("graph"))
        group = dist.group.WORLD
    else:
        group = mesh.get_group("data")

    def local_loss(tokens, noised_coors, target_coors, adj_mat, mask):
        _, denoised = net(tokens, noised_coors, adj_mat=adj_mat, mask=mask)
        return loss_fn(denoised, target_coors, mask, group=group)

    return _make_step(net, optimizer, local_loss, group)


def make_ring_denoise_train_step(
    net: nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh: DeviceMesh,
    data_axis: str = "data",
    graph_axis: str = "graph",
) -> Callable:
    """The ring-parallel denoising step (``egnn_tpu/training/state.py:
    make_ring_denoise_train_step``): the batch split over ``data_axis``, the
    nodes over ``graph_axis``; ``net``'s layers are built with
    ``ring_axis=mesh.get_group(graph_axis)``, so that each layer's all-pairs
    messages visit every node block around the ring.

    Returns ``step(tokens, noised_coors, target_coors, mask)``, called on
    every rank with its block (``parallel.dense_batch_block``). Each rank
    differentiates its share of the global masked MSE, whose denominator is
    the mask count summed over both axes; loss and gradients are then
    summed over both axes (one ``all_reduce`` of a flat buffer), the
    psum-after-grad rule of the other steps, and every rank's optimizer
    takes the same step. The same ``TrainState`` and gate as
    ``make_denoise_train_step`` (``step.state``).

    The network may hold no kNN (the layers refuse it with ``ring_axis``),
    no positional embedding (position ids would be block-local) and no
    global attention (its sums would be block-local): those raise
    ``ValueError``, as does a layer without the mesh's ring. The mesh must
    span every process (``parallel.make_mesh``).
    """
    if set(mesh.mesh_dim_names) != {data_axis, graph_axis}:
        raise ValueError(f"the ring step takes a ({data_axis}, {graph_axis}) mesh, not "
                         f"{mesh.mesh_dim_names}")
    if mesh.size() != dist.get_world_size():
        raise ValueError("the ring step sums over the whole mesh: it must span every process")
    ring = mesh.get_group(graph_axis)
    if getattr(net, "num_positions", None) is not None:
        raise ValueError("a positional embedding would index the block-local node ids")
    if getattr(net, "global_linear_attn_every", 0):
        raise ValueError("global attention would sum over the local node block only")
    layers = [m for m in net.modules() if hasattr(m, "ring_axis")]
    if not layers or any(m.ring_axis is not ring for m in layers):
        raise ValueError(f"every layer must be built with ring_axis=mesh.get_group("
                         f"{graph_axis!r})")
    both = dist.group.WORLD

    def local_loss(tokens, noised_coors, target_coors, mask):
        _, denoised = net(tokens, noised_coors, mask=mask)
        err = (denoised - target_coors) ** 2 * mask[..., None].to(denoised.dtype)
        den = all_reduce_sum(mask.sum().to(err.dtype) * denoised.shape[-1], both)
        return err.sum() / den.clamp(min=1.0)

    return _make_step(net, optimizer, local_loss, both)


def make_partitioned_sparse_train_step(
    net: nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh_or_group,
    num_graphs: int = 1,
) -> Callable:
    """The edge-partitioned sparse step (``egnn_tpu/training/state.py:
    make_partitioned_sparse_train_step``): nodes block-sharded over the
    group, each rank holding the edges whose receivers it owns in the
    layout of ``parallel.partition_edges`` / ``partition_uniform_edges``.
    ``net`` is an ``EGNNSparseNetwork`` built with ``shard_axis`` set to the
    same group: a process group, or a mesh whose ``graph`` axis's group is
    taken (its ``data`` axis must be 1).

    Returns ``step(x, senders, receivers, edge_mask, edge_attr, batch_ids,
    clean_coors, node_mask)``, each this rank's block (``edge_attr`` may be
    ``None``). The loss is the denoising objective, the masked MSE of the
    output's coordinate block against ``clean_coors`` over the group's
    valid nodes; the returned loss is the global one, and the gradients are
    summed over the group.
    """
    if isinstance(mesh_or_group, DeviceMesh):
        if mesh_or_group.size(0) > 1:
            raise NotImplementedError("the partitioned sparse step shards one axis, graph; "
                                      "a data axis longer than 1 is not supported")
        group = mesh_or_group.get_group("graph")
    else:
        group = mesh_or_group

    def local_loss(x, senders, receivers, edge_mask, edge_attr, batch_ids, clean, node_mask):
        out = net(x, torch.stack([senders, receivers]), batch=batch_ids, edge_attr=edge_attr,
                  edge_mask=edge_mask, num_graphs=num_graphs, node_mask=node_mask)
        pos = clean.shape[-1]
        err = (out[:, :pos] - clean) ** 2 * node_mask[:, None].to(out.dtype)
        den = all_reduce_sum(node_mask.sum().to(err.dtype) * pos, group)
        return err.sum() / den.clamp(min=1.0)

    return _make_step(net, optimizer, local_loss, group)
