"""Training state, loss, optimizers and the denoising train step.

PyTorch counterpart of ``egnn_tpu/training/state.py:21-132``: the masked
MSE of the reference's denoising loop (denoise_sparse.py:68-74), Adam as
optax computes it (with global-norm clipping and ``optax.MultiSteps``
gradient accumulation), the flat-buffer Adam, and a train step that runs
zero-grad, forward, loss, backward and the optimizer step. The optimizers
are ``torch.optim.Optimizer`` subclasses whose update is the JAX code's
arithmetic, step for step. They keep their Adam step counts and the
accumulation counter on the parameters' device, so a step syncs nothing to
the host. ``capture_step``, the counterpart of ``jax.jit``, replays a step
as a CUDA graph on the card.

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

import math
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..ops.neighbors import static_k
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


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """``flat`` cut into views shaped as the tensors of ``like``."""
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in like]), like)]


class Adam(torch.optim.Optimizer):
    """``optax.adam`` with optional ``optax.clip_by_global_norm`` before it
    and ``optax.MultiSteps`` around it (``make_adam``), all on the device.

    Every call averages its gradients into ``acc`` (Welford, as optax:
    ``acc + (g - acc) / (mini_step + 1)``, a division by a device tensor),
    computes the Adam update of the average, and applies it where the
    window closes (``mini_step == grad_accum - 1``): the moments and counts
    by a select, the parameters by adding the update times the flag, ``acc``
    kept times its complement, as ``MultiSteps`` does. No Python branch
    reads the counter, so a call reads nothing back from the card and a
    CUDA graph can capture it.

    The accumulation counter lives on the device (``state["multisteps"]``);
    ``mini_step`` reads it (one host read, only when a caller asks), and
    ``state_dict()`` carries it as an int, so a run resumed inside an
    accumulation window goes on as if never stopped. The parameters keep
    one Adam count each, as saved; they move together, as optax's one count
    does, and the update reads the first. The arithmetic runs over one flat
    buffer of all the parameters, a fixed number of launches a call."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 grad_accum: int = 1, clip_norm: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.grad_accum = grad_accum
        self.clip_norm = clip_norm
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = dict(count=torch.zeros((), dtype=torch.int32, device=p.device),
                                     m=torch.zeros_like(p), v=torch.zeros_like(p),
                                     acc=torch.zeros_like(p))
        self._new_counter(0)

    def _new_counter(self, value: int) -> None:
        device = self.param_groups[0]["params"][0].device
        self.state["multisteps"] = dict(
            mini_step=torch.tensor(value, dtype=torch.int32, device=device))

    @property
    def mini_step(self) -> int:
        """The accumulation counter: micro-steps into the open window."""
        return int(self.state["multisteps"]["mini_step"])

    @torch.no_grad()
    def step(self, closure: Optional[Callable[[], torch.Tensor]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for group in self.param_groups for p in group["params"]]
        grads = _grads(params)
        emit = None
        if self.grad_accum > 1:
            mini = self.state["multisteps"]["mini_step"]
            accs = [self.state[p]["acc"] for p in params]
            acc = _flat(accs)
            acc = acc + (_flat(grads) - acc) / (mini + 1)
            grads = _unflat(acc, params)
            emit = mini == self.grad_accum - 1
        if self.clip_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            grads = [torch.where(norm < self.clip_norm, g, g / norm * self.clip_norm)
                     for g in grads]
        first = 0
        for group in self.param_groups:
            ps = group["params"]
            g = _flat(grads[first:first + len(ps)])
            first += len(ps)
            b1, b2 = group["b1"], group["b2"]
            sts = [self.state[p] for p in ps]
            ms, vs, counts = ([st[k] for st in sts] for k in ("m", "v", "count"))
            m_old, v_old = _flat(ms), _flat(vs)
            m = m_old.mul(b1).add_((1.0 - b1) * g)
            v = v_old.mul(b2).add_((1.0 - b2) * g * g)
            c = (counts[0] + 1).to(g.dtype)
            upd = (-group["lr"]) * ((m / (1.0 - b1 ** c))
                                    / (torch.sqrt(v / (1.0 - b2 ** c)) + group["eps"]))
            if emit is not None:
                m, v, upd = torch.where(emit, m, m_old), torch.where(emit, v, v_old), upd * emit
            torch._foreach_copy_(ps + ms + vs, _unflat(_flat(ps) + upd, ps) + _unflat(m, ms)
                                 + _unflat(v, vs))
            count = counts[0] + (1 if emit is None else emit.to(torch.int32))
            torch._foreach_copy_(counts, [count] * len(counts))
        if emit is not None:
            torch._foreach_copy_(accs, _unflat(acc * ~emit, accs))
            mini.copy_((mini + 1) % self.grad_accum)
        return loss

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["state"] = {k: v for k, v in sd["state"].items() if k != "multisteps"}
        return {**sd, "mini_step": self.mini_step}

    def load_state_dict(self, state_dict: dict) -> None:
        _load_state_exactly(self, state_dict)
        self._new_counter(int(state_dict["mini_step"]))


def make_adam(params: Iterable[torch.Tensor], learning_rate: float = 1e-3,
              grad_accum: int = 1, clip_norm: Optional[float] = None) -> Adam:
    """Adam matching the example's optimizer, with optional gradient
    accumulation (the reference accumulates 16 micro-steps) and global-norm
    clipping."""
    return Adam(params, lr=learning_rate, grad_accum=grad_accum, clip_norm=clip_norm)


def _group_by_dtype(tensors: list[torch.Tensor]) -> dict[torch.dtype, list[torch.Tensor]]:
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


class TrainState:
    """A module, its optimizer and the count of optimizer steps taken.

    ``step`` counts the calls of ``apply_gradients`` (micro-steps, as the
    JAX ``TrainState.step`` does under ``optax.MultiSteps``) in a 0-d tensor
    on the module's device; reading ``step`` reads it back, setting it
    writes it. ``guarded`` (set by ``utils.finite_or_skip_step`` for the
    length of a call) turns on the finite-step guard of
    ``apply_gradients``."""

    def __init__(self, module: nn.Module, optimizer: torch.optim.Optimizer, step: int = 0):
        self.module = module
        self.optimizer = optimizer
        params = list(module.parameters())
        device = params[0].device if params else torch.device("cpu")
        self._step = torch.tensor(step, dtype=torch.int32, device=device)
        self.guarded = False

    @property
    def step(self) -> int:
        return int(self._step)

    @step.setter
    def step(self, value: int) -> None:
        self._step.fill_(int(value))

    def tensors(self) -> list[torch.Tensor]:
        """What an optimizer step changes: the parameters, every tensor of
        the optimizer's state and the step count."""
        opt = [v for st in self.optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor)]
        return [*self.module.parameters(), *opt, self._step]

    @torch.no_grad()
    def apply_gradients(self, loss: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """One optimizer step on the gradients the module holds; returns
        ``loss``.

        Guarded, it is ``egnn_tpu.utils.finite_or_skip_step``'s rule on the
        device: ``ok`` = the new parameters, the new optimizer state and the
        loss all finite; where not ``ok`` every tensor of ``tensors()`` (the
        accumulation counter and the step count too) keeps its old value,
        by a select, and the loss comes back as NaN, the skip marker.
        Nothing is read back to the host."""
        if not self.guarded:
            self.optimizer.step()
            self._step += 1
            return loss
        groups = _group_by_dtype(self.tensors())
        old = {dtype: _flat(ts) for dtype, ts in groups.items()}
        self.optimizer.step()
        self._step += 1
        new = {dtype: _flat(ts) for dtype, ts in groups.items()}
        ok = torch.ones((), dtype=torch.bool, device=self._step.device)
        if loss is not None:
            ok = ok & torch.isfinite(loss).all()
        for dtype, flat in new.items():
            if dtype.is_floating_point:
                ok = ok & torch.isfinite(flat).all()
        for dtype, ts in groups.items():
            torch._foreach_copy_(ts, _unflat(torch.where(ok, new[dtype], old[dtype]), ts))
        return None if loss is None else torch.where(ok, loss, math.nan)


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
    The step's ``TrainState`` is ``step.state``; under
    ``utils.finite_or_skip_step`` a skipped step returns a NaN loss.

    The step is the counterpart of the JAX package's jitted step: a layer
    with ``only_sparse_neighbors`` takes its given ``num_nearest_neighbors``
    as k (``ops/neighbors.py:static_k``), where a direct call of the
    network takes the adjacency's largest row degree. It reads nothing back
    from the card, so ``capture_step`` can capture it.

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
    """``step(*batch)``: zero-grad, ``local_loss(*batch)`` in eval mode
    under ``static_k``, backward, then ``TrainState.apply_gradients``; the
    loss comes back detached. Under a process group ``local_loss`` is this
    rank's share of the global loss, and the loss and the gradients are
    summed over the group before the optimizer and the guard see them (so
    that every rank selects alike); the parameters are made equal to the
    group's first rank's when the step is built."""
    state = TrainState(net, optimizer)
    params = list(net.parameters())
    if group is not None:
        _replicate(params, group)

    def step(*batch):
        optimizer.zero_grad(set_to_none=True)
        mode = net.training
        net.eval()
        try:
            with static_k():
                loss = local_loss(*batch)
            loss.backward()
        finally:
            net.train(mode)
        loss = loss.detach()
        if group is not None:
            loss = all_reduce_(loss.clone(), group)
            _sum_grads(params, group)
        return state.apply_gradients(loss)

    step.state = state
    return step


def _signature(args: tuple) -> tuple:
    return tuple((tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor) else a
                 for a in args)


def _copy_out(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_copy_out(o) for o in out)


def capture_step(step: Callable, state: TrainState) -> Callable:
    """``step`` as the JAX package runs a jitted step: ``captured(*batch)``
    computes ``step(*batch)`` and returns a copy of its outputs (a tensor,
    or a tuple or list of them).

    On a CUDA device the first call with a new signature (the tensors'
    shapes, dtypes and devices, the other arguments' values) runs ``step``
    once on its batch on a side stream (the lazy set-up, and the host
    checks that a capture skips), puts back what that call changed
    (``state.tensors()``: parameters, optimizer state, step count),
    then captures one call into a ``torch.cuda.CUDAGraph`` over static
    copies of the batch. Each call copies its batch into those copies and
    replays the graph; no Python of ``step`` runs, so ``step`` must update
    nothing but ``state.tensors()`` in place, read nothing back from the
    card and keep its tensors: state loaded into new tensors after the
    first call is not seen. A capture that fails raises; nothing falls back
    to eager calls. Other threads may use the card meanwhile (the capture
    is thread-local). On the CPU ``step`` runs as it is, call by call.
    """
    device = state._step.device
    if device.type != "cuda":
        return step
    graphs: dict = {}

    def capture(args):
        inputs = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        tensors = state.tensors()
        saved = [t.detach().clone() for t in tensors]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step(*inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            torch._foreach_copy_(tensors, saved)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = step(*inputs)
        return graph, inputs, outputs

    def captured(*args):
        key = _signature(args)
        if key not in graphs:
            graphs[key] = capture(args)
        graph, inputs, outputs = graphs[key]
        for buf, a in zip(inputs, args):
            if isinstance(buf, torch.Tensor):
                buf.copy_(a)
        graph.replay()
        return _copy_out(outputs)

    captured.state = state
    return captured


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
    masked MSE. The same ``TrainState``, guard and static k as
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
    takes the same step. The same ``TrainState`` and guard as
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
