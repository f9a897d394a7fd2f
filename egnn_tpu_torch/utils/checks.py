"""Numerical sanitizers, the counterpart of ``egnn_tpu/utils/checks.py``.

What goes wrong in a training run is numerics (NaN or infinity from an
exploding coordinate update) and gathers out of bounds on padded edge lists.
These helpers make both loud:

- ``guard_finite(tree, name)``: raise if any floating tensor is not finite;
- ``assert_in_bounds(idx, n)``: raise on an edge index outside [0, n);
- ``checked(fn)``: ``fn`` itself. The JAX package wraps a jitted function in
  ``checkify`` so that the guards inside raise on the host; here the guards
  raise where they run, and there is nothing to wrap;
- ``tree_all_finite(tree)``: a 0-d bool tensor, read by nobody;
- ``finite_or_skip_step(step)``: a train step that keeps its old state
  where its new state or its loss is not finite.

``guard_finite`` and ``assert_in_bounds`` decide on the host: on a CUDA
tensor each costs one device-to-host read (and a wait for the work before
it). Keep them out of a step that should run ahead of the host, or out of
one that a CUDA graph captures. ``finite_or_skip_step`` decides on the
device, as the JAX guard does under ``jax.jit``, and reads nothing back.
"""
from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import Any, Callable, Iterator

import torch
from torch import nn


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nest of mappings, sequences, modules (their
    parameters and buffers) and optimizers (their state)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.optim.Optimizer):
        for st in tree.state.values():
            yield from _leaves(st)
    elif isinstance(tree, Mapping):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)


def _floating(tree: Any) -> list[torch.Tensor]:
    return [t for t in _leaves(tree) if t.is_floating_point()]


def guard_finite(tree: Any, name: str = "value") -> None:
    """Raise ``ValueError`` if any floating tensor of ``tree`` holds a NaN or
    an infinity (one host read a tensor)."""
    for i, leaf in enumerate(_floating(tree)):
        if not bool(torch.isfinite(leaf).all()):
            raise ValueError(f"non-finite values in {name}[leaf {i}]")


def assert_in_bounds(indices: torch.Tensor, n: int, name: str = "index") -> None:
    """Raise ``ValueError`` on an index outside [0, n): a gather would fault
    on the card (and wrap or fault on the CPU) where XLA clamps silently."""
    if not bool(((indices >= 0) & (indices < n)).all()):
        raise ValueError(f"{name} out of bounds for size {n}")


def checked(fn: Callable) -> Callable:
    """``fn`` unchanged: the guards raise where they are called."""
    return fn


def tree_all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every floating tensor of ``tree`` is finite. Nothing
    is read back to the host."""
    leaves = _floating(tree)
    if not leaves:
        return torch.tensor(True)
    ok = torch.ones((), dtype=torch.bool, device=leaves[0].device)
    for leaf in leaves:
        ok = ok & torch.isfinite(leaf).all()
    return ok


def finite_or_skip_step(step_fn: Callable) -> Callable:
    """Wrap a train step ``step_fn(*batch) -> loss`` that names its
    ``TrainState`` in ``step_fn.state`` and steps its optimizer through
    ``TrainState.apply_gradients(loss)`` (``make_denoise_train_step``'s
    step): where the new parameters, the new optimizer state or the loss are
    not finite, the old state is kept and the call returns a NaN loss as the
    skip marker, as ``egnn_tpu.utils.finite_or_skip_step`` does.

    The guard is the JAX guard's arithmetic on the device
    (``TrainState.apply_gradients``): the state before the optimizer step is
    kept in flat buffers, ``ok`` is computed after it, and every tensor of
    the state takes ``where(ok, new, old)``: the parameters, the
    optimizer's tensors, its accumulation counter (``Adam.mini_step``) and
    ``TrainState.step``. So a skipped micro-step leaves its accumulation
    window as if it had not been called, a finite gradient whose update
    overflows is skipped too, and nothing is read back: a CUDA graph can
    capture the guarded step.
    """
    state = step_fn.state

    @functools.wraps(step_fn)
    def wrapper(*args, **kwargs):
        state.guarded = True
        try:
            return step_fn(*args, **kwargs)
        finally:
            state.guarded = False

    wrapper.state = state
    return wrapper
