"""Parameter initialisers matching ``egnn_tpu/models/init.py``'s distributions.

- Linear weights ~ Normal(0, init_eps) (egnn_pytorch.py:219-222), biases
  torch.nn.Linear's default U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
- Embedding tables ~ Normal(0, 1).
- The sparse path's weights xavier-normal, its biases zero
  (egnn_pytorch_geometric.py:176-180); its attention's weights torch.nn.Linear's
  default U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

Every draw comes from an explicit ``torch.Generator`` on the CPU and is then
moved to the target device (``ParamFactory``), so one seed gives the same
weights on every device. The bits differ from JAX's: parity tests carry weights across with
``utils/port_weights.py:load_flax_params`` instead. Weights are stored
(in, out), as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from ..utils.device import resolve_device

Init = Callable[[Sequence[int], torch.Generator], torch.Tensor]


def normal_init(std: float) -> Init:
    def init(shape, gen):
        return std * torch.randn(tuple(shape), generator=gen, dtype=torch.float64)

    return init


def torch_linear_bias_init(fan_in: int) -> Init:
    """torch.nn.Linear default bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / (fan_in**0.5)

    def init(shape, gen):
        u = torch.rand(tuple(shape), generator=gen, dtype=torch.float64)
        return (2.0 * u - 1.0) * bound

    return init


def torch_linear_weight_init(shape, gen):
    """torch.nn.Linear's default weight for an (in, out) weight:
    kaiming_uniform(a=sqrt(5)) on (out, in), U(-1/sqrt(in), 1/sqrt(in))."""
    return torch_linear_bias_init(shape[-2])(shape, gen)


def xavier_normal_init(shape, gen):
    """Normal(0, sqrt(2 / (fan_in + fan_out))) for an (in, out) weight."""
    std = (2.0 / (shape[-2] + shape[-1])) ** 0.5
    return std * torch.randn(tuple(shape), generator=gen, dtype=torch.float64)


def unit_normal_init(shape, gen):
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float64)


def constant_init(value: float) -> Init:
    def init(shape, gen):
        del gen
        return torch.full(tuple(shape), value, dtype=torch.float64)

    return init


def ones_init(shape, gen):
    return constant_init(1.0)(shape, gen)


def zeros_init(shape, gen):
    return constant_init(0.0)(shape, gen)


def zero_pad_axis(base_init: Init, axis: int, valid: int) -> Init:
    """Run ``base_init`` on the first ``valid`` entries along ``axis`` and zero
    the rest: the inert padding of ``EGNN(tp_hidden_multiple=...)``."""

    def init(shape, gen):
        vshape = [valid if i == axis else s for i, s in enumerate(shape)]
        out = torch.zeros(tuple(shape), dtype=torch.float64)
        out.narrow(axis, 0, valid).copy_(base_init(vshape, gen))
        return out

    return init


class ParamFactory:
    """Creates a module's parameters by name from an initialiser, drawing
    from one generator and placing them on one device in one dtype."""

    def __init__(self, module, device, dtype, generator):
        self.module = module
        self.device = resolve_device(device)
        self.dtype = dtype
        self.gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def __call__(self, name, init, shape):
        value = init(shape, self.gen).to(device=self.device, dtype=self.dtype)
        self.module.register_parameter(name, nn.Parameter(value))

    def linear(self, name, d_in, d_out, init_eps):
        self(f"{name}_w", normal_init(init_eps), (d_in, d_out))
        self(f"{name}_b", torch_linear_bias_init(d_in), (d_out,))
