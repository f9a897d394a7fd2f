"""Pieces shared by the reference families: the EGNN sub-equations and Adam
(optax's ``adam`` inside ``MultiSteps`` accumulation), in plain PyTorch."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sum_sq(rel: torch.Tensor) -> torch.Tensor:
    """((r0^2 + r1^2) + r2^2) + ... over the last axis, one coordinate at a
    time (so the ranking of ties follows the order of the sums)."""
    out = rel[..., 0] * rel[..., 0]
    for c in range(1, rel.shape[-1]):
        out = out + rel[..., c] * rel[..., c]
    return out


def fourier(dist: torch.Tensor, num: int) -> torch.Tensor:
    """[sin(x / 2^i), cos(x / 2^i) for i < num, x] of the squared distance
    (egnn_pytorch.py: fourier_encode_dist); [x] alone at num = 0."""
    x = dist[..., None]
    if num == 0:
        return x
    scales = 2.0 ** torch.arange(num, dtype=x.dtype, device=x.device)
    xs = x / scales
    return torch.cat([torch.sin(xs), torch.cos(xs), x], dim=-1)


def coors_norm(rel: torch.Tensor, scale: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """CoorsNorm: rel / max(|rel|, eps) * scale (the clamp inside the root)."""
    norm = torch.sqrt(sum_sq(rel)[..., None].clamp(min=eps * eps))
    return rel / norm * scale


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis, biased variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


def mlp2(x, p: dict, name: str, act_out: bool = False):
    """silu(x @ W0 + b0) @ W1 + b1 (and silu of that with ``act_out``)."""
    h = F.silu(x @ p[f"{name}_0_w"] + p[f"{name}_0_b"])
    y = h @ p[f"{name}_1_w"] + p[f"{name}_1_b"]
    return F.silu(y) if act_out else y


class Adam:
    """Adam as optax computes it, over a dict of parameters, with
    ``optax.MultiSteps`` accumulation: each call averages its gradient into
    ``acc`` (acc + (g - acc) / (i + 1)); the update of that average is applied
    on every ``accum``-th call, which also advances the Adam count."""

    def __init__(self, params: dict, lr: float, accum: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.accum, self.b1, self.b2, self.eps = lr, accum, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.acc = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.mini = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        for k, g in grads.items():
            self.acc[k] = self.acc[k] + (g - self.acc[k]) / (self.mini + 1)
        self.mini += 1
        if self.mini < self.accum:
            return
        self.mini = 0
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k in params:
            g = self.acc[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            params[k] -= self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            self.acc[k] = torch.zeros_like(g)


def train_steps(params: dict, loss_fn, batches, lr: float, accum: int):
    """Run ``loss_fn(params, batch)`` with Adam over ``batches``; returns
    (losses, the first step's gradients, the parameters after the last)."""
    params = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, lr, accum)
    losses, first = [], None
    for batch in batches:
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, batch)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, first, params
