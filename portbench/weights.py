"""Seeded weights, drawn on the device in two large calls and cut into the
named parameters of a reference family's ``param_shapes``.

``rule`` (a traffic mix's ``weights``) says how: ``"init"`` keeps each
parameter's own initial distribution; ``"trained_scale"`` draws every matrix
(a 2-D ``*_w``) xavier-normal, the scale of a trained network's weights,
where the module starts some of them near zero.
"""
from __future__ import annotations

import torch


def _draw(name: str, shape: tuple, draw: tuple, rule: str) -> tuple:
    if rule == "trained_scale" and name.endswith("_w") and len(shape) == 2:
        return ("normal", (2.0 / (shape[0] + shape[1])) ** 0.5)
    if rule not in ("init", "trained_scale"):
        raise ValueError(f"unknown weights rule {rule!r}")
    return draw


def make(shapes: list, seed: int, device, rule: str = "init") -> dict:
    """{name: float32 tensor on ``device``} from ``seed``."""
    plan = [(n, tuple(s), _draw(n, tuple(s), d, rule)) for n, s, d in shapes]
    numel = {n: int(torch.Size(s).numel()) for n, s, _ in plan}
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    normal = torch.randn(sum(numel[n] for n, _, d in plan if d[0] == "normal"),
                         generator=gen, device=device)
    uniform = torch.rand(sum(numel[n] for n, _, d in plan if d[0] == "uniform"),
                         generator=gen, device=device)
    out, at = {}, {"normal": 0, "uniform": 0}
    for name, shape, (kind, value) in plan:
        if kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
            continue
        src = normal if kind == "normal" else uniform
        flat = src[at[kind]:at[kind] + numel[name]]
        at[kind] += numel[name]
        out[name] = (flat * value if kind == "normal" else (2.0 * flat - 1.0) * value).view(shape)
    return out
