"""Euler-angle rotation matrices for equivariance checks (reference
utils.py:4-19), the counterpart of ``egnn_tpu/utils/rotations.py``.

An angle given as a tensor keeps its dtype and device; a Python number
becomes a float64 tensor on ``device`` (the card unless the caller passes
``device="cpu"``).
"""
from __future__ import annotations

import torch

from .device import resolve_device


def _angle(angle, device) -> torch.Tensor:
    if isinstance(angle, torch.Tensor):
        return angle
    return torch.as_tensor(angle, dtype=torch.float64, device=resolve_device(device))


def _matrix(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_z(gamma, device=None) -> torch.Tensor:
    gamma = _angle(gamma, device)
    c, s = torch.cos(gamma), torch.sin(gamma)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _matrix([[c, -s, z], [s, c, z], [z, z, o]])


def rot_y(beta, device=None) -> torch.Tensor:
    beta = _angle(beta, device)
    c, s = torch.cos(beta), torch.sin(beta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _matrix([[c, z, s], [z, o, z], [-s, z, c]])


def rot(alpha, beta, gamma, device=None) -> torch.Tensor:
    """``rot_z(alpha) @ rot_y(beta) @ rot_z(gamma)``."""
    return rot_z(alpha, device) @ rot_y(beta, device) @ rot_z(gamma, device)
