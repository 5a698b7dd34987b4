"""Batched 3-vector math over trailing-axis-3 tensors (port of
raytracer_tpu/utils/vecmath.py).

Sums over the 3 components are written out as (x + y) + z so that every
backend rounds them in the same order.
"""

from __future__ import annotations

import torch

EPS_NEAR_ZERO = 1e-8  # reference Vec3::nearZero threshold (Core/Vec3.cuh)

_CONSTANTS: dict = {}


def constant(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype, device=device), made once per
    (values, dtype, device) and kept: a copy from the host on every call
    cannot be captured into a CUDA graph. Read it, never write to it."""
    key = (tuple(values), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return t


def dot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    p = a * b
    s = p[..., 0] + p[..., 1] + p[..., 2]
    return s[..., None] if keepdims else s


def length_squared(a: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return dot(a, a, keepdims=keepdims)


def length(a: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return torch.sqrt(length_squared(a, keepdims=keepdims))


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit vector (reference unitVector, Core/Vec3.cuh:213-216); `eps`
    floors the squared norm."""
    if eps:
        n = torch.sqrt(torch.clamp_min(length_squared(a), eps * eps))
    else:
        n = length(a)
    return a / n


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (reference Core/Vec3.cuh:225-228)."""
    return v - 2.0 * dot(v, n) * n


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """[..., 1] mask: all components below EPS_NEAR_ZERO in magnitude."""
    return (torch.abs(v) < EPS_NEAR_ZERO).all(dim=-1, keepdim=True)
