"""Sky, gamma and 8-bit packing (port of raytracer_tpu/ops/tonemap.py).

Matches reference CRTUtility.cuh: γ=2.0 via sqrt (:9-19), clamp
[0, 0.999] ×256 → RGBA8 (:21-32), vertical white→(0.5,0.7,1.0) sky lerp
on the unit direction's y (:34-38).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.utils import vecmath as vm

SKY_TOP = (0.5, 0.7, 1.0)
SKY_BOTTOM = (1.0, 1.0, 1.0)


def sky_color(dirs: torch.Tensor) -> torch.Tensor:
    """Background gradient for miss rays (CRTUtility.cuh:34-38)."""
    unit = vm.normalize(dirs, eps=1e-20)
    t = 0.5 * (unit[..., 1:2] + 1.0)
    top = vm.constant(SKY_TOP, dirs.device)
    bottom = vm.constant(SKY_BOTTOM, dirs.device)
    return (1.0 - t) * bottom + t * top


def linear_to_gamma(c: torch.Tensor) -> torch.Tensor:
    """γ=2.0 (CRTUtility.cuh:9-19); non-positive clamps to 0."""
    return torch.sqrt(torch.clamp_min(c, 0.0))


def to_rgba8(linear_rgb: torch.Tensor) -> torch.Tensor:
    """f32[...,3] linear → u8[...,4] RGBA (CRTUtility.cuh:21-32)."""
    g = torch.clamp(linear_to_gamma(linear_rgb), 0.0, 0.999)
    rgb = (256.0 * g).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)
