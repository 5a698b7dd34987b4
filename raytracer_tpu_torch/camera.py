"""Thin-lens FPS camera (port of raytracer_tpu/camera.py).

Same math as the reference (Core/Camera.cuh): a yaw/pitch Euler basis
with the negated-front convention (:159-169), the viewport from
h = tan(fov/2) scaled by the focus distance (:171-181), and thin-lens
rays with a lens-disk offset and jittered (u, v) (:32-44). v = 0 is the
bottom image row. The basis is computed in float32, as JAX computes it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytracer_tpu_torch.scene.types import tensors_to
from raytracer_tpu_torch.utils import vecmath as vm
from raytracer_tpu_torch.utils.rng import as_sampler


def _f32(x) -> torch.Tensor:
    """float32 tensor of x; a tensor keeps its device and its graph."""
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor     # f32[3]
    yaw: torch.Tensor          # f32[] degrees
    pitch: torch.Tensor        # f32[] degrees
    world_up: torch.Tensor     # f32[3]
    fov_degrees: torch.Tensor  # f32[] vertical FOV
    aperture: torch.Tensor     # f32[]
    focus_dist: torch.Tensor   # f32[]
    aspect_ratio: float

    def to(self, device) -> "Camera":
        return tensors_to(self, device)


def showcase_camera(cfg) -> Camera:
    """The headline-benchmark framing just inside the Cornell box's
    opening (the reference's published screenshot pose)."""
    return make_camera(aspect_ratio=cfg.aspect_ratio, fov_degrees=cfg.fov_degrees,
                       aperture=cfg.aperture, position=(0.0, 0.05, 0.29), pitch=-5.0)


def make_camera(
    aspect_ratio: float,
    fov_degrees: float = 80.0,
    position=(0.0, 4.0, 4.0),
    target=(0.0, 0.0, 0.0),
    world_up=(0.0, 1.0, 0.0),
    aperture: float = 1e-6,
    focus_dist: float | None = None,
    yaw: float = -90.0,
    pitch: float = 0.0,
) -> Camera:
    """Defaults reproduce the reference setup (Raytracer.h:77-84,
    EntryPoint.cu:16-20): focus distance |pos-target| (float32 norm),
    yaw -90 / pitch 0 regardless of target.

    Every field may be a tensor that requires grad (camera gradients,
    diff/inverse.py). The focus distance of such a position, or of one
    on the card, is a torch norm, so gradients flow through it as they
    do through the JAX package's traced fallback; a plain CPU position
    keeps the float32 numpy norm the JAX package takes on the host."""
    position = _f32(position)
    if focus_dist is None:
        if position.requires_grad or position.device.type != "cpu":
            target_t = (target.to(position.device, torch.float32) if torch.is_tensor(target)
                        else vm.constant(tuple(float(x) for x in target), position.device))
            focus_dist = torch.linalg.vector_norm(position - target_t)
        else:
            focus_dist = float(np.linalg.norm(position.numpy() - np.asarray(target, np.float32)))
    return Camera(
        position=position,
        yaw=_f32(yaw),
        pitch=_f32(pitch),
        world_up=_f32(world_up),
        fov_degrees=_f32(fov_degrees),
        aperture=_f32(aperture),
        focus_dist=_f32(focus_dist),
        aspect_ratio=float(aspect_ratio),
    )


def camera_basis(cam: Camera) -> dict:
    """Derived frame + viewport (Core/Camera.cuh:159-182), float32 on the
    camera's device: front/right/up, horizontal/vertical viewport
    vectors, lower_left corner and lens_radius."""
    deg = math.pi / 180.0
    cy, sy = torch.cos(cam.yaw * deg), torch.sin(cam.yaw * deg)
    cp, sp = torch.cos(cam.pitch * deg), torch.sin(cam.pitch * deg)
    front = vm.normalize(torch.stack([-cy * cp, -sp, -sy * cp]))
    right = vm.normalize(vm.cross(front, cam.world_up))
    up = vm.normalize(vm.cross(right, front))

    theta = cam.fov_degrees * deg
    h = torch.tan(theta / 2.0)
    viewport_h = 2.0 * h
    viewport_w = cam.aspect_ratio * viewport_h

    horizontal = cam.focus_dist * viewport_w * right
    vertical = cam.focus_dist * viewport_h * up
    lower_left = cam.position - horizontal / 2.0 - vertical / 2.0 - cam.focus_dist * front
    return {
        "front": front,
        "right": right,
        "up": up,
        "horizontal": horizontal,
        "vertical": vertical,
        "lower_left": lower_left,
        "lens_radius": cam.aperture / 2.0,
    }


def generate_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor,
                  width: int, height: int, smp):
    """Batched thin-lens rays (Core/Camera.cuh:32-44) from a sampler
    (utils/ktf.KtfSampler or utils/rng.KeySampler) or raw lane keys
    (k0, k1). Returns (origins f32[N,3], directions f32[N,3]);
    directions are NOT normalized, like the reference."""
    smp = as_sampler(smp)
    dev = px.device
    basis = {k: v.to(dev) for k, v in camera_basis(cam).items()}
    position = cam.position.to(dev)

    dx, dy = smp.lens_disk()
    rd_x = basis["lens_radius"] * dx
    rd_y = basis["lens_radius"] * dy
    offset = basis["right"] * rd_x[:, None] + basis["up"] * rd_y[:, None]

    ju, jv = smp.jitter_uv()
    u = (px.to(torch.float32) + ju) / float(width)
    v = (py.to(torch.float32) + jv) / float(height)

    origins = position + offset
    directions = (
        basis["lower_left"]
        + u[:, None] * basis["horizontal"]
        + v[:, None] * basis["vertical"]
        - position
        - offset
    )
    return origins, directions
