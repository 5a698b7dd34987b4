"""Camera motion of the reference's interactive controller (port of
raytracer_tpu/camera_motion.py).

The reference flies the camera with WASD/Space/LCtrl and a right-mouse
drag (Core/Camera.cuh:88-157): 1.0 units/s along ±front, ±right and
±world-up, 0.2°/px mouse sensitivity with both axes inverted and 0.5
exponential smoothing, pitch clamped to ±89°. A headless render has no
event pump, so these are pure functions on a Camera: a scripted motion
sequence reproduces any flight path of the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch.camera import Camera, camera_basis

MOVEMENT_SPEED = 1.0      # Core/Camera.cuh:26
MOUSE_SENSITIVITY = 0.2   # Core/Camera.cuh:27
SMOOTH_FACTOR = 0.5       # Core/Camera.cuh:95
PITCH_LIMIT = 89.0        # Core/Camera.cuh:127


def move(cam: Camera, keys: str, dt: float) -> Camera:
    """One movement tick. `keys` holds the held keys of {w, s, a, d,
    ' ' (space), 'c' (ctrl)}; W moves along -front (the reference's
    inverted convention, Core/Camera.cuh:140-151)."""
    basis = camera_basis(cam)
    v = MOVEMENT_SPEED * dt
    pos = cam.position
    if "w" in keys:
        pos = pos - basis["front"] * v
    if "s" in keys:
        pos = pos + basis["front"] * v
    if "a" in keys:
        pos = pos - basis["right"] * v
    if "d" in keys:
        pos = pos + basis["right"] * v
    if " " in keys:
        pos = pos + cam.world_up * v
    if "c" in keys:
        pos = pos - cam.world_up * v
    return dataclasses.replace(cam, position=pos)


def rotate(cam: Camera, dx_px: float, dy_px: float) -> Camera:
    """A mouse-drag delta in pixels (already smoothed; `MouseSmoother`
    applies the reference's smoothing): both axes inverted, 0.2°/px,
    pitch clamped (Core/Camera.cuh:121-127)."""
    yaw = cam.yaw + (-MOUSE_SENSITIVITY) * dx_px
    pitch = torch.clamp(cam.pitch + (-MOUSE_SENSITIVITY) * dy_px, -PITCH_LIMIT, PITCH_LIMIT)
    return dataclasses.replace(cam, yaw=yaw.to(torch.float32), pitch=pitch.to(torch.float32))


def adjust_focus(cam: Camera, delta: float) -> Camera:
    """PageUp/PageDown focus adjustment, floored at 0.1
    (Core/Camera.cuh:79-83)."""
    fd = torch.clamp_min(cam.focus_dist + delta, 0.1)
    return dataclasses.replace(cam, focus_dist=fd.to(torch.float32))


class MouseSmoother:
    """The reference's 0.5-exponential mouse smoothing
    (Core/Camera.cuh:95-119): feed raw cursor positions, get deltas."""

    def __init__(self):
        self.last = None
        self.smooth = None

    def update(self, x: float, y: float):
        if self.last is None:
            self.last = self.smooth = (x, y)
            return 0.0, 0.0
        sx = self.smooth[0] * (1 - SMOOTH_FACTOR) + x * SMOOTH_FACTOR
        sy = self.smooth[1] * (1 - SMOOTH_FACTOR) + y * SMOOTH_FACTOR
        dx, dy = sx - self.last[0], sy - self.last[1]
        self.last = self.smooth = (sx, sy)
        return dx, dy

    def release(self):
        self.last = self.smooth = None
