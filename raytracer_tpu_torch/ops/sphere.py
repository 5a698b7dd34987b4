"""Batched ray–sphere intersection (port of raytracer_tpu/ops/sphere.py).

Same quadratic + near-then-far root selection as the reference
(Core/Sphere.cuh:18-47) over an [N]-ray wavefront × [S] spheres, with
the reference's Interval::outOfInterval semantics (`t < t_min ||
t > t_max` is invalid, Core/Interval.cuh:33-35).
"""

from __future__ import annotations

import numpy as np
import torch

BIG = np.float32(3.0e38)


def intersect_spheres(origins, dirs, centers, radii, t_min, t_max):
    """Closest valid sphere hit per ray: origins/dirs f32[N,3],
    centers f32[S,3], radii f32[S]; t_max scalar or f32[N].
    Returns (t f32[N] (BIG when miss), sphere_id i32[N]).

    The fused path loop (csrc/megakernel.cu, after
    raytracer_tpu/ops/pallas_megakernel.py) tests each root against the
    running best instead of t_max; both select the same closest root,
    so this function serves as its plain version."""
    n = origins.shape[0]
    dev = origins.device
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,))
    ox, oy, oz = origins.unbind(-1)
    dx, dy, dz = dirs.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    t_best = torch.full((n,), float(BIG), dtype=torch.float32, device=dev)
    id_best = torch.zeros((n,), dtype=torch.int32, device=dev)
    for s in range(centers.shape[0]):
        cx, cy, cz = centers[s].unbind(-1)
        r = radii[s]
        ocx = ox - cx
        ocy = oy - cy
        ocz = oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = half_b * half_b - a * c
        ok = disc >= 0.0
        sqrtd = torch.sqrt(torch.clamp_min(disc, 0.0))
        root_near = (-half_b - sqrtd) / a
        root_far = (-half_b + sqrtd) / a
        near_ok = (root_near >= t_min) & (root_near <= t_max)
        far_ok = (root_far >= t_min) & (root_far <= t_max)
        root = torch.where(near_ok, root_near, root_far)
        valid = ok & (near_ok | far_ok)
        t_s = torch.where(valid, root, torch.full_like(root, float(BIG)))
        better = t_s < t_best
        t_best = torch.where(better, t_s, t_best)
        id_best = torch.where(better, torch.full_like(id_best, s), id_best)
    return t_best, id_best
