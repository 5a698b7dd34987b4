"""Batched ray–sphere intersection (port of raytracer_tpu/ops/sphere.py).

Same quadratic + near-then-far root selection as the reference
(Core/Sphere.cuh:18-47) over an [N]-ray wavefront × [S] spheres, with
the reference's Interval::outOfInterval semantics (`t < t_min ||
t > t_max` is invalid, Core/Interval.cuh:33-35).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raytracer_tpu_torch.utils import vecmath as vm

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


def sphere_shade(origins, dirs, t, sphere_id, centers, radii, mat_ids):
    """Differentiable hit attributes of the chosen spheres: point, the
    outward normal flipped to face the ray (Core/HitInfo.cuh:15-18), and
    the latitude/longitude uv. Gradients flow to the rays, t and the
    sphere parameters. Returns (point f32[N,3], normal f32[N,3],
    front_face bool[N], mat i32[N], uv f32[N,2])."""
    sid = sphere_id.long()
    center = centers[sid]
    # The zero-radius sentinel sphere's lanes are masked out downstream,
    # but a 0-divide here would leak NaN through `where`.
    r = radii[sid]
    radius = torch.where(r != 0.0, r, torch.ones_like(r))
    point = origins + t[:, None] * dirs
    outward = (point - center) / radius[:, None]
    front = vm.dot(dirs, outward, keepdims=False) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    ox, oy, oz = outward.unbind(-1)
    theta = torch.arccos(torch.clamp(-oy, -1.0, 1.0))
    phi = torch.atan2(-oz, ox) + math.pi
    uv = torch.stack([phi / (2.0 * math.pi), theta / math.pi], dim=-1)
    return point, normal, front, mat_ids[sid], uv
