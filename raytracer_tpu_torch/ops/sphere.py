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
    # A scalar limit as a fill: a copy from the host cannot be captured
    # into a CUDA graph.
    t_max = (torch.broadcast_to(t_max.to(dev, torch.float32), (n,)) if torch.is_tensor(t_max)
             else torch.full((n,), float(t_max), dtype=torch.float32, device=dev))
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


def closest_sphere_tree(origins, dirs, spheres, tree, t_min, count: bool = False):
    """The fused path loop's sphere search through the sphere tree
    (scene/types.SphereTree; csrc/path.cuh sphere_search), plain: the
    sweep set, then the tree's walk (ops/cuda_traverse.walk_plain)
    limited by its best, each sphere tested with intersect_spheres'
    formula, an equal root going to the lower index, the boxes grown for
    each ray by scene/builder.sphere_growth's margin. Returns (t f32[N]
    (BIG on a miss), sphere id i32[N] (0 then)), intersect_spheres(
    origins, dirs, spheres.center, spheres.radius, t_min, BIG) bit for
    bit; with `count`, also each ray's walk steps and leaf sphere tests
    (i32[N] each), K3-profile's sphere-tree counts."""
    from raytracer_tpu_torch.ops.cuda_traverse import walk_plain

    n = origins.shape[0]
    dev = origins.device
    dx, dy, dz = dirs.unbind(-1)
    a_q = dx * dx + dy * dy + dz * dz
    t_best = torch.full((n,), float(BIG), dtype=torch.float32, device=dev)
    id_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tests = torch.zeros((n,), dtype=torch.int32, device=dev)
    top = torch.iinfo(torch.int32).max

    def test(rays, c, r, ids, valid):
        """Rays [m] against their own spheres c [m, j, 3], r [m, j], ids
        [m, j] (valid [m, j]): the least (root, index) of them and the
        running best, as the kernel's in-order tests leave it."""
        ox, oy, oz = (origins[rays, k, None] for k in range(3))
        dx, dy, dz = (dirs[rays, k, None] for k in range(3))
        a = a_q[rays, None]
        ocx, ocy, ocz = ox - c[..., 0], oy - c[..., 1], oz - c[..., 2]
        half_b = ocx * dx + ocy * dy + ocz * dz
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = half_b * half_b - a * c_q
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        near = (-half_b - sq) / a
        far = (-half_b + sq) / a
        tb = t_best[rays, None]
        near_ok = (near >= t_min) & (near <= tb)
        far_ok = (far >= t_min) & (far <= tb)
        root = torch.where(near_ok, near, far)
        ok = valid & (disc >= 0.0) & (near_ok | far_ok)
        t_all = torch.where(ok, root, torch.full_like(root, float("inf")))
        t_new = t_all.min(dim=1).values
        id_new = torch.where(t_all == t_new[:, None], ids, torch.full_like(ids, top)).min(dim=1).values
        win = (t_new < tb[:, 0]) | ((t_new == tb[:, 0]) & (id_new < id_best[rays]))
        t_best[rays[win]] = t_new[win]
        id_best[rays[win]] = id_new[win]

    everyone = torch.arange(n, device=dev)
    b = tree.sweep.shape[0]
    if b and n:
        sw = tree.sweep.long()
        test(everyone, spheres.center[sw][None].expand(n, b, 3),
             spheres.radius[sw][None].expand(n, b), tree.sweep[None].expand(n, b),
             torch.ones((n, b), dtype=torch.bool, device=dev))
    # Each ray's growth of the walk's boxes, in float32 as the kernel's.
    cx, cy, cz, h, ga, gb, gc = (torch.tensor(v, dtype=torch.float32) for v in tree.grow)
    ex, ey, ez = origins[:, 0] - cx, origins[:, 1] - cy, origins[:, 2] - cz
    reach = torch.sqrt(ex * ex + ey * ey + ez * ez) + h
    grow = (ga * reach + gb) * reach + gc
    slot = torch.arange(8, device=dev)

    def leaf(rays, lo, cnt):
        idx = (lo[:, None] + slot[None, :]).clamp(max=tree.ids.shape[0] - 1)
        rec = tree.sph[idx]
        test(rays, rec[..., 0:3], rec[..., 3], tree.ids[idx], slot[None, :] < cnt[:, None])
        tests[rays] += cnt.to(torch.int32)

    steps = torch.zeros((n,), dtype=torch.int32, device=dev) if count else None
    walk_plain(origins, 1.0 / dirs, tree.bounds, tree.children, tree.stack_depth + 4, t_best,
               everyone, t_min, leaf, steps, grow)
    found = t_best < BIG
    t = torch.where(found, t_best, torch.full_like(t_best, float(BIG)))
    sid = torch.where(found, id_best, torch.zeros_like(id_best))
    return (t, sid, steps, tests) if count else (t, sid)


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
