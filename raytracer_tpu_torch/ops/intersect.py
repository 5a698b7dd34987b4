"""Scene-level closest-hit queries over the SoA scene (port of
raytracer_tpu/ops/intersect.py).

Spheres are brute-forced; triangles go through the two-level BVH (the
brute pre-pass over the large faces, then the tree through kernel K4
with the coherence sort) or, for a scene without one, an all-pairs
sweep. Closest-hit semantics match the reference: candidates valid on
[t_min, closest so far].

The hit DECISION (which primitive, at what t) is detached: rays and
scene leave the autograd graph before the search. `shade_hit`
recomputes the hit attributes differentiably from the winning ids, so
gradients flow through shading and never through the kernel.

On CUDA, K4 runs at every wavefront size: the JAX module's switch to an
XLA traversal below PACKET_MIN_RAYS rays was a TPU cost choice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.ops.cuda_traverse import intersect_bvh4
from raytracer_tpu_torch.ops.sphere import intersect_spheres, sphere_shade
from raytracer_tpu_torch.ops.triangle import (intersect_packed_brute, intersect_tris_brute,
                                              tri_shade)

BIG = np.float32(3.0e38)
PRIM_SPHERE = 0
PRIM_TRI = 1


class HitIds(NamedTuple):
    hit: torch.Tensor        # bool[N]
    t: torch.Tensor          # f32[N] (BIG on miss), detached
    prim_type: torch.Tensor  # i32[N]
    prim_id: torch.Tensor    # i32[N]


class HitAttrs(NamedTuple):
    point: torch.Tensor       # f32[N,3]
    normal: torch.Tensor      # f32[N,3] front-facing
    front_face: torch.Tensor  # bool[N]
    mat_id: torch.Tensor      # i32[N]
    uv: torch.Tensor          # f32[N,2] triangle barycentrics / OBJ vt, sphere lat-lon


def intersect_scene(scene, origins, dirs, t_min) -> HitIds:
    """Closest hit of every ray over spheres and triangles (detached)."""
    origins = origins.detach().contiguous()
    dirs = dirs.detach().contiguous()
    sph, mesh, bvh = scene.spheres, scene.mesh, scene.bvh4
    ts, sid = intersect_spheres(origins, dirs, sph.center.detach(), sph.radius.detach(),
                                t_min, BIG)
    if bvh is not None:
        # Two-level split: brute-test the large triangles first; the
        # primed cap culls most tree traversals (K4 repeats this pre-pass
        # itself — harmless and identical).
        t_cap = ts
        tb = None
        if bvh.brute_tri is not None:
            tb, bslot = intersect_packed_brute(origins, dirs, bvh.brute_tri, t_min, t_cap)
            bprim = bvh.brute_prim[bslot.long()]
            t_cap = torch.minimum(t_cap, tb)
        tt, tid = intersect_bvh4(origins, dirs, bvh, t_min, t_cap)
        if tb is not None:
            brute_wins = tb < tt
            tt = torch.where(brute_wins, tb, tt)
            tid = torch.where(brute_wins, bprim, tid)
    else:
        tt, tid = intersect_tris_brute(origins, dirs, mesh.vertices.detach(), mesh.faces,
                                       t_min, BIG)
    tri_wins = tt < ts
    t = torch.where(tri_wins, tt, ts)
    return HitIds(
        hit=t < float(BIG),
        t=t,
        prim_type=tri_wins.to(torch.int32),
        prim_id=torch.where(tri_wins, tid, sid).to(torch.int32),
    )


def shade_hit(scene, origins, dirs, ids: HitIds) -> HitAttrs:
    """Differentiable hit attributes from detached hit ids."""
    pid = ids.prim_id
    is_tri = ids.prim_type == PRIM_TRI
    sph = scene.spheres

    # Sphere branch: recompute the root differentiably for the chosen
    # sphere (near or far, whichever is closer to the detached t).
    sid = torch.where(is_tri, torch.zeros_like(pid), pid)
    c = sph.center[sid.long()]
    r = sph.radius[sid.long()]
    oc = origins - c
    dx, dy, dz = dirs.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    half_b = oc[:, 0] * dx + oc[:, 1] * dy + oc[:, 2] * dz
    cc = oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1] + oc[:, 2] * oc[:, 2] - r * r
    # Floor at a positive value: miss lanes (disc <= 0) are masked out
    # downstream, but sqrt'(0) = inf would leak NaN into the gradients.
    disc = torch.clamp_min(half_b * half_b - a * cc, 1e-12)
    sq = torch.sqrt(disc)
    t_near = (-half_b - sq) / a
    t_far = (-half_b + sq) / a
    use_near = torch.abs(t_near - ids.t) <= torch.abs(t_far - ids.t)
    t_sph = torch.where(use_near, t_near, t_far)
    sp_point, sp_normal, sp_front, sp_mat, sp_uv = sphere_shade(
        origins, dirs, t_sph, sid, sph.center, sph.radius, sph.mat_id)

    # Triangle branch.
    tid = torch.where(is_tri, pid, torch.zeros_like(pid))
    _, tr_point, tr_normal, tr_front, tr_mat, tr_uv = tri_shade(
        origins, dirs, tid, scene.mesh.vertices, scene.mesh.faces, scene.mesh.face_mat,
        face_uvs=scene.mesh.uvs)

    sel = is_tri[:, None]
    return HitAttrs(
        point=torch.where(sel, tr_point, sp_point),
        normal=torch.where(sel, tr_normal, sp_normal),
        front_face=torch.where(is_tri, tr_front, sp_front),
        mat_id=torch.where(is_tri, tr_mat, sp_mat),
        uv=torch.where(sel, tr_uv, sp_uv),
    )
