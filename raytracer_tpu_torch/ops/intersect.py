"""Scene-level closest-hit queries over the SoA scene (port of
raytracer_tpu/ops/intersect.py).

Spheres are brute-forced; triangles go through the two-level BVH (the
brute pre-pass over the large faces, then the tree through kernel K4
with the coherence sort), or for a scene that holds only the binary
LBVH through its lockstep traversal (ops/traverse.intersect_bvh, plain
PyTorch, as in the JAX package), or for a scene without either an
all-pairs sweep. Closest-hit semantics match the reference: candidates
valid on [t_min, closest so far].

The hit DECISION (which primitive, at what t) is detached: rays and
scene leave the autograd graph before the search. `shade_hit`
recomputes the hit attributes differentiably from the winning ids, so
gradients flow through shading and never through the kernel.

`trace_frame_fused` is the wavefront integrator's forward-only closest
hit: spheres by a select sweep, triangles through K4 (with the brute
pre-pass of K1 inline) in one call, and the material parameters by the
select chain of ops/materials.lookup_params.

On CUDA, K4 runs at every wavefront size: the JAX module's switch to an
XLA traversal below PACKET_MIN_RAYS rays was a TPU cost choice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.ops import materials as mat_ops
from raytracer_tpu_torch.ops.cuda_traverse import intersect_bvh4, trace_closest
from raytracer_tpu_torch.ops.sphere import intersect_spheres, sphere_shade
from raytracer_tpu_torch.ops.traverse import intersect_bvh
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
    elif scene.bvh is not None:
        tt, tid = intersect_bvh(origins, dirs, mesh, scene.bvh, t_min,
                                torch.clamp_max(ts, float(BIG)))
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


class FrameHit(NamedTuple):
    """Closest-hit record of the wavefront's fused route."""

    hit: torch.Tensor         # bool[N]
    point: torch.Tensor       # f32[N,3]
    normal: torch.Tensor      # f32[N,3] front-facing unit normal
    front_face: torch.Tensor  # bool[N]
    params: mat_ops.MatParams  # per lane


def fused_trace_available(scene) -> bool:
    """True when trace_frame_fused applies: a BVH4 with per-face
    materials (K4 returns the winner's material id and normal). A scene
    that holds only the LBVH takes intersect_scene instead."""
    return scene.bvh4 is not None and scene.bvh4.face_mat is not None


def _dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def trace_frame_fused(scene, origins, dirs, t_min, sort: bool = False, active=None) -> FrameHit:
    """Closest hit and per-lane material parameters: spheres by an
    unrolled select sweep, triangles through `trace_closest` (K4 on CUDA
    tensors, its plain version on CPU tensors) with the sphere hit as
    each ray's limit, materials by the select chain. Forward-only.

    `active` (bool[N], optional): lanes whose result is unused this
    bounce get the limit -1, so K4 treats them as dead rays and they
    come back as triangle misses."""
    sph = scene.spheres
    n = origins.shape[0]
    dev = origins.device
    a = _dot3(dirs, dirs)
    t_sph = torch.full((n,), float(BIG), dtype=torch.float32, device=dev)
    c_sel = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    r_sel = torch.ones((n,), dtype=torch.float32, device=dev)
    m_sel = torch.zeros((n,), dtype=torch.int32, device=dev)
    for s in range(sph.count):
        center, radius = sph.center[s], sph.radius[s]
        oc = origins - center
        half_b = _dot3(oc, dirs)
        c = _dot3(oc, oc) - radius * radius
        disc = half_b * half_b - a * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        root_near = (-half_b - sq) / a
        root_far = (-half_b + sq) / a
        near_ok = (root_near >= t_min) & (root_near <= t_sph)
        far_ok = (root_far >= t_min) & (root_far <= t_sph)
        root = torch.where(near_ok, root_near, root_far)
        better = (disc >= 0.0) & (near_ok | far_ok) & (root < t_sph)
        t_sph = torch.where(better, root, t_sph)
        c_sel = torch.where(better[:, None], center, c_sel)
        r_sel = torch.where(better, torch.where(radius != 0.0, radius, 1.0), r_sel)
        m_sel = torch.where(better, sph.mat_id[s], m_sel)

    t_lim = t_sph if active is None else torch.where(active, t_sph, -1.0)
    rec = trace_closest(origins, dirs, scene.bvh4, t_lim, t_min, sort=sort,
                        fields=("t", "mat_id", "normal"))
    tri_wins = rec["t"] < t_sph
    t = torch.where(tri_wins, rec["t"], t_sph)
    hit = t < float(BIG)
    point = origins + t[:, None] * dirs

    outward = (point - c_sel) / r_sel[:, None]
    raw_n = torch.where(tri_wins[:, None], rec["normal"], outward)
    nn = raw_n / torch.sqrt(torch.clamp_min(_dot3(raw_n, raw_n), 1e-24))[:, None]
    front = _dot3(dirs, nn) < 0.0
    n_facing = torch.where(front[:, None], nn, -nn)

    mat_id = torch.where(tri_wins, rec["mat_id"], m_sel)
    params = mat_ops.lookup_params(scene.materials, mat_id)
    return FrameHit(hit=hit, point=point, normal=n_facing, front_face=front, params=params)
