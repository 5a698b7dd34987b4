"""Batched Möller–Trumbore ray–triangle intersection (port of
raytracer_tpu/ops/triangle.py).

Same algorithm and tolerances as the reference (Core/Mesh.cuh:266-308):
EPSILON=1e-8 determinant cutoff, u/v barycentric rejection. The
component formulas of `moller_trumbore` are the ones the traversal
kernel evaluates (csrc/traverse.cuh `mt_record`), term for term, so the
plain traversal and the kernel round identically.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.utils import vecmath as vm

EPSILON = 1e-8
BIG = np.float32(3.0e38)


def moller_trumbore(o, d, v0, e1, e2):
    """Rays o/d [..., 3] against triangles v0/e1/e2 [..., 3] (broadcast).
    Returns (ok bool[...], t f32[...]) where `ok` holds the determinant
    and barycentric tests; the caller applies its t interval."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    v0x, v0y, v0z = v0.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    ok = torch.abs(a) >= EPSILON
    f = 1.0 / torch.where(ok, a, torch.ones_like(a))
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return ok, t


def face_normal(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Unnormalized geometric normal cross(e1, e2) (Core/Mesh.cuh:303)."""
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    return torch.stack([e1y * e2z - e1z * e2y,
                        e1z * e2x - e1x * e2z,
                        e1x * e2y - e1y * e2x], dim=-1)


def intersect_packed_brute(origins, dirs, tri9, t_min, t_max, chunk: int | None = None):
    """All-pairs closest hit against packed (v0,e1,e2) triangles f32[T,9],
    t accepted on the closed interval [t_min, t_max]. Returns
    (t f32[N] (BIG on miss), slot i32[N]); ties go to the lowest slot.
    Rays are processed `chunk` at a time to bound the [chunk, T]
    temporaries (default: about 2^20 ray-triangle pairs per chunk)."""
    n = origins.shape[0]
    if chunk is None:
        chunk = max(256, (1 << 20) // max(tri9.shape[0], 1))
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=origins.device), (n,))
    v0, e1, e2 = tri9[:, 0:3], tri9[:, 3:6], tri9[:, 6:9]
    t_out = torch.empty((n,), dtype=torch.float32, device=origins.device)
    id_out = torch.empty((n,), dtype=torch.int32, device=origins.device)
    for lo in range(0, n, chunk):
        o = origins[lo:lo + chunk, None, :]
        d = dirs[lo:lo + chunk, None, :]
        ok, t = moller_trumbore(o, d, v0[None], e1[None], e2[None])
        ok = ok & (t >= t_min) & (t <= t_max[lo:lo + chunk, None])
        t_all = torch.where(ok, t, torch.full_like(t, float(BIG)))
        best_t, best_i = torch.min(t_all, dim=1)
        t_out[lo:lo + chunk] = best_t
        id_out[lo:lo + chunk] = best_i.to(torch.int32)
    return t_out, id_out


def intersect_tris_brute(origins, dirs, vertices, faces, t_min, t_max, chunk: int | None = None):
    """All-pairs [N rays × T tris] closest hit over an indexed mesh; use
    only for checks. Returns (t f32[N] (BIG on miss), tri_id i32[N])."""
    faces = faces.long()
    v0 = vertices[faces[:, 0]]
    tri9 = torch.cat([v0, vertices[faces[:, 1]] - v0, vertices[faces[:, 2]] - v0], dim=1)
    return intersect_packed_brute(origins, dirs, tri9, t_min, t_max, chunk)


def intersect_tri_single(origins, dirs, v0, e1, e2, t_min, t_max):
    """Per-ray single-triangle test where each ray has its own triangle
    (v0/e1/e2 are [N,3]): the inner op of the LBVH's leaf step
    (ops/traverse.intersect_bvh), in the JAX function's operation order.
    t is accepted on the closed interval [t_min, t_max].

    Returns (valid bool[N], t f32[N] (BIG where not valid))."""
    h = vm.cross(dirs, e2)
    a = vm.dot(e1, h, keepdims=False)
    ok = torch.abs(a) >= EPSILON
    f = 1.0 / torch.where(ok, a, torch.ones_like(a))
    s = origins - v0
    u = f * vm.dot(s, h, keepdims=False)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    q = vm.cross(s, e1)
    v = f * vm.dot(dirs, q, keepdims=False)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * vm.dot(e2, q, keepdims=False)
    ok = ok & (t >= t_min) & (t <= t_max)
    return ok, torch.where(ok, t, torch.full_like(t, float(BIG)))


def tri_shade(origins, dirs, tri_id, vertices, faces, face_mat, face_uvs=None):
    """Differentiable hit attributes of the chosen triangles: t from the
    (detached) triangle id by the same Möller–Trumbore algebra, so that
    gradients flow to the rays and the vertices; the geometric normal
    flipped to face the ray (Core/Mesh.cuh:303-305); uv the barycentric
    (u, v), or the per-corner OBJ vt interpolated when `face_uvs`
    f32[T,3,2] is given (the texture hook).

    Returns (t f32[N], point f32[N,3], normal f32[N,3], front bool[N],
    mat i32[N], uv f32[N,2])."""
    tid = tri_id.long()
    f3 = faces[tid].long()
    v0 = vertices[f3[:, 0]]
    e1 = vertices[f3[:, 1]] - v0
    e2 = vertices[f3[:, 2]] - v0

    h = vm.cross(dirs, e2)
    a = vm.dot(e1, h, keepdims=False)
    f = 1.0 / torch.where(torch.abs(a) >= EPSILON, a, torch.ones_like(a))
    s = origins - v0
    u = f * vm.dot(s, h, keepdims=False)
    q = vm.cross(s, e1)
    v = f * vm.dot(dirs, q, keepdims=False)
    t = f * vm.dot(e2, q, keepdims=False)

    point = origins + t[:, None] * dirs
    geom_n = vm.normalize(vm.cross(e1, e2), eps=1e-20)
    front = vm.dot(dirs, geom_n, keepdims=False) < 0.0
    normal = torch.where(front[:, None], geom_n, -geom_n)
    if face_uvs is None:
        uv = torch.stack([u, v], dim=-1)
    else:
        c = face_uvs[tid]  # [N,3,2] per-corner vt
        uv = (1.0 - u - v)[:, None] * c[:, 0] + u[:, None] * c[:, 1] + v[:, None] * c[:, 2]
    return t, point, normal, front, face_mat[tid], uv
