"""The reference's scene: meshes, materials and spheres as a
configuration file states them, the camera's frame, and a closest-hit
search of its own (every triangle Moller-Trumbore tested, with a
two-level cull that never changes which triangle wins).

A configuration's "scene" holds `objs` (OBJ files, relative to the
checkout), `materials` (appended after the OBJ files' own) and `spheres`
(each naming one of those appended materials by its index in the list).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark.reference import objload

LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT = (objload.LAMBERTIAN, objload.METAL,
                                                objload.DIELECTRIC, objload.DIFFUSE_LIGHT)
BIG = 3.0e38
MT_EPS = 1e-8
CLUSTER = 128          # triangles a culling box holds
BIG_AREA_RATIO = 100.0  # triangles this many times the median area are tested by every ray


class Scene:
    """Tensors of one scene on one device in one float type."""

    def __init__(self, spec: dict, root: str):
        verts, faces, fmat, mats = objload.load([os.path.join(root, p) for p in spec["objs"]])
        n_obj = len(mats)
        mats = mats + [(m["type"], m["albedo"], m.get("emission", (0.0, 0.0, 0.0)),
                        m.get("roughness", 0.0), m.get("ior", 1.0)) for m in spec["materials"]]
        self.verts = verts
        self.faces = faces
        v0 = verts[faces[:, 0]]
        # Edges in float32, as the scene's vertices are float32.
        tri = np.concatenate([v0, verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0], axis=1)
        self.np_tri = tri.astype(np.float32)
        self.np_tri_mat = fmat.astype(np.int64)
        self.np_mat_type = np.asarray([m[0] for m in mats], np.int64)
        self.np_albedo = np.asarray([m[1] for m in mats], np.float32)
        self.np_emission = np.asarray([m[2] for m in mats], np.float32)
        self.np_rough = np.asarray([m[3] for m in mats], np.float32)
        self.np_ior = np.asarray([m[4] for m in mats], np.float32)
        sph = spec["spheres"]
        self.np_center = np.asarray([s["center"] for s in sph], np.float32).reshape(-1, 3)
        self.np_radius = np.asarray([s["radius"] for s in sph], np.float32)
        self.np_sph_mat = np.asarray([n_obj + s["material"] for s in sph], np.int64)
        self._groups()

    def _groups(self):
        """Split the triangles into those every ray tests (the large ones)
        and clusters of CLUSTER triangles in Morton order, each with a box
        widened outward so that float rounding never culls a hit."""
        tri = self.np_tri.astype(np.float64)
        t = tri.shape[0]
        area = np.linalg.norm(np.cross(tri[:, 3:6], tri[:, 6:9]), axis=1)
        if t <= 4 * CLUSTER:
            self.np_always, rest = np.arange(t), np.arange(0)
        else:
            big = area > BIG_AREA_RATIO * max(float(np.median(area)), 1e-30)
            self.np_always, rest = np.nonzero(big)[0], np.nonzero(~big)[0]
        corners = np.stack([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6], tri[:, 0:3] + tri[:, 6:9]], 1)
        if rest.size:
            cen = corners[rest].mean(axis=1)
            lo, hi = cen.min(axis=0), cen.max(axis=0)
            q = ((cen - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
            code = np.zeros(rest.size, np.int64)
            for bit in range(10):
                for axis in range(3):
                    code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
            rest = rest[np.argsort(code, kind="stable")]
            pad = (-rest.size) % CLUSTER
            members = np.concatenate([rest, np.full(pad, -1)]).reshape(-1, CLUSTER)
            c = corners[np.maximum(members, 0)]                       # [C, K, 3, 3]
            valid = (members >= 0)[..., None, None]
            lo = np.where(valid, c, np.inf).min(axis=(1, 2))
            hi = np.where(valid, c, -np.inf).max(axis=(1, 2))
            margin = 1e-4 * (hi - lo).max(axis=1, keepdims=True) + 1e-6
            self.np_members = members
            self.np_box = np.concatenate([lo - margin, hi + margin], axis=1)
        else:
            self.np_members = np.zeros((0, CLUSTER), np.int64)
            self.np_box = np.zeros((0, 6))

    def to(self, device, dtype=torch.float32) -> "Scene":
        def f(x):
            return torch.as_tensor(x).to(device=device, dtype=dtype)

        def i(x):
            return torch.as_tensor(x, dtype=torch.int64).to(device)

        self.device, self.dtype = torch.device(device), dtype
        self.tri, self.tri_mat = f(self.np_tri), i(self.np_tri_mat)
        self.mat_type, self.albedo, self.emission = (i(self.np_mat_type), f(self.np_albedo),
                                                     f(self.np_emission))
        self.rough, self.ior = f(self.np_rough), f(self.np_ior)
        self.center, self.radius, self.sph_mat = (f(self.np_center), f(self.np_radius),
                                                  i(self.np_sph_mat))
        self.always = i(self.np_always)
        self.members = i(self.np_members)
        # Boxes stay float32 whatever the type: they only cull.
        self.box = torch.as_tensor(self.np_box, dtype=torch.float32).to(device)
        return self


def camera_frame(cam: dict, aspect: float) -> dict:
    """The thin-lens camera's frame (yaw / pitch Euler basis with the
    negated front, viewport from tan(fov / 2) times the focus distance),
    in float32 on the CPU."""
    f32 = torch.float32
    pos = torch.tensor(cam["position"], dtype=f32)
    target = np.asarray(cam.get("target", (0.0, 0.0, 0.0)), np.float32)
    focus = torch.tensor(float(np.linalg.norm(pos.numpy() - target)), dtype=f32)
    deg = math.pi / 180.0
    yaw, pitch = torch.tensor(cam["yaw"], dtype=f32), torch.tensor(cam["pitch"], dtype=f32)
    cy, sy = torch.cos(yaw * deg), torch.sin(yaw * deg)
    cp, sp = torch.cos(pitch * deg), torch.sin(pitch * deg)

    def unit(a):
        return a / torch.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])

    def cross(a, b):
        return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                            a[0] * b[1] - a[1] * b[0]])

    front = unit(torch.stack([-cy * cp, -sp, -sy * cp]))
    right = unit(cross(front, torch.tensor(cam.get("world_up", (0.0, 1.0, 0.0)), dtype=f32)))
    up = unit(cross(right, front))
    h = torch.tan(torch.tensor(cam["fov_degrees"], dtype=f32) * deg / 2.0)
    vh = 2.0 * h
    vw = aspect * vh
    hor = focus * vw * right
    ver = focus * vh * up
    ll = pos - hor / 2.0 - ver / 2.0 - focus * front
    lens = torch.tensor(cam["aperture"], dtype=f32) / 2.0
    return dict(position=pos, right=right, up=up, horizontal=hor, vertical=ver, lower_left=ll,
                lens_radius=lens)


def moller_trumbore(ox, oy, oz, dx, dy, dz, tri):
    """Rays (components broadcast against tri's leading shape) against
    triangle rows tri [..., 9] = v0, e1, e2: (ok, t)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(-1)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    ok = torch.abs(a) >= MT_EPS
    f = 1.0 / torch.where(ok, a, torch.ones_like(a))
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return ok, t


def _best_of(ok, t, t_min, t_lim, ids):
    """Per row, the smallest t in [t_min, t_lim) among `ok` columns and its
    id from `ids` (the lowest on a tie); t_lim and -1 where none."""
    good = ok & (t >= t_min) & (t < t_lim[:, None])
    tt = torch.where(good, t, torch.full_like(t, BIG))
    best, col = tt.min(dim=1)
    found = best < t_lim
    return torch.where(found, best, t_lim), torch.where(found, ids.expand_as(tt).gather(
        1, col[:, None])[:, 0], torch.full_like(col, -1))


def closest_triangle(sc: Scene, o, d, t_lim, t_min: float, block: int = 1 << 15):
    """(t, triangle id) of each ray's closest triangle hit in [t_min,
    t_lim): t_lim and -1 where there is none. `block` rays at a time, or
    more where few triangles are tested by every ray."""
    n = o.shape[0]
    block = max(block, (1 << 24) // max(1, sc.always.shape[0]))
    t_best = t_lim.clone()
    tri_best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    rows = sc.tri[sc.always]
    for lo in range(0, n, block):
        sl = slice(lo, lo + block)
        ok, t = moller_trumbore(*(x[sl, None] for x in o.unbind(-1)),
                                *(x[sl, None] for x in d.unbind(-1)), rows[None])
        t_best[sl], tri_best[sl] = _best_of(ok, t, t_min, t_best[sl], sc.always[None])
    if sc.members.shape[0] == 0 or n == 0:
        return t_best, tri_best
    # Ray against box: slab test in float32 over rays that may still hit.
    of, df = o.float(), d.float()
    inv = 1.0 / torch.where(df.abs() < 1e-30, torch.full_like(df, 1e-30), df)
    pairs = []
    for lo in range(0, n, block):
        t0 = (sc.box[None, :, 0:3] - of[lo:lo + block, None]) * inv[lo:lo + block, None]
        t1 = (sc.box[None, :, 3:6] - of[lo:lo + block, None]) * inv[lo:lo + block, None]
        near = torch.minimum(t0, t1).amax(dim=-1)
        far = torch.maximum(t0, t1).amin(dim=-1)
        r, c = torch.nonzero((far >= near) & (far >= 0.0), as_tuple=True)
        pairs.append((r + lo, c))
    ray = torch.cat([p[0] for p in pairs])
    clu = torch.cat([p[1] for p in pairs])
    step = max(1, (1 << 22) // sc.members.shape[1])
    for lo in range(0, ray.shape[0], step):
        r, c = ray[lo:lo + step], clu[lo:lo + step]
        ids = sc.members[c]
        rows = sc.tri[ids.clamp_min(0)]
        ok, t = moller_trumbore(*(x[r, None] for x in o.unbind(-1)),
                                *(x[r, None] for x in d.unbind(-1)), rows)
        ok = ok & (ids >= 0)
        t_pair, id_pair = _best_of(ok, t, t_min, t_lim[r], ids)
        hit = id_pair >= 0
        r, t_pair, id_pair = r[hit], t_pair[hit], id_pair[hit]
        t_best.scatter_reduce_(0, r, t_pair, reduce="amin")
        win = t_pair == t_best[r]
        tri_best[r[win]] = id_pair[win]   # equal t: any of the tied triangles
    return t_best, tri_best


def closest_sphere(sc: Scene, o, d, t_min: float):
    """(t, sphere index) of each ray's closest sphere hit: the near root
    where it lies in [t_min, BIG], else the far one; BIG and 0 on a miss."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    a = dx * dx + dy * dy + dz * dz
    t_best = torch.full_like(ox, BIG)
    id_best = torch.zeros(ox.shape, dtype=torch.int64, device=o.device)
    for s in range(sc.center.shape[0]):
        cx, cy, cz = sc.center[s].unbind(-1)
        r = sc.radius[s]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = half_b * half_b - a * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        near = (-half_b - sq) / a
        far = (-half_b + sq) / a
        near_ok = (near >= t_min) & (near <= BIG)
        far_ok = (far >= t_min) & (far <= BIG)
        root = torch.where(near_ok, near, far)
        t_s = torch.where((disc >= 0.0) & (near_ok | far_ok), root, torch.full_like(root, BIG))
        better = t_s < t_best
        t_best = torch.where(better, t_s, t_best)
        id_best = torch.where(better, torch.full_like(id_best, s), id_best)
    return t_best, id_best
