"""The reference path tracer for a scene of spheres alone (a
configuration whose "scene" lists no OBJ file): the same semantics as
benchmark/reference/forward.py (thin-lens camera, Russian roulette, the
closest sphere in [t_min, inf), Lambertian, metal, dielectric and
diffuse-light materials, sky on a miss, draws keyed by (pixel, sample,
bounce, purpose)), with no triangle: forward.py's tracer needs one.

The closest sphere is found by testing every sphere with every ray at
once (a ray block against all spheres), each with scene.closest_sphere's
formula: the least root, the lowest index among equal roots, which is
what its loop over the spheres in order keeps. Materials and spheres are
read as benchmark/reference/scene.py reads a configuration's appended
ones, here with no OBJ material before them.
"""

from __future__ import annotations

import torch

from benchmark.reference import ktf
from benchmark.reference.forward import SKY_TOP, _dot, scatter
from benchmark.reference.scene import BIG, DIFFUSE_LIGHT

PAIRS = 1 << 22   # ray-sphere pairs a block of closest_sphere holds


class SphereScene:
    """Tensors of a spheres-only scene on one device in one float type,
    under the names forward.scatter reads."""

    def __init__(self, spec: dict):
        if spec["objs"]:
            raise ValueError("SphereScene takes scenes with no OBJ file")
        self.spec = spec

    def to(self, device, dtype=torch.float32) -> "SphereScene":
        def f(x):
            return torch.tensor(x, dtype=torch.float32).to(device=device, dtype=dtype)

        def i(x):
            return torch.tensor(x, dtype=torch.int64, device=device)

        mats, sph = self.spec["materials"], self.spec["spheres"]
        self.device, self.dtype = torch.device(device), dtype
        self.mat_type = i([m["type"] for m in mats])
        self.albedo = f([m["albedo"] for m in mats])
        self.emission = f([m.get("emission", (0.0, 0.0, 0.0)) for m in mats])
        self.rough = f([m.get("roughness", 0.0) for m in mats])
        self.ior = f([m.get("ior", 1.0) for m in mats])
        self.center = f([s["center"] for s in sph]).reshape(-1, 3)
        self.radius = f([s["radius"] for s in sph])
        self.sph_mat = i([s["material"] for s in sph])
        return self


def closest_sphere(sc: SphereScene, o, d, t_min: float):
    """(t, sphere index) of each ray's closest sphere hit: the near root
    where it lies in [t_min, BIG], else the far one; the lowest index
    among equal roots; BIG and 0 on a miss."""
    n, s = o.shape[0], sc.center.shape[0]
    t_out = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
    id_out = torch.zeros((n,), dtype=torch.int64, device=o.device)
    cx, cy, cz = (sc.center[None, :, k] for k in range(3))
    r = sc.radius[None, :]
    step = max(1, PAIRS // max(s, 1))
    for lo in range(0, n, step):
        sl = slice(lo, lo + step)
        ox, oy, oz = (o[sl, k, None] for k in range(3))
        dx, dy, dz = (d[sl, k, None] for k in range(3))
        a = dx * dx + dy * dy + dz * dz
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
        best = t_s.amin(dim=1)
        first = (t_s == best[:, None]).to(torch.uint8).argmax(dim=1)
        hit = best < BIG
        t_out[sl] = torch.where(hit, best, t_out[sl])
        id_out[sl] = torch.where(hit, first, id_out[sl])
    return t_out, id_out


def trace(sc: SphereScene, cfg: dict, k0, k1, pixel, sample, o, d):
    """Radiance [L,3] of one sample per lane (forward.trace's loop with no
    triangle)."""
    dt = o.dtype
    n = o.shape[0]
    out = torch.zeros((n, 3), dtype=dt, device=o.device)
    tp = torch.ones((n, 3), dtype=dt, device=o.device)
    lanes = torch.arange(n, device=o.device)
    rr_max = torch.tensor(cfg["rr_max_prob"], dtype=torch.float32).to(dt).item()
    for b in range(cfg["max_bounces"]):
        if lanes.numel() == 0:
            break
        pix, smp = pixel[lanes], sample[lanes]
        t_l, o_l, d_l = tp[lanes], o[lanes], d[lanes]
        survived = torch.ones((lanes.numel(),), dtype=torch.bool, device=o.device)
        if b >= cfg["min_bounces"]:
            draws = ktf.Draws(k0, k1, pix, smp, b)
            surv = torch.clamp_max(t_l.amax(dim=1), rr_max)
            survived = ~(draws.uniform(ktf.RR).to(dt) > surv)
            t_l = t_l * torch.where(survived, 1.0 / torch.clamp_min(surv, 1e-12),
                                    torch.ones_like(surv))[:, None]
        live = torch.nonzero(survived).squeeze(1)
        lanes, t_l, o_l, d_l = lanes[live], t_l[live], o_l[live], d_l[live]
        pix, smp = pix[live], smp[live]
        draws = ktf.Draws(k0, k1, pix, smp, b)

        t_hit, sid = closest_sphere(sc, o_l, d_l, cfg["t_min"])
        hit = t_hit < BIG
        p = o_l + t_hit[:, None] * d_l
        rad = sc.radius[sid]
        rn = (p - sc.center[sid]) / torch.where(rad != 0.0, rad, 1.0)[:, None]
        nn = rn * (1.0 / torch.sqrt(torch.clamp_min(
            rn[:, 0] * rn[:, 0] + rn[:, 1] * rn[:, 1] + rn[:, 2] * rn[:, 2], 1e-24)))[:, None]
        dx, dy, dz = d_l.unbind(-1)
        front = _dot(dx, dy, dz, nn[:, 0], nn[:, 1], nn[:, 2]) < 0.0
        nrm = nn * torch.where(front, 1.0, -1.0)[:, None].to(dt)
        mid = sc.sph_mat[sid]
        inv_dl = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
        sx, sy, sz, att, scattered = scatter(sc, mid, dx, dy, dz, *nrm.unbind(-1), front,
                                             inv_dl, draws)

        is_light = hit & (sc.mat_type[mid] == DIFFUSE_LIGHT)
        em = sc.emission[mid] if cfg["emission_quirk"] else t_l * sc.emission[mid]
        sky_t = 0.5 * (dy * inv_dl + 1.0)
        sky = torch.stack([(1.0 - sky_t) + sky_t * c for c in SKY_TOP], dim=-1)
        c = torch.where(is_light[:, None], em, torch.zeros_like(em))
        c = torch.where(~hit[:, None], t_l * sky, c)
        out[lanes] = c
        cont = hit & scattered & (b + 1 < cfg["max_bounces"])
        keep = torch.nonzero(cont).squeeze(1)
        lanes = lanes[keep]
        tp[lanes] = t_l[keep] * att[keep]
        o[lanes] = p[keep]
        d[lanes] = torch.stack([sx, sy, sz], dim=-1)[keep]
    return out


def render_pixels(sc: SphereScene, frame: dict, cfg: dict, seed: int, px, py, spp: int,
                  dtype=torch.float32, block: int = 1 << 18):
    """Mean radiance f32[N,3] over samples 0..spp-1 of pixels (px, py)
    (int tensors on the scene's device, py = 0 the bottom row) under the
    integer seed, as forward.render_pixels gives it."""
    dev = sc.device
    k0, k1 = ktf.key_words(seed)
    w, h = cfg["resolution"]
    n = px.shape[0]
    cam = {k: v.to(dev) for k, v in frame.items()}
    contrib = torch.empty((n, spp, 3), dtype=dtype, device=dev)
    lanes = n * spp
    for lo in range(0, lanes, block):
        idx = torch.arange(lo, min(lo + block, lanes), device=dev)
        p, s = idx // spp, idx % spp
        pixel = (py[p] * w + px[p]).long()
        draws = ktf.Draws(k0, k1, pixel, s, 0)
        lx, ly = draws.disk(ktf.LENS)
        rdx, rdy = cam["lens_radius"] * lx, cam["lens_radius"] * ly
        off = cam["right"] * rdx[:, None] + cam["up"] * rdy[:, None]
        ju, jv = draws.pair(ktf.JITTER)
        u = (px[p].float() + ju) * (1.0 / w)
        v = (py[p].float() + jv) * (1.0 / h)
        o = cam["position"] + off
        d = cam["lower_left"] + u[:, None] * cam["horizontal"] + v[:, None] * cam["vertical"] \
            - cam["position"] - off
        contrib[p, s] = trace(sc, cfg, k0, k1, pixel, s, o.to(dtype), d.to(dtype))
    acc = torch.zeros((n, 3), dtype=dtype, device=dev)
    for s in range(spp):
        acc = acc + contrib[:, s]
    return (acc * (1.0 / spp)).float()
