"""The reference path tracer, forward only: the mean radiance of pixels
over their samples, every path traced to its end on its own.

Semantics (the CUDA RayTracer's `rayColor`, CUDAKernels.h:102-145, as the
system under test states them): a thin-lens camera ray per sample with
jitter and lens draws at bounce 0; from bounce `min_bounces` on, Russian
roulette with survival min(max RGB of the throughput, rr_max_prob) and
the survivors' throughput divided by it; the closest hit over spheres and
triangles in [t_min, inf); Lambertian, metal, dielectric (Schlick) and
diffuse-light materials; a light adds its emission (unattenuated with the
emission quirk, else times the throughput) and ends the path; a miss adds
throughput times the sky; a path that reaches max_bounces adds nothing.
Every draw is keyed by (pixel, sample, bounce, purpose) (reference/ktf).
A sample's radiance is added to its pixel's sum in sample order.

`dtype` is the float type of all geometry and shading: float32 is the
reference; a lower one is the control that has to fail the comparison.
"""

from __future__ import annotations

import torch

from benchmark.reference import ktf
from benchmark.reference.scene import (BIG, DIELECTRIC, DIFFUSE_LIGHT, LAMBERTIAN, METAL,
                                       Scene, closest_sphere, closest_triangle)

SKY_TOP = (0.5, 0.7, 1.0)
NEAR_ZERO = 1e-8


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def scatter(sc: Scene, mid, dx, dy, dz, nx, ny, nz, front, inv_dl, draws):
    """(direction components, attenuation [N,3], scattered) of the
    material `mid` at a hit with front-facing unit normal n, incoming
    direction d (1 / |d| = inv_dl)."""
    ux, uy, uz = draws.unit_vector(ktf.SCATTER)
    ux, uy, uz = (x.to(dx.dtype) for x in (ux, uy, uz))
    u_die = draws.uniform(ktf.DIELECTRIC).to(dx.dtype)
    kind = sc.mat_type[mid]
    rough, ior = sc.rough[mid], sc.ior[mid]

    lx, ly, lz = nx + ux, ny + uy, nz + uz
    degenerate = (lx.abs() < NEAR_ZERO) & (ly.abs() < NEAR_ZERO) & (lz.abs() < NEAR_ZERO)
    lx, ly, lz = (torch.where(degenerate, n, l) for n, l in ((nx, lx), (ny, ly), (nz, lz)))

    dn = _dot(dx, dy, dz, nx, ny, nz)
    rx, ry, rz = dx - 2.0 * dn * nx, dy - 2.0 * dn * ny, dz - 2.0 * dn * nz
    inv_rl = 1.0 / torch.sqrt(torch.clamp_min(rx * rx + ry * ry + rz * rz, 1e-40))
    mx, my, mz = rx * inv_rl + rough * ux, ry * inv_rl + rough * uy, rz * inv_rl + rough * uz
    metal_ok = _dot(mx, my, mz, nx, ny, nz) > 0.0

    ri = torch.where(front, 1.0 / ior, ior)
    ix, iy, iz = dx * inv_dl, dy * inv_dl, dz * inv_dl
    cos_t = torch.clamp_max(-_dot(ix, iy, iz, nx, ny, nz), 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = (ri * sin_t) > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    reflect = cannot | ((r0 + (1.0 - r0) * omc2 * omc2 * omc) > u_die)
    idn = _dot(ix, iy, iz, nx, ny, nz)
    px_, py_, pz_ = ri * (ix + cos_t * nx), ri * (iy + cos_t * ny), ri * (iz + cos_t * nz)
    par = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - (px_ * px_ + py_ * py_ + pz_ * pz_)), 1e-12))
    gx = torch.where(reflect, ix - 2.0 * idn * nx, px_ + par * nx)
    gy = torch.where(reflect, iy - 2.0 * idn * ny, py_ + par * ny)
    gz = torch.where(reflect, iz - 2.0 * idn * nz, pz_ + par * nz)

    is_metal, is_die = kind == METAL, kind == DIELECTRIC
    ox = torch.where(is_die, gx, torch.where(is_metal, mx, lx))
    oy = torch.where(is_die, gy, torch.where(is_metal, my, ly))
    oz = torch.where(is_die, gz, torch.where(is_metal, mz, lz))
    att = torch.where(is_die[:, None], torch.ones_like(sc.albedo[mid]), sc.albedo[mid])
    scattered = (kind == LAMBERTIAN) | (is_metal & metal_ok) | is_die
    return ox, oy, oz, att, scattered


def trace(sc: Scene, cfg: dict, k0, k1, pixel, sample, o, d):
    """Radiance [L,3] of one sample per lane: lanes start at rays (o, d)
    with draws keyed by (pixel, sample)."""
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
        kk0 = k0[lanes] if torch.is_tensor(k0) and k0.dim() else k0
        kk1 = k1[lanes] if torch.is_tensor(k1) and k1.dim() else k1
        draws = ktf.Draws(kk0, kk1, pix, smp, b)
        t_l, o_l, d_l = tp[lanes], o[lanes], d[lanes]
        survived = torch.ones((lanes.numel(),), dtype=torch.bool, device=o.device)
        if b >= cfg["min_bounces"]:
            surv = torch.clamp_max(t_l.amax(dim=1), rr_max)
            survived = ~(draws.uniform(ktf.RR).to(dt) > surv)
            t_l = t_l * torch.where(survived, 1.0 / torch.clamp_min(surv, 1e-12),
                                    torch.ones_like(surv))[:, None]
        live = torch.nonzero(survived).squeeze(1)
        lanes, t_l, o_l, d_l = lanes[live], t_l[live], o_l[live], d_l[live]
        pix, smp = pix[live], smp[live]
        draws = ktf.Draws(kk0[live] if torch.is_tensor(kk0) and kk0.dim() else kk0,
                          kk1[live] if torch.is_tensor(kk1) and kk1.dim() else kk1, pix, smp, b)

        t_sph, sid = closest_sphere(sc, o_l, d_l, cfg["t_min"])
        t_tri, tid = closest_triangle(sc, o_l, d_l, t_sph, cfg["t_min"])
        tri_wins = tid >= 0
        t_hit = torch.where(tri_wins, t_tri, t_sph)
        hit = t_hit < BIG
        p = o_l + t_hit[:, None] * d_l
        rows = sc.tri[tid.clamp_min(0)]
        e1, e2 = rows[:, 3:6], rows[:, 6:9]
        ng = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                          e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                          e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=-1)
        rad = sc.radius[sid]
        rn = torch.where(tri_wins[:, None], ng,
                         (p - sc.center[sid]) / torch.where(rad != 0.0, rad, 1.0)[:, None])
        nn = rn * (1.0 / torch.sqrt(torch.clamp_min(
            rn[:, 0] * rn[:, 0] + rn[:, 1] * rn[:, 1] + rn[:, 2] * rn[:, 2], 1e-24)))[:, None]
        dx, dy, dz = d_l.unbind(-1)
        front = _dot(dx, dy, dz, nn[:, 0], nn[:, 1], nn[:, 2]) < 0.0
        nrm = nn * torch.where(front, 1.0, -1.0)[:, None].to(dt)
        mid = torch.where(tri_wins, sc.tri_mat[tid.clamp_min(0)], sc.sph_mat[sid])
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
    # A lane still live after the last bounce adds nothing: its `out` was
    # set to 0 at that bounce (neither light nor miss).
    return out


def render_pixels(sc: Scene, frame: dict, cfg: dict, seed: int, px, py, spp: int,
                  dtype=torch.float32, block: int = 1 << 18):
    """Mean radiance f32[N,3] over samples 0..spp-1 of pixels (px, py)
    (int tensors on the scene's device, py = 0 the bottom row) under the
    integer seed."""
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
