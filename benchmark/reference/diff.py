"""The reference of inverse rendering: a differentiable path tracer, its
loss against target images and Adam, in plain PyTorch autograd.

The estimator is the one the system under test states for its
differentiable path: the closest hit is searched on detached rays and
scene; the hit's point and normal are then computed again from the
winning primitive with gradients (so gradients flow through shading,
the sampled directions and the camera, never through the search);
Russian roulette from bounce min_bounces with survival min(max RGB of
the throughput, rr_max_prob), its division differentiable; with
`edge_aware_lights`, a value-zero term (soft - soft.detach()) x
throughput x emission of a sigmoid-smoothed indicator of the emitter's
fitted rectangle gives directions a gradient through the light's edge.
Parameters: material albedo and roughness clipped to [0, 1], emission
to >= 0, ior to [1, 3], and the camera's position, yaw and pitch.

The loss of K matched (key, target) pairs is the mean over pairs of the
mean over pixels of the squared error / 3; its gradient is taken pair by
pair, one autograd graph each.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import ktf
from benchmark.reference.scene import (BIG, DIELECTRIC, DIFFUSE_LIGHT, LAMBERTIAN, METAL,
                                       MT_EPS, Scene, closest_sphere, closest_triangle)

SKY_TOP = (0.5, 0.7, 1.0)


def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _unit(a, eps: float = 0.0):
    sq = _dot(a, a)[..., None]
    return a / torch.sqrt(torch.clamp_min(sq, eps * eps) if eps else sq)


def light_rect(sc: Scene):
    """The emitter's rectangle: centre, normal, axes and half extents of
    the mesh faces whose material is a light (all on one plane), fitted
    in float64; None without one."""
    light = sc.np_mat_type[sc.np_tri_mat] == DIFFUSE_LIGHT
    if not light.any():
        return None
    ids = np.nonzero(light)[0]
    f = sc.faces[ids]
    pts = sc.verts[f].reshape(-1, 3).astype(np.float64)
    centre = pts.mean(axis=0)
    f0 = sc.faces[ids[0]]
    v = sc.verts
    n = np.cross(v[f0[1]] - v[f0[0]], v[f0[2]] - v[f0[0]])
    n = n / max(np.linalg.norm(n), 1e-12)
    d = pts - centre
    if np.abs(d @ n).max() > 1e-3 * max(float(np.linalg.norm(d, axis=1).max()), 1e-12):
        return None
    d = d - np.outer(d @ n, n)
    _, vec = np.linalg.eigh(d.T @ d)
    u = vec[:, -1] / max(np.linalg.norm(vec[:, -1]), 1e-12)
    w = np.cross(n, u)
    return dict(centre=centre, normal=n, u=u, v=w, hu=float(np.abs(d @ u).max()),
                hv=float(np.abs(d @ w).max()), mat=int(sc.np_tri_mat[ids[0]]))


def camera_rays(cam: dict, aspect: float, params: dict, px, py, w: int, h: int, draws):
    """Differentiable thin-lens rays: the base camera `cam` (its focus
    distance and fov) posed by params' cam_position, cam_yaw, cam_pitch."""
    dev = px.device
    pos = params["cam_position"]
    deg = math.pi / 180.0
    cy, sy = torch.cos(params["cam_yaw"] * deg), torch.sin(params["cam_yaw"] * deg)
    cp, sp = torch.cos(params["cam_pitch"] * deg), torch.sin(params["cam_pitch"] * deg)
    front = _unit(torch.stack([-cy * cp, -sp, -sy * cp]))
    up_w = torch.tensor(cam.get("world_up", (0.0, 1.0, 0.0)), dtype=pos.dtype, device=dev)
    right = _unit(_cross(front, up_w))
    up = _unit(_cross(right, front))
    target = np.asarray(cam.get("target", (0.0, 0.0, 0.0)), np.float32)
    focus = float(np.float32(np.linalg.norm(np.asarray(cam["position"], np.float32) - target)))
    hh = torch.tan(torch.tensor(cam["fov_degrees"], dtype=torch.float32, device=dev) * deg / 2.0)
    vh = 2.0 * hh
    vw = aspect * vh
    hor = focus * vw * right
    ver = focus * vh * up
    ll = pos - hor / 2.0 - ver / 2.0 - focus * front
    lens = float(np.float32(cam["aperture"]) / np.float32(2.0))
    lx, ly = draws.disk(ktf.LENS)
    off = right * (lens * lx)[:, None] + up * (lens * ly)[:, None]
    ju, jv = draws.pair(ktf.JITTER)
    u = (px.float() + ju) / float(w)
    v = (py.float() + jv) / float(h)
    return pos + off, ll + u[:, None] * hor + v[:, None] * ver - pos - off


def _lookup(values: torch.Tensor, mid: torch.Tensor, fill: float):
    """values[mid] by a select per material (its gradient a reduction per
    row, as a gather's would be, in another order)."""
    out = torch.full(mid.shape + values.shape[1:], fill, dtype=values.dtype, device=mid.device)
    for r in range(values.shape[0]):
        sel = (mid == r).reshape(mid.shape + (1,) * (values.dim() - 1))
        out = torch.where(sel, values[r], out)
    return out


def _refract(uv, n, eta):
    cos_t = torch.clamp_max(_dot(-uv, n)[..., None], 1.0)
    perp = eta * (uv + cos_t * n)
    par = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - _dot(perp, perp)[..., None]), 1e-12)) * n
    return perp + par


def _shade(sc: Scene, mats: dict, o, d, sid, tid, t_det):
    """Differentiable point, front-facing normal, front flag and material
    of each ray's detached winner (sphere sid where tid < 0)."""
    is_tri = tid >= 0
    c, r = sc.center[sid], sc.radius[sid]
    oc = o - c
    a = _dot(d, d)
    half_b = _dot(oc, d)
    cc = _dot(oc, oc) - r * r
    sq = torch.sqrt(torch.clamp_min(half_b * half_b - a * cc, 1e-12))
    t_near, t_far = (-half_b - sq) / a, (-half_b + sq) / a
    t_s = torch.where(torch.abs(t_near - t_det) <= torch.abs(t_far - t_det), t_near, t_far)
    p_s = o + t_s[:, None] * d
    out = (p_s - c) / torch.where(r != 0.0, r, torch.ones_like(r))[:, None]
    front_s = _dot(d, out) < 0.0
    n_s = torch.where(front_s[:, None], out, -out)

    rows = sc.tri[tid.clamp_min(0)]
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    hv = _cross(d, e2)
    det = _dot(e1, hv)
    f = 1.0 / torch.where(torch.abs(det) >= MT_EPS, det, torch.ones_like(det))
    q = _cross(o - v0, e1)
    t_t = f * _dot(e2, q)
    p_t = o + t_t[:, None] * d
    g = _unit(_cross(e1, e2), 1e-20)
    front_t = _dot(d, g) < 0.0
    n_t = torch.where(front_t[:, None], g, -g)

    sel = is_tri[:, None]
    mid = torch.where(is_tri, sc.tri_mat[tid.clamp_min(0)], sc.sph_mat[sid])
    return (torch.where(sel, p_t, p_s), torch.where(sel, n_t, n_s),
            torch.where(is_tri, front_t, front_s), mid)


def _scatter(sc: Scene, mats: dict, d, n, front, mid, draws):
    kind = _lookup(sc.mat_type, mid, 0)
    albedo = _lookup(mats["albedo"], mid, 0.0)
    rough = _lookup(mats["roughness"], mid, 0.0)[:, None]
    ior = _lookup(mats["ior"], mid, 1.0)
    emission = _lookup(mats["emission"], mid, 0.0)
    uvec = torch.stack(draws.unit_vector(ktf.SCATTER), dim=-1)
    u_die = draws.uniform(ktf.DIELECTRIC)

    lam = n + uvec
    lam = torch.where((torch.abs(lam) < 1e-8).all(dim=-1, keepdim=True), n, lam)
    refl = _unit(d - 2.0 * _dot(d, n)[:, None] * n, 1e-20) + rough * uvec
    metal_ok = _dot(refl, n) > 0.0
    ri = torch.where(front, 1.0 / ior, ior)[:, None]
    ui = _unit(d)
    cos_t = torch.clamp_max(_dot(-ui, n)[:, None], 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    r0 = torch.square((1.0 - ri) / (1.0 + ri))
    schlick = r0 + (1.0 - r0) * torch.pow(1.0 - cos_t, 5.0)
    reflect = ((ri * sin_t) > 1.0) | (schlick > u_die[:, None])
    die = torch.where(reflect, ui - 2.0 * _dot(ui, n)[:, None] * n, _refract(ui, n, ri))
    is_metal, is_die = (kind == METAL)[:, None], (kind == DIELECTRIC)[:, None]
    direction = torch.where(is_die, die, torch.where(is_metal, refl, lam))
    att = torch.where(is_die, torch.ones_like(albedo), albedo)
    scattered = (kind == LAMBERTIAN) | ((kind == METAL) & metal_ok) | (kind == DIELECTRIC)
    is_light = kind == DIFFUSE_LIGHT
    return direction, att, scattered, is_light, torch.where(is_light[:, None], emission,
                                                            torch.zeros_like(emission))


def _edge_term(rect, mats, cfg, o, d, tp, t_det, alive):
    dev, dt = o.device, o.dtype
    centre, nrm, ua, va = (torch.tensor(rect[k], dtype=dt, device=dev)
                           for k in ("centre", "normal", "u", "v"))
    hu, hv = (torch.tensor(rect[k], dtype=dt, device=dev) for k in ("hu", "hv"))
    denom = _dot(d, nrm)
    bad = torch.abs(denom) < 1e-6
    t_pl = _dot(centre - o, nrm) / torch.where(bad, torch.ones_like(denom), denom)
    p = o + t_pl[:, None] * d
    du, dv = _dot(p - centre, ua), _dot(p - centre, va)
    bw = cfg["edge_bandwidth"] * torch.minimum(hu, hv)
    soft = torch.sigmoid((hu - torch.abs(du)) / bw) * torch.sigmoid((hv - torch.abs(dv)) / bw)
    gate = alive & ~bad & (t_pl > cfg["t_min"]) & (t_pl <= t_det * 1.02)
    soft = torch.where(gate, soft, torch.zeros_like(soft))
    weight = tp.detach() * mats["emission"][rect["mat"]].detach()[None, :]
    return (soft - soft.detach())[:, None] * weight


def trace(sc: Scene, mats: dict, rect, cfg: dict, k0, k1, pixel, sample, o, d):
    """Radiance [L,3] of one sample per lane, differentiable in `mats`,
    the rays and through them the camera."""
    n, dev = o.shape[0], o.device
    tp = torch.ones((n, 3), dtype=o.dtype, device=dev)
    rad = torch.zeros((n, 3), dtype=o.dtype, device=dev)
    edge = torch.zeros((n, 3), dtype=o.dtype, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    for b in range(cfg["max_bounces"]):
        draws = ktf.Draws(k0, k1, pixel, sample, b)
        if b >= cfg["min_bounces"]:
            surv = torch.clamp_max(torch.amax(tp, dim=-1), cfg["rr_max_prob"])
            alive = alive & ~(draws.uniform(ktf.RR).to(o.dtype) > surv)
            tp = tp * torch.where(alive, 1.0 / torch.clamp_min(surv, 1e-12),
                                  torch.ones_like(surv))[:, None]
        od, dd = o.detach(), d.detach()
        t_sph, sid = closest_sphere(sc, od, dd, cfg["t_min"])
        t_tri, tid = closest_triangle(sc, od, dd, t_sph, cfg["t_min"])
        t_det = torch.where(tid >= 0, t_tri, t_sph)
        ray_hit = t_det < BIG
        if rect is not None and cfg.get("edge_aware_lights"):
            edge = edge + _edge_term(rect, mats, cfg, o, d, tp, t_det, alive)
        p, nrm, front, mid = _shade(sc, mats, o, d, sid, tid, t_det)
        direction, att, scattered, is_light, em = _scatter(sc, mats, d, nrm, front, mid, draws)
        hit = ray_hit & alive
        emitted = em if cfg["emission_quirk"] else tp * em
        rad = torch.where((hit & is_light)[:, None], emitted, rad)
        sky_t = 0.5 * (_unit(d, 1e-20)[:, 1:2] + 1.0)
        sky = torch.cat([(1.0 - sky_t) * 1.0 + sky_t * c for c in SKY_TOP], dim=-1)
        rad = torch.where((alive & ~ray_hit)[:, None], tp * sky, rad)
        cont = (hit & scattered)[:, None]
        tp = torch.where(cont, tp * att, tp)
        o = torch.where(cont, p, o)
        d = torch.where(cont, direction, d)
        alive = cont[:, 0]
    return rad + edge if rect is not None and cfg.get("edge_aware_lights") else rad


def _mats(sc: Scene, params: dict) -> dict:
    def lo(x, v):
        return torch.maximum(x, torch.full_like(x, v))

    def hi(x, v):
        return torch.minimum(x, torch.full_like(x, v))

    return dict(albedo=hi(lo(params["albedo"], 0.0), 1.0),
                roughness=hi(lo(params["roughness"], 0.0), 1.0),
                emission=lo(params["emission"], 0.0), ior=hi(lo(params["ior"], 1.0), 3.0))


class Problem:
    """An inverse-rendering job: scene, base camera, render settings, pair
    keys (k0, k1 int lists), on one device. Pairs are traced `group` at a
    time, in one graph."""

    def __init__(self, sc: Scene, cam: dict, cfg: dict, keys, group: int = 4):
        self.sc, self.cam, self.cfg = sc, cam, cfg
        self.w, self.h = cfg["resolution"]
        dev = sc.device
        self.k0 = torch.tensor(keys[0], dtype=torch.int64, device=dev)
        self.k1 = torch.tensor(keys[1], dtype=torch.int64, device=dev)
        self.group = group
        self.rect = light_rect(sc)
        flat = torch.arange(self.w * self.h, device=dev)
        # Image row 0 is the top: pixel (c, H - 1 - r).
        self.px, self.py = flat % self.w, self.h - 1 - flat // self.w

    def radiance(self, params: dict, pairs: list, spp: int):
        """Radiance [G * spp * n, 3] of the lanes of `pairs`: pair-major,
        then sample, then pixel."""
        n, dev = self.px.shape[0], self.px.device
        idx = torch.arange(len(pairs) * spp * n, device=dev)
        g, s, p = idx // (spp * n), (idx // n) % spp, idx % n
        pair = torch.tensor(pairs, dtype=torch.int64, device=dev)[g]
        k0, k1 = self.k0[pair], self.k1[pair]
        px, py = self.px[p], self.py[p]
        pixel = py * self.w + px
        draws = ktf.Draws(k0, k1, pixel, s, 0)
        o, d = camera_rays(self.cam, self.w / self.h, params, px, py, self.w, self.h, draws)
        return trace(self.sc, _mats(self.sc, params), self.rect, self.cfg, k0, k1, pixel, s,
                     o, d).float()

    def means(self, params: dict, pairs: list, spp: int) -> torch.Tensor:
        """Mean radiance [G, H*W, 3] of the pairs' images."""
        n = self.px.shape[0]
        rad = self.radiance(params, pairs, spp)
        return rad.reshape(len(pairs), spp, n, 3).sum(dim=1) / float(spp)

    def groups(self, k: int):
        return [list(range(i, min(i + self.group, k))) for i in range(0, k, self.group)]

    def images(self, params: dict, k: int, spp: int) -> list:
        with torch.no_grad():
            return [img for js in self.groups(k) for img in self.means(params, js, spp)]

    def loss_and_grad(self, params: dict, targets: list, spp: int):
        """(loss, {field: gradient}) of the mean over pairs of the mean
        squared error / 3 against targets [H*W, 3] per pair."""
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        k = len(targets)
        loss = 0.0
        for js in self.groups(k):
            err = self.means(leaves, js, spp) - torch.stack([targets[j] for j in js])
            part = (err * err).sum(dim=2).mean(dim=1).sum() / 3.0 / k
            loss += float(part.detach())
            g = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
            for name, gi in zip(leaves, g):
                if gi is not None:
                    grads[name] += gi
        return loss, grads


def cosine_lr(lr0: float, total: int, lr_min_frac: float):
    f32 = np.float32

    def fn(step):
        t = np.minimum(f32(step), f32(total)) / f32(total)
        return float(f32(lr0) * (f32(lr_min_frac) + f32(1.0 - lr_min_frac) * f32(0.5)
                                 * (f32(1.0) + np.cos(f32(np.pi) * t))))

    return fn


def adam(params, grads, mu, nu, step: int, lr: float, scales: dict, b1=0.9, b2=0.999,
         eps=1e-8):
    """One Adam update (step counts from 1): new params, mu, nu."""
    t = np.float32(step)
    c1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
    c2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
    out, m2, v2 = {}, {}, {}
    for k in params:
        m2[k] = b1 * mu[k] + (1 - b1) * grads[k]
        v2[k] = b2 * nu[k] + (1 - b2) * grads[k] * grads[k]
        lr_k = float(np.float32(lr) * np.float32(scales.get(k, 1.0)))
        out[k] = params[k] - lr_k * (m2[k] / c1) / (torch.sqrt(v2[k] / c2) + eps)
    return out, m2, v2
