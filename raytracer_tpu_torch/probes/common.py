"""Pieces the probe bodies share: the plain versions' slab test and
Möller–Trumbore record (the scripts' `slab` and `mt_record`, term for term),
the float-to-int conversion of float-encoded ids, and the timing and
counting of kernel launches on the card."""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.probes.v5_tables import BIG

INT_MAX = 2**31 - 1
# fp32 operations (arithmetic and compares, not selects) of one lane,
# counted from the code: a Möller–Trumbore record (`mt_record` here,
# csrc/probe.cuh, csrc/traverse.cuh:62-92) is 55 — hx..hz 9, a 5, the |a|
# test 2, f 2, s 3, u 6 and its tests 2, q 9, v 6 and its tests 3, t 6
# and its tests 2; a slab test (`slab`, traverse.cuh:100-112) is 25 — 6
# sub, 6 mul, 6 min/max of the axis pairs, 3 max for tmin, 3 min for
# tmax, the compare.
MT_OPS, SLAB_OPS = 55, 25


def f2i(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 as JAX's astype and the card's cvt.rzi.s32.f32
    convert: toward zero, saturating at the int32 range, NaN → 0 (torch's
    own conversion is undefined out of range)."""
    i = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    i = torch.where(x >= 2147483648.0, torch.full_like(i, INT_MAX), i)
    return torch.where(torch.isnan(x), torch.zeros_like(i), i)


def slab(b, o, inv, t_best):
    """(hit, tmin) of lanes against one box per chain: b is six [..., 1]
    columns (min xyz, max xyz), o / inv three lane tensors. min/max
    propagate NaN (jnp's and torch's), so a NaN plane distance is a miss."""
    lx, ly, lz, hx, hy, hz = b
    ox, oy, oz = o
    ix, iy, iz = inv
    t0x, t1x = (lx - ox) * ix, (hx - ox) * ix
    t0y, t1y = (ly - oy) * iy, (hy - oy) * iy
    t0z, t1z = (lz - oz) * iz, (hz - oz) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                         torch.maximum(torch.minimum(t0z, t1z), torch.full_like(t0z, 1e-3)))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                         torch.minimum(torch.maximum(t0z, t1z), t_best))
    return tmax > tmin, tmin


def mt_record(fields, prim, o, d, t_best, best):
    """One Möller–Trumbore record (fields: nine [..., 1] columns v0, e1,
    e2) against every lane; a strictly closer hit with t >= 1e-3 updates
    (t_best, best)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = fields
    ox, oy, oz = o
    dx, dy, dz = d
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    ok = a.abs() >= 1e-8
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
    ok = ok & (t >= 1e-3) & (t < t_best)
    return torch.where(ok, t, t_best), torch.where(ok, prim, best)


def rays(o: torch.Tensor, d: torch.Tensor):
    """Lane tensors (o xyz, d xyz, 1/d xyz) of o, d f32[P, 3, 8, 128]."""
    ov, dv = o.unbind(1), d.unbind(1)
    return ov, dv, tuple(1.0 / c for c in dv)


def big_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, float(BIG))


def require_card(what: str) -> None:
    """Entry points measure the card: without one they stop."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: torch.cuda.is_available() is false; this needs a CUDA card")


TIMED_LAUNCHES = 10


def time_launches(fn) -> list[float]:
    """Milliseconds of each of TIMED_LAUNCHES calls of fn after one warm-up
    call, each between its own pair of CUDA events."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(TIMED_LAUNCHES)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in evs]


def median(xs) -> float:
    return float(np.median(xs))
