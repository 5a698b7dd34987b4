"""Vectorized material scatter for the four reference materials (port of
raytracer_tpu/ops/materials.py).

A branch-free select over the material type tag: every scatter
candidate is computed for every lane with shared random draws and the
winner is picked with `where` (Core/Material.cuh:49-150):
  * Lambertian (:66-77): dir = normal + unit_vector, degenerate → normal.
  * Metal (:89-96): normalize(reflect(d, n)) + roughness·unit_vector;
    absorbed if the scattered dir leaves the hemisphere.
  * Dielectric (:109-137): attenuation 1, IOR ratio by face side, total
    internal reflection, probabilistic Schlick reflect.
  * DiffuseLight (:139-150): never scatters; emits.

`scatter` (lookup + `scatter_params`) is the JAX module's formulation,
which the differentiable path runs: differentiable in albedo, roughness
and emission (through the sampled directions) and in IOR (through the
refracted direction); the discrete reflect/refract pick is a bool mask,
so it carries no gradient, as JAX's stop_gradient makes it. The NaN
guards of the JAX module stay: the 1e-20 floor in the metal normalize,
the 1e-12 floor under the refraction sqrt, and the `where` before each
divide. `scatter_fused` is the fused path-loop kernel's own
restatement of the same formulas (raytracer_tpu/ops/pallas_megakernel.py
post_trav: reciprocal-multiply normalisation, Schlick by products); the
plain path loop uses it so that it rounds like csrc/megakernel.cu.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.scene.types import DIELECTRIC, DIFFUSE_LIGHT, LAMBERTIAN, METAL
from raytracer_tpu_torch.utils import vecmath as vm
from raytracer_tpu_torch.utils.rng import as_sampler

EPS_SQ_1E20 = float(np.float32(1e-20) * np.float32(1e-20))  # f32 product, as the kernel


class ScatterResult(NamedTuple):
    direction: torch.Tensor    # f32[N,3] next ray direction
    attenuation: torch.Tensor  # f32[N,3]
    scattered: torch.Tensor    # bool[N] — False = absorbed or light
    is_light: torch.Tensor     # bool[N]
    emission: torch.Tensor     # f32[N,3]


class MatParams(NamedTuple):
    """Per-lane material parameters (already looked up)."""

    mtype: torch.Tensor      # i32[N]
    albedo: torch.Tensor     # f32[N,3]
    emission: torch.Tensor   # f32[N,3]
    roughness: torch.Tensor  # f32[N]
    ior: torch.Tensor        # f32[N]


# Tables up to this many rows are read with an unrolled select per row,
# as in the JAX module. On the card this also keeps the backward pass
# cheap: a gather's gradient is an index_put that funnels every lane into
# a handful of rows (it took 96% of a training step's device time), a
# select's is one reduction per row.
SELECT_TABLE_MAX = 24


def lookup_params(materials, mat_id: torch.Tensor) -> MatParams:
    """Gather per-lane parameters; an id outside the table gives the
    select chain's defaults (type 0, zero albedo/emission/roughness,
    ior 1), as in the JAX module and the kernel."""
    m = materials.count
    dev = mat_id.device
    if m <= SELECT_TABLE_MAX:
        n = mat_id.shape[0]
        mtype = torch.zeros((n,), dtype=torch.int32, device=dev)
        albedo = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        emission = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        roughness = torch.zeros((n,), dtype=torch.float32, device=dev)
        ior = torch.ones((n,), dtype=torch.float32, device=dev)
        for r in range(m):
            sel = mat_id == r
            sel3 = sel[:, None]
            mtype = torch.where(sel, materials.type[r], mtype)
            albedo = torch.where(sel3, materials.albedo[r], albedo)
            emission = torch.where(sel3, materials.emission[r], emission)
            roughness = torch.where(sel, materials.roughness[r], roughness)
            ior = torch.where(sel, materials.ior[r], ior)
        return MatParams(mtype, albedo, emission, roughness, ior)
    valid = (mat_id >= 0) & (mat_id < m)
    idx = torch.where(valid, mat_id, torch.zeros_like(mat_id)).long()
    v1 = valid[:, None]
    zero3 = torch.zeros((1, 3), dtype=torch.float32, device=dev)
    return MatParams(
        mtype=torch.where(valid, materials.type[idx], torch.zeros_like(mat_id)),
        albedo=torch.where(v1, materials.albedo[idx], zero3),
        emission=torch.where(v1, materials.emission[idx], zero3),
        roughness=torch.where(valid, materials.roughness[idx], torch.zeros((), device=dev)),
        ior=torch.where(valid, materials.ior[idx], torch.ones((), device=dev)),
    )


def _refract(uv, n, eta_ratio):
    """Snell refraction of unit vector `uv` about normal `n`
    (raytracer_tpu/utils/vecmath.refract)."""
    cos_theta = torch.clamp_max(vm.dot(-uv, n), 1.0)
    r_perp = eta_ratio * (uv + cos_theta * n)
    r_parallel = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - vm.length_squared(r_perp)),
                                             1e-12)) * n
    return r_perp + r_parallel


def scatter(smp, in_dir, normal, front_face, mat_id, materials) -> ScatterResult:
    """`scatter_params` of the materials' parameters at mat_id."""
    return scatter_params(smp, in_dir, normal, front_face, lookup_params(materials, mat_id))


def scatter_params(smp, in_dir, normal, front_face, params: MatParams) -> ScatterResult:
    """The JAX module's scatter (a sampler of utils/ktf or utils/rng, or
    raw lane keys)."""
    smp = as_sampler(smp)
    mtype = params.mtype
    albedo = params.albedo
    roughness = params.roughness[:, None]
    unit_vec = smp.scatter_unit_vector()
    u_dielectric = smp.dielectric_uniform()

    lam_dir = normal + unit_vec
    lam_dir = torch.where(vm.near_zero(lam_dir), normal, lam_dir)

    reflected = vm.normalize(vm.reflect(in_dir, normal), eps=1e-20) + roughness * unit_vec
    metal_ok = vm.dot(reflected, normal, keepdims=False) > 0.0

    one = torch.ones((), device=in_dir.device)
    ri = torch.where(front_face, 1.0 / params.ior, params.ior)[:, None]
    unit_in = vm.normalize(in_dir)
    cos_theta = torch.clamp_max(vm.dot(-unit_in, normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = (ri * sin_theta) > 1.0
    r0 = torch.square((1.0 - ri) / (one + ri))
    schlick = r0 + (1.0 - r0) * torch.pow(1.0 - cos_theta, 5.0)
    do_reflect = cannot_refract | (schlick > u_dielectric[:, None])
    die_dir = torch.where(do_reflect, vm.reflect(unit_in, normal),
                          _refract(unit_in, normal, ri))

    is_lam = mtype == LAMBERTIAN
    is_metal = mtype == METAL
    is_die = mtype == DIELECTRIC
    is_light = mtype == DIFFUSE_LIGHT
    direction = torch.where(is_metal[:, None], reflected, lam_dir)
    direction = torch.where(is_die[:, None], die_dir, direction)
    attenuation = torch.where(is_die[:, None], torch.ones_like(albedo), albedo)
    scattered = is_lam | (is_metal & metal_ok) | is_die
    emission = torch.where(is_light[:, None], params.emission,
                           torch.zeros_like(params.emission))
    return ScatterResult(direction, attenuation, scattered, is_light, emission)


def scatter_fused(d, n, front, inv_dl, params: MatParams, uv, u_die):
    """The fused kernel's scatter (pallas_megakernel.py post_trav, term
    for term as csrc/megakernel.cu): d the unnormalized incoming
    direction [N,3], n the front-facing unit normal [N,3], inv_dl =
    1/|d| [N], uv the SCATTER unit vector [N,3], u_die the DIELECTRIC
    uniform [N]. Returns (direction [N,3], attenuation [N,3],
    scattered bool[N])."""
    dx, dy, dz = d.unbind(-1)
    nx, ny, nz = n.unbind(-1)
    uvx, uvy, uvz = uv.unbind(-1)
    rough = params.roughness
    ior = params.ior

    lamx, lamy, lamz = nx + uvx, ny + uvy, nz + uvz
    nz_mask = ((torch.abs(lamx) < vm.EPS_NEAR_ZERO) & (torch.abs(lamy) < vm.EPS_NEAR_ZERO)
               & (torch.abs(lamz) < vm.EPS_NEAR_ZERO))
    lamx = torch.where(nz_mask, nx, lamx)
    lamy = torch.where(nz_mask, ny, lamy)
    lamz = torch.where(nz_mask, nz, lamz)

    d_dot_n = dx * nx + dy * ny + dz * nz
    refx = dx - 2.0 * d_dot_n * nx
    refy = dy - 2.0 * d_dot_n * ny
    refz = dz - 2.0 * d_dot_n * nz
    inv_rl = 1.0 / torch.sqrt(torch.clamp_min(refx * refx + refy * refy + refz * refz,
                                              EPS_SQ_1E20))
    metx = refx * inv_rl + rough * uvx
    mety = refy * inv_rl + rough * uvy
    metz = refz * inv_rl + rough * uvz
    metal_ok = (metx * nx + mety * ny + metz * nz) > 0.0

    ri = torch.where(front, 1.0 / ior, ior)
    uix, uiy, uiz = dx * inv_dl, dy * inv_dl, dz * inv_dl
    cos_t = torch.clamp_max(-(uix * nx + uiy * ny + uiz * nz), 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    cannot = (ri * sin_t) > 1.0
    r0q = (1.0 - ri) / (1.0 + ri)
    r0 = r0q * r0q
    one_mc = 1.0 - cos_t
    omc2 = one_mc * one_mc
    schlick = r0 + (1.0 - r0) * omc2 * omc2 * one_mc
    do_reflect = cannot | (schlick > u_die)
    u_dot = uix * nx + uiy * ny + uiz * nz
    drx = uix - 2.0 * u_dot * nx
    dry = uiy - 2.0 * u_dot * ny
    drz = uiz - 2.0 * u_dot * nz
    rpx = ri * (uix + cos_t * nx)
    rpy = ri * (uiy + cos_t * ny)
    rpz = ri * (uiz + cos_t * nz)
    rp2 = rpx * rpx + rpy * rpy + rpz * rpz
    rpar = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - rp2), 1e-12))
    diex = torch.where(do_reflect, drx, rpx + rpar * nx)
    diey = torch.where(do_reflect, dry, rpy + rpar * ny)
    diez = torch.where(do_reflect, drz, rpz + rpar * nz)

    mtype = params.mtype
    is_lam = mtype == LAMBERTIAN
    is_metal = mtype == METAL
    is_die = mtype == DIELECTRIC
    scd = torch.where(is_metal[:, None], torch.stack([metx, mety, metz], -1),
                      torch.stack([lamx, lamy, lamz], -1))
    scd = torch.where(is_die[:, None], torch.stack([diex, diey, diez], -1), scd)
    att = torch.where(is_die[:, None], torch.ones_like(params.albedo), params.albedo)
    scattered = is_lam | (is_metal & metal_ok) | is_die
    return scd, att, scattered
