"""The fused path loop: the whole integrator per pixel lane in one kernel
(counterpart of raytracer_tpu/ops/pallas_megakernel.py).

`render_tiles_fused` returns the mean linear radiance f32[N,3] of any
pixel list. On CUDA tensors it launches kernel K3 (csrc/megakernel.cu:
persistent blocks whose threads take lanes from the list and loop their
samples and bounces, K1 and K2 inline), or
with `interleave=2` (RAYTRACER_TPU_INTERLEAVE=2) K5 (csrc/interleave.cuh:
K3's persistent blocks with two lanes per thread, their traversals
merged), or with `profile=True`
K3-profile, which also returns the per-lane cost and the per-packet aux
plane that `schedule.build_schedule` reads. On CPU tensors it runs
`_render_plain`, the plain PyTorch version of all three: K5 equals K3
per lane, and the profile counts are integers the plain loop counts the
same way.

`_render_plain` is the TPU kernel's lane-stable loop restated over
tensors: all pending lanes advance one bounce per step, a lane that
ends a sample claims its next sample on the following step, and every
draw is keyed by (pixel, sample + sample_offset, bounce, purpose)
(utils/ktf.py). Per lane that is the kernel's nested loop exactly, with
the kernel's formulas, so both trace the same paths; they can differ
only where the two libraries' cos/sin round differently (the lens-disk
and scatter-direction draws).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from raytracer_tpu_torch.camera import camera_basis
from raytracer_tpu_torch.ops.cuda_traverse import _traverse_plain
from raytracer_tpu_torch.ops.materials import lookup_params, scatter_fused
from raytracer_tpu_torch.ops.sphere import BIG, intersect_spheres
from raytracer_tpu_torch.scene.types import DIFFUSE_LIGHT
from raytracer_tpu_torch.utils import cudalib, ktf, profiling

MAX_SPHERES = cudalib.MAX_SPHERES
MAX_MATERIALS = cudalib.MAX_MATERIALS
PACKET = 1024          # lanes per "packet" in host_chunk_packets units
WARP = 32
KERNEL_BLOCK = 128     # threads per block of K3, K3-profile and K5
KERNEL_CHUNK = 64      # lanes a block of K3, K3-profile or K5 takes from the lane list at a time
SKY_TOP = (0.5, 0.7, 1.0)
# Launches counted by the wrapper: K3, K5 (G = 2) and K3-profile.
LAUNCHES = profiling.group("launch", ("render_fused", "render_fused_g2", "render_fused_profile"))
PLAIN_CALLS = profiling.group("plain", ("render_plain",))   # calls of the plain path loop


def _check_interleave(g: int) -> int:
    if g not in (1, 2):
        raise ValueError(f"interleave must be 1 or 2, got {g}")
    return g


def _default_interleave() -> int:
    """Lanes per thread of the fused path loop (1 or 2), from
    RAYTRACER_TPU_INTERLEAVE (default 1), the JAX package's switch
    (raytracer_tpu/ops/pallas_megakernel.py:67)."""
    return _check_interleave(int(os.environ.get("RAYTRACER_TPU_INTERLEAVE", "1")))


def fused_megakernel_available(scene) -> bool:
    """True when the fused path loop can render this scene: a tree of a
    width the kernels are built for (4 or 8) within their budgets."""
    return (scene.bvh4 is not None
            and scene.bvh4.face_mat is not None
            and int(scene.bvh4.children.shape[1]) in cudalib.BVH_WIDTHS
            and scene.spheres.count <= MAX_SPHERES
            and scene.materials.count <= MAX_MATERIALS)


def _render_plain(scene, basis, cfg, k0, k1, pix, pxf, pyf, spp, soff, profile=False):
    """Plain version of K3 (and of K5, which equals it per lane): radiance
    SUM f32[N,3] over spp samples. With `profile`, K3-profile's: also
    each lane's K1 steps and path iterations, i32[N] each (a path
    iteration per step the lane is pending, a roulette kill included)."""
    PLAIN_CALLS.count("render_plain")
    n = pix.shape[0]
    dev = pix.device
    ll, hor, ver = basis["lower_left"], basis["horizontal"], basis["vertical"]
    pos, right, up, lens_r = basis["position"], basis["right"], basis["up"], basis["lens_radius"]
    spheres, mats, bvh = scene.spheres, scene.materials, scene.bvh4
    t_min = cfg.t_min
    rr_max = torch.tensor(np.float32(cfg.rr_max_prob), device=dev)

    o = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    d = torch.ones((n, 3), dtype=torch.float32, device=dev)
    tp = torch.ones((n, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    sample = torch.zeros((n,), dtype=torch.int32, device=dev)
    bounce = torch.zeros((n,), dtype=torch.int32, device=dev)
    active = torch.zeros((n,), dtype=torch.bool, device=dev)
    k1_steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    path_iters = torch.zeros((n,), dtype=torch.int32, device=dev)

    while True:
        lanes = torch.nonzero(active | (sample < spp)).squeeze(1)
        if lanes.numel() == 0:
            break
        act = active[lanes]
        smp_l = sample[lanes]
        b = torch.where(act, bounce[lanes], torch.zeros_like(smp_l))
        s_eff = smp_l + soff
        pixl = pix[lanes]
        if profile:
            path_iters[lanes] += 1

        # Camera regeneration on claiming lanes (Core/Camera.cuh:32-44),
        # draws keyed at bounce 0.
        claim = ~act
        cl = lanes[claim]
        if cl.numel():
            sm0 = ktf.KtfSampler(k0, k1, pix[cl], s_eff[claim], torch.zeros_like(cl, dtype=torch.int32))
            ldx, ldy = sm0.disk_parts(ktf.LENS)
            rdx, rdy = lens_r * ldx, lens_r * ldy
            off = right * rdx[:, None] + up * rdy[:, None]
            ju, jv = sm0.uniform_pair(ktf.JITTER)
            u = (pxf[cl] + ju) * (1.0 / cfg.width)
            v = (pyf[cl] + jv) * (1.0 / cfg.height)
            o[cl] = pos + off
            d[cl] = ll + u[:, None] * hor + v[:, None] * ver - pos - off
            tp[cl] = 1.0

        # Russian roulette (CUDAKernels.h:113-121).
        smp = ktf.KtfSampler(k0, k1, pixl, s_eff, b)
        tl = tp[lanes]
        do_rr = b >= cfg.min_bounces
        survival = torch.minimum(torch.maximum(torch.maximum(tl[:, 0], tl[:, 1]), tl[:, 2]), rr_max)
        survived = ~(do_rr & (smp.uniform(ktf.RR) > survival))
        rr_scale = torch.where(survived & do_rr, 1.0 / torch.clamp_min(survival, 1e-12),
                               torch.ones_like(survival))
        tl = tl * rr_scale[:, None]

        # Sphere sweep, then K1 within [t_min, t_sph).
        ol, dl = o[lanes], d[lanes]
        t_sph, sid = intersect_spheres(ol, dl, spheres.center, spheres.radius, t_min, BIG)
        t_lim = torch.where(survived, t_sph, torch.full_like(t_sph, -1.0))
        t_tri, _, mat_tri, ng, *steps = _traverse_plain(ol, dl, bvh, t_lim, t_min, count=profile)
        if profile:
            k1_steps[lanes] += steps[0]

        # Hit resolution (pallas_megakernel.py post_trav).
        tri_wins = t_tri < t_sph
        t_hit = torch.where(tri_wins, t_tri, t_sph)
        ray_hit = t_hit < BIG
        p = ol + t_hit[:, None] * dl
        sidl = sid.long()
        rad = spheres.radius[sidl]
        r_sel = torch.where(rad != 0.0, rad, torch.ones_like(rad))
        rn = torch.where(tri_wins[:, None], ng, (p - spheres.center[sidl]) / r_sel[:, None])
        rnx, rny, rnz = rn.unbind(-1)
        inv_nn = 1.0 / torch.sqrt(torch.clamp_min(rnx * rnx + rny * rny + rnz * rnz, 1e-24))
        nn = rn * inv_nn[:, None]
        dx, dy, dz = dl.unbind(-1)
        front = (dx * nn[:, 0] + dy * nn[:, 1] + dz * nn[:, 2]) < 0.0
        nrm = nn * torch.where(front, 1.0, -1.0)[:, None]
        mid = torch.where(tri_wins, mat_tri, spheres.mat_id[sidl])
        params = lookup_params(mats, mid)

        a_q = dx * dx + dy * dy + dz * dz
        inv_dl = 1.0 / torch.sqrt(a_q)
        scd, att, scattered = scatter_fused(dl, nrm, front, inv_dl, params,
                                            smp.unit_vector(ktf.SCATTER),
                                            smp.uniform(ktf.DIELECTRIC))

        # Accumulation & state update.
        hit = ray_hit & survived
        light_hit = hit & (params.mtype == DIFFUSE_LIGHT)
        miss = survived & ~ray_hit
        cont = hit & scattered & (b + 1 < cfg.max_bounces)
        em = params.emission if cfg.reference_emission_quirk else tl * params.emission
        sky_t = 0.5 * (dy * inv_dl + 1.0)
        sky = torch.stack([(1.0 - sky_t) + sky_t * c for c in SKY_TOP], dim=-1)
        c = torch.where(light_hit[:, None], em, torch.zeros_like(em))
        c = torch.where(miss[:, None], tl * sky, c)
        term = ~cont
        acc[lanes] = acc[lanes] + torch.where(term[:, None], c, torch.zeros_like(c))
        sample[lanes] = torch.where(term, smp_l + 1, smp_l)
        tp[lanes] = torch.where(cont[:, None], tl * att, tl)
        o[lanes] = torch.where(cont[:, None], p, ol)
        d[lanes] = torch.where(cont[:, None], scd, dl)
        bounce[lanes] = torch.where(cont, b + 1, b)
        active[lanes] = cont
    if profile:
        return acc, k1_steps, path_iters
    return acc


def _packet_bill(k1_steps, path_iters):
    """Plain version of K3-profile's aux plane f32[N] ([N/1024, 8, 128]):
    row 0 the sum over a packet's 32 warps of the warp's largest lane
    total of K1 steps, row 1 the packet's largest lane path-iteration
    count, rows 2-7 zero."""
    g = k1_steps.shape[0] // PACKET
    lockstep = k1_steps.reshape(g, PACKET // WARP, WARP).amax(dim=2).sum(dim=1)
    outer = path_iters.reshape(g, PACKET).amax(dim=1)
    aux = torch.zeros((g, 8, 128), dtype=torch.float32, device=k1_steps.device)
    aux[:, 0, :] = lockstep.to(torch.float32)[:, None]
    aux[:, 1, :] = outer.to(torch.float32)[:, None]
    return aux.reshape(-1)


def _pack_tables(scene):
    """Spheres → f32[S,4] (center, radius) + i32[S]; materials →
    f32[M,8] (albedo, emission, roughness, ior) + i32[M] types."""
    s, m = scene.spheres, scene.materials
    if s.count > MAX_SPHERES or m.count > MAX_MATERIALS:
        raise ValueError(f"fused kernel budgets: {s.count} spheres (max {MAX_SPHERES}), "
                         f"{m.count} materials (max {MAX_MATERIALS})")
    sph = torch.cat([s.center, s.radius[:, None]], dim=1).contiguous()
    mat = torch.cat([m.albedo, m.emission, m.roughness[:, None], m.ior[:, None]], dim=1)
    return sph, s.mat_id.contiguous(), mat.contiguous(), m.type.contiguous()


def _render_cuda(scene, basis, cfg, k0, k1, pix, pxi, pyi, spp, soff, block, chunk, kind):
    """Launch K3 (kind "k3"), K5 ("g2") or K3-profile ("profile") over the
    lanes: radiance SUM f32[N,3]; K3-profile also cost f32[N], aux f32[N]
    and the lane K1 steps and path iterations, i32[N] each. K3 and
    K3-profile take the lanes `chunk` at a time through a counter on the
    card that starts at 0; so does K5, two lanes per thread."""
    n = pix.shape[0]
    # The int32 counter passes n by at most one chunk per block (< 2**13
    # blocks: 32 per SM).
    if chunk < 1 or n + chunk * 2**13 >= 2**31:
        raise ValueError(f"chunk {chunk} for {n} lanes: the lane counter would overflow")
    for name, t in (("pixel", pix), ("px", pxi), ("py", pyi)):
        cudalib.require_cuda(name, t, torch.int32, (n,))
    view = cudalib.bvh_view(scene.bvh4)
    sph, sph_mat, mat, mat_type = _pack_tables(scene)
    for name, t in (("spheres", sph), ("materials", mat)):
        cudalib.require_cuda(name, t, torch.float32)
    for name, t in (("sphere mat_id", sph_mat), ("material type", mat_type)):
        cudalib.require_cuda(name, t, torch.int32)

    def vec(key):
        return (ctypes.c_float * 3)(*basis[key].tolist())

    prm = cudalib.FusedParams(
        ll=vec("lower_left"), hor=vec("horizontal"), ver=vec("vertical"),
        pos=vec("position"), right=vec("right"), up=vec("up"),
        lens_r=float(basis["lens_radius"]),
        inv_w=float(np.float32(1.0 / cfg.width)), inv_h=float(np.float32(1.0 / cfg.height)),
        rr_max_prob=float(np.float32(cfg.rr_max_prob)), t_min=float(np.float32(cfg.t_min)),
        k0=k0 & 0xFFFFFFFF, k1=k1 & 0xFFFFFFFF, sample_offset=int(soff), spp=int(spp),
        max_bounces=int(cfg.max_bounces), min_bounces=int(cfg.min_bounces),
        emission_quirk=int(bool(cfg.reference_emission_quirk)),
        n_spheres=scene.spheres.count, n_materials=scene.materials.count)
    dev = pix.device
    # Every output starts as NaN (the lane counts as -1), so a lane that
    # the lane list never hands out shows in every check of the kernels
    # instead of keeping a value the caching allocator left in the buffer.
    out = torch.full((n, 3), float("nan"), dtype=torch.float32, device=dev)
    lane_list = torch.zeros((1,), dtype=torch.int32, device=dev)
    args = (prm, view, pix.data_ptr(), pxi.data_ptr(), pyi.data_ptr(), sph.data_ptr(),
            sph_mat.data_ptr(), mat.data_ptr(), mat_type.data_ptr(), n, out.data_ptr())
    L = cudalib.lib()
    if kind == "profile":
        cost = torch.full((n,), float("nan"), dtype=torch.float32, device=dev)
        aux = torch.full((n,), float("nan"), dtype=torch.float32, device=dev)
        scratch = torch.full((2, n), -1, dtype=torch.int32, device=dev)
        code = L.rt_render_fused_profile(*args, cost.data_ptr(), scratch[0].data_ptr(),
                                         scratch[1].data_ptr(), aux.data_ptr(), block, chunk,
                                         lane_list.data_ptr(), cudalib.stream_handle())
        cudalib.check(code, "fused path-loop kernel (profile)")
        LAUNCHES.count("render_fused_profile")
        return out, cost, aux, scratch[0], scratch[1]
    if kind == "g2":
        code = L.rt_render_fused_g2(*args, block, chunk, lane_list.data_ptr(),
                                    cudalib.stream_handle())
        cudalib.check(code, "fused path-loop kernel (G=2)")
        LAUNCHES.count("render_fused_g2")
        return out
    code = L.rt_render_fused(*args, block, chunk, lane_list.data_ptr(), cudalib.stream_handle())
    cudalib.check(code, "fused path-loop kernel")
    LAUNCHES.count("render_fused")
    return out


def kernel_resources() -> dict:
    """{kernel: (registers per thread, local memory bytes per thread)} of
    K3, K3-profile and K5 on the card (cudaFuncGetAttributes), for each
    tree width: "K3" etc. at width 8, "K3/w4" etc. at width 4."""
    L = cudalib.lib()
    out = {}
    for width in cudalib.BVH_WIDTHS[::-1]:
        tag = "" if width == 8 else f"/w{width}"
        for name, call in (("K3", lambda w, r, b: L.rt_render_fused_attrs(w, 0, r, b)),
                           ("K3-profile", lambda w, r, b: L.rt_render_fused_attrs(w, 1, r, b)),
                           ("K5", L.rt_render_fused_g2_attrs)):
            regs, local = ctypes.c_int(0), ctypes.c_int(0)
            cudalib.check(call(width, ctypes.byref(regs), ctypes.byref(local)),
                          f"{name}{tag} attributes")
            out[name + tag] = (regs.value, local.value)
    return out


def _render(scene, cam, cfg, seed, px, py, spp, sample_offset, host_chunk_packets, block,
            use_kernel: bool, profile: bool, interleave, lane_counts: bool = False,
            chunk: int = KERNEL_CHUNK):
    if not fused_megakernel_available(scene):
        raise ValueError(f"the fused path loop needs a bvh4 scene of width {cudalib.BVH_WIDTHS} "
                         f"within the kernel's budgets ({MAX_SPHERES} spheres, "
                         f"{MAX_MATERIALS} materials)")
    g = _default_interleave() if interleave is None else _check_interleave(int(interleave))
    n = px.shape[0]
    if profile and g != 1:
        raise ValueError("profile=True renders one lane per thread: it needs interleave=1")
    if profile and n % PACKET:
        raise ValueError(f"profile=True needs a multiple of {PACKET} lanes, got {n}")
    spp = cfg.spp if spp is None else int(spp)
    if spp < 1:
        raise ValueError(f"spp must be at least 1, got {spp}")
    basis = {k: torch.as_tensor(v, dtype=torch.float32).reshape(-1)
             for k, v in camera_basis(cam).items()}
    basis["position"] = cam.position.reshape(-1)
    k0, k1 = ktf.key_words(seed)
    pxi, pyi = px.to(torch.int32), py.to(torch.int32)
    pix = pyi * cfg.width + pxi

    if use_kernel:
        kind = "profile" if profile else ("g2" if g == 2 else "k3")

        def run(lo, hi):
            return _render_cuda(scene, basis, cfg, k0, k1, pix[lo:hi], pxi[lo:hi],
                                pyi[lo:hi], spp, sample_offset, block, chunk, kind)
    else:
        basis_d = {k: v.to(px.device) for k, v in basis.items()}
        basis_d["lens_radius"] = basis_d["lens_radius"].reshape(())

        def run(lo, hi):
            res = _render_plain(scene, basis_d, cfg, k0, k1, pix[lo:hi],
                                pxi[lo:hi].to(torch.float32), pyi[lo:hi].to(torch.float32),
                                spp, sample_offset, profile=profile)
            if not profile:
                return res
            acc, k1_steps, path_iters = res
            return (acc, (k1_steps + path_iters).to(torch.float32),
                    _packet_bill(k1_steps, path_iters), k1_steps, path_iters)

    step = n if not host_chunk_packets else int(host_chunk_packets) * PACKET
    parts = [run(lo, min(lo + step, n)) for lo in range(0, n, max(step, 1))]
    if not profile:
        return torch.cat(parts) * (1.0 / spp)
    acc, *rest = (torch.cat(x) for x in zip(*parts))
    return (acc * (1.0 / spp), *(rest if lane_counts else rest[:2]))


def render_tiles_fused(scene, cam, cfg, seed: int, px, py, spp=None, sample_offset: int = 0,
                       host_chunk_packets=None, block: int = KERNEL_BLOCK,
                       profile: bool = False, interleave=None, lane_counts: bool = False,
                       chunk: int = KERNEL_CHUNK):
    """Mean linear radiance f32[N,3] over `spp` samples for the pixels
    (px, py) (i32[N], py = 0 the bottom row) on the scene's device: CUDA
    tensors launch K3 (K5 with `interleave=2`, K3-profile with
    `profile`), CPU tensors take the plain version.

    `interleave` is 1 or 2 lanes per thread; None reads
    RAYTRACER_TPU_INTERLEAVE (default 1). `profile=True` (interleave 1,
    N % 1024 == 0) returns (rgb, cost f32[N], aux f32[N]), the layout of
    raytracer_tpu/ops/pallas_megakernel.py:694-699: cost is the lane's
    path iterations plus its K1 steps; aux, viewed [N/1024, 8, 128],
    holds per packet the lockstep bill (row 0: the sum over its 32 warps
    of the warp's largest lane total of K1 steps) and the outer path
    iterations (row 1: the largest lane iteration count). `lane_counts`
    adds the counts they are made of: the lane K1 steps and path
    iterations, i32[N] each.

    `sample_offset` shifts the sample index of every draw, so passes of
    a split spp give the samples a single pass would. `host_chunk_packets`
    splits the lanes into launches of that many 1024-lane packets; lanes
    are independent, so the result is identical. `block` is the threads
    per block and `chunk` the lanes a block of K3 (or K3-profile, or K5)
    takes from the lane list at a time: launch shapes that do not change
    the image."""
    if px.device.type not in ("cuda", "cpu"):
        raise ValueError(f"render_tiles_fused: unsupported device {px.device}")
    return _render(scene, cam, cfg, seed, px, py, spp, sample_offset, host_chunk_packets,
                   block, use_kernel=px.is_cuda, profile=profile, interleave=interleave,
                   lane_counts=lane_counts, chunk=chunk)


def render_tiles_fused_plain(scene, cam, cfg, seed: int, px, py, spp=None,
                             sample_offset: int = 0, host_chunk_packets=None,
                             profile: bool = False, lane_counts: bool = False):
    """`render_tiles_fused` through the plain PyTorch version on any
    device (the reference the kernels are checked against on the card;
    it is also K5's, which equals K3 per lane)."""
    return _render(scene, cam, cfg, seed, px, py, spp, sample_offset, host_chunk_packets,
                   KERNEL_BLOCK, use_kernel=False, profile=profile, interleave=1,
                   lane_counts=lane_counts)
