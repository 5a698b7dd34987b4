"""Closest-hit ray traversal (counterpart of
raytracer_tpu/ops/pallas_traverse.py).

`trace_closest` has the contract of `trace_closest_pallas`: for rays o/d
f32[N,3] and limits t_max it returns {t (BIG on miss), tri_id (original
face id, 0 on miss), mat_id (0 on miss), normal (the winner's
unnormalized cross(e1, e2)), hit}. `intersect_bvh4` is
`intersect_bvh4_pallas`: the (t, tri_id) pair of that record.

On a CUDA tensor it launches kernel K4 (csrc/trace_closest.cu), one
thread per ray calling K1 (csrc/traverse.cuh), instantiated for the
tree's width (4 or 8; cudalib.bvh_view refuses others); on a CPU tensor it runs
`_traverse_plain`, the plain PyTorch version. `_traverse_plain` takes
the kernel's steps in the kernel's order — brute-force pre-pass, then
the wide BVH nearest child first from a per-ray stack (children ordered
by ops/bvh4.sort_by_key, pushed far to near) — with all live rays
advanced together, one node or leaf per ray per step.

`sort=True` (the JAX default, and what the differentiable path runs) is
K4's coherence-sort path (`trace_closest_pallas(sort=True)`,
pallas_traverse.py:975-1038): the rays are stably argsorted by
ops/packets.coherence_keys, gathered, traced, and the record is
scattered back to the callers' order. The argsort and the gathers are
XLA ops outside the Pallas call in JAX, and torch ops here. The kernel
gives every ray its own thread, so the record of a ray does not depend
on its neighbours: sorted and unsorted calls agree bit for bit, and the
sort can only change how coherent the rays of one warp are.
"""

from __future__ import annotations

import ctypes

import torch

from raytracer_tpu_torch.ops.bvh4 import BIG, sort_by_key
from raytracer_tpu_torch.ops.packets import coherence_keys, root_box
from raytracer_tpu_torch.ops.triangle import face_normal, moller_trumbore
from raytracer_tpu_torch.utils import cudalib

NONE = -1
KERNEL_BLOCK = 128  # threads per block of K4
# K4 launches, counted by the wrapper: all of them, and those made
# through the coherence-sort path.
LAUNCHES = {"trace_closest": 0, "trace_closest_sorted": 0}
PLAIN_CALLS = {"traverse_plain": 0}  # calls of the plain traversal (K1/K4's plain version)


def _closest_of(ok, t, t_best):
    """Sequential `t < t_best` updates over the last axis, vectorized: the
    first strictly smallest accepted t wins. Returns (found, t, index)."""
    inf = torch.full_like(t, float("inf"))
    t_all = torch.where(ok & (t < t_best[:, None]), t, inf)
    t_new, j = torch.min(t_all, dim=1)
    return t_new < float("inf"), t_new, j


def _traverse_plain(o, d, bvh, t_lim, t_min: float, count: bool = False):
    """Plain version of K1 for rays o/d f32[N,3] with limits t_lim f32[N]
    (t_lim = -1 marks a dead ray). Returns (t_best [N] (t_lim when
    nothing is hit), prim i32[N] (-1), mat i32[N] (0), normal f32[N,3]),
    and with `count` also i32[N], the steps each ray's walk took (one
    node expansion or one leaf each; 0 for a dead ray and for the brute
    pre-pass) — K1's count in K3-profile (csrc/traverse.cuh, COUNT)."""
    PLAIN_CALLS["traverse_plain"] += 1
    n = o.shape[0]
    dev = o.device
    t_best = t_lim.to(torch.float32).clone()
    best = torch.full((n,), NONE, dtype=torch.int32, device=dev)
    mat = torch.zeros((n,), dtype=torch.int32, device=dev)
    nrm = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    out = (t_best, best, mat, nrm, steps) if count else (t_best, best, mat, nrm)
    # Nothing lies in [t_min, t_lim) for a dead ray: skip all work (exact).
    live = torch.nonzero(t_best > t_min).squeeze(1)
    if live.numel() == 0:
        return out

    def leaf_update(rays, tri9, prim, fm, valid):
        """Möller–Trumbore of rays [m] against their own triangle rows
        tri9 [m, j, 9] (valid [m, j]), sequential-update semantics."""
        ok, t = moller_trumbore(o[rays, None], d[rays, None], tri9[..., 0:3],
                                tri9[..., 3:6], tri9[..., 6:9])
        ok = ok & valid & (t >= t_min)
        found, t_new, j = _closest_of(ok, t, t_best[rays])
        r = rays[found]
        jf = j[found, None]
        t_best[r] = t_new[found]
        best[r] = torch.gather(prim[found], 1, jf)[:, 0]
        mat[r] = torch.gather(fm[found], 1, jf)[:, 0]
        rec = torch.gather(tri9[found], 1, jf[:, :, None].expand(-1, 1, 9))[:, 0]
        nrm[r] = face_normal(rec[:, 3:6], rec[:, 6:9])

    if bvh.brute_tri is not None and bvh.brute_tri.shape[0]:
        tb = bvh.brute_tri.shape[0]
        m = live.numel()
        leaf_update(live, bvh.brute_tri[None].expand(m, tb, 9),
                    bvh.brute_prim[None].expand(m, tb), bvh.brute_mat[None].expand(m, tb),
                    torch.ones((m, tb), dtype=torch.bool, device=dev))

    k_w = bvh.children.shape[1]
    cap = bvh.stack_depth + 4
    inv_d = 1.0 / d
    stack = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    task = torch.zeros((n,), dtype=torch.int32, device=dev)
    rays = live
    slot = torch.arange(8, device=dev)
    kk = torch.arange(k_w, device=dev)
    while rays.numel():
        if count:
            steps[rays] += 1
        tk = task[rays]
        nxt = torch.full_like(tk, NONE)

        inner = tk >= 0
        if bool(inner.any()):
            ri = rays[inner]
            node = tk[inner].long()
            b = bvh.bounds[node]                                  # [m,K,6]
            ch = bvh.children[node]                               # [m,K]
            oo, ii = o[ri, None, :], inv_d[ri, None, :]
            t0 = (b[..., 0:3] - oo) * ii
            t1 = (b[..., 3:6] - oo) * ii
            lo3, hi3 = torch.minimum(t0, t1), torch.maximum(t0, t1)
            # torch.minimum/maximum propagate NaN (0*inf), so such a box
            # compares as a miss, as in the reference and the kernel.
            tmin = torch.maximum(torch.maximum(lo3[..., 0], lo3[..., 1]),
                                 torch.maximum(lo3[..., 2], torch.full_like(lo3[..., 2], t_min)))
            tmax = torch.minimum(torch.minimum(hi3[..., 0], hi3[..., 1]),
                                 torch.minimum(hi3[..., 2], t_best[ri, None]))
            valid = (tmax > tmin) & (ch != NONE)
            key = torch.where(valid, tmin, torch.full_like(tmin, float(BIG)))
            _, codes = sort_by_key(key, ch)
            nhit = valid.sum(dim=1)
            nxt[inner] = torch.where(nhit > 0, codes[:, 0], torch.full_like(codes[:, 0], NONE))
            # Push children 1..nhit-1 far to near: child k lands at sp + nhit-1-k.
            push = (kk[None, :] >= 1) & (kk[None, :] < nhit[:, None])
            pos = sp[ri, None] + (nhit[:, None] - 1 - kk[None, :])
            pr, pk = torch.nonzero(push, as_tuple=True)
            stack[ri[pr], pos[pr, pk].clamp(max=cap - 1)] = codes[pr, pk]
            sp[ri] = sp[ri] + torch.clamp_min(nhit - 1, 0)

        leaf = ~inner
        if bool(leaf.any()):
            rl = rays[leaf]
            code = (-tk[leaf] - 2).long()
            lo = code // 8
            cnt = code % 8 + 1
            idx = (lo[:, None] + slot[None, :]).clamp(max=bvh.tri.shape[0] - 1)
            leaf_update(rl, bvh.tri[idx], bvh.prim_index[idx], bvh.face_mat[idx],
                        slot[None, :] < cnt[:, None])

        pop = (nxt == NONE) & (sp[rays] > 0)
        rp = rays[pop]
        sp[rp] -= 1
        nxt[pop] = stack[rp, sp[rp]]
        task[rays] = nxt
        rays = rays[nxt != NONE]
    return out


def _finish(t_best, best, mat, nrm):
    found = best >= 0
    return {
        "t": torch.where(found, t_best, torch.full_like(t_best, float(BIG))),
        "tri_id": torch.where(found, best, torch.zeros_like(best)),
        "mat_id": torch.where(found, mat, torch.zeros_like(mat)),
        "normal": nrm,
        "hit": found,
    }


def _limits(origins, t_max):
    n = origins.shape[0]
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                              device=origins.device), (n,)).contiguous()


def _sorted(trace, origins, dirs, bvh4, t_max, t_min):
    """`trace` on the rays in coherence order, record back in call order."""
    lo, inv_ext = root_box(bvh4)
    perm = torch.argsort(coherence_keys(origins, dirs, lo, inv_ext), stable=True)
    rec = trace(origins[perm].contiguous(), dirs[perm].contiguous(), bvh4,
                _limits(origins, t_max)[perm].contiguous(), t_min)
    out = {}
    for k, v in rec.items():
        out[k] = torch.empty_like(v)
        out[k][perm] = v
    return out


def trace_closest_plain(origins, dirs, bvh4, t_max, t_min: float = 1e-3,
                        sort: bool = False):
    """The plain PyTorch version of `trace_closest` (any device)."""
    if sort:
        return _sorted(trace_closest_plain, origins, dirs, bvh4, t_max, t_min)
    return _finish(*_traverse_plain(origins, dirs, bvh4, _limits(origins, t_max), t_min))


def _trace_closest_cuda(origins, dirs, bvh4, t_max, t_min: float):
    n = origins.shape[0]
    t_hi = _limits(origins, t_max)
    cudalib.require_cuda("origins", origins, torch.float32, (n, 3))
    cudalib.require_cuda("dirs", dirs, torch.float32, (n, 3))
    view = cudalib.bvh_view(bvh4)
    t = torch.empty((n,), dtype=torch.float32, device=origins.device)
    ids = torch.empty((n,), dtype=torch.int32, device=origins.device)
    mat = torch.empty((n,), dtype=torch.int32, device=origins.device)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
    code = cudalib.lib().rt_trace_closest(
        view, origins.data_ptr(), dirs.data_ptr(), t_hi.data_ptr(), float(t_min), n,
        t.data_ptr(), ids.data_ptr(), mat.data_ptr(), nrm.data_ptr(), KERNEL_BLOCK,
        cudalib.stream_handle())
    cudalib.check(code, "trace_closest kernel")
    LAUNCHES["trace_closest"] += 1
    return _finish(t, ids, mat, nrm)


def kernel_resources() -> dict:
    """{"K4" (width 8), "K4/w4": (registers per thread, local memory bytes
    per thread)} on the card (cudaFuncGetAttributes)."""
    out = {}
    for width in cudalib.BVH_WIDTHS[::-1]:
        regs, local = ctypes.c_int(0), ctypes.c_int(0)
        cudalib.check(cudalib.lib().rt_trace_closest_attrs(width, ctypes.byref(regs),
                                                           ctypes.byref(local)), "K4 attributes")
        out["K4" if width == 8 else f"K4/w{width}"] = (regs.value, local.value)
    return out


def _trace_closest_cuda_sorted(origins, dirs, bvh4, t_max, t_min: float):
    rec = _trace_closest_cuda(origins, dirs, bvh4, t_max, t_min)
    LAUNCHES["trace_closest_sorted"] += 1
    return rec


def trace_closest(origins, dirs, bvh4, t_max, t_min: float = 1e-3, sort: bool = True):
    """Closest hit for rays origins/dirs f32[N,3] within [t_min, t_max]
    (scalar or f32[N]; -1 marks a dead ray), through the coherence sort
    when `sort`. CUDA tensors launch K4 at any ray count, CPU tensors
    take the plain version."""
    if origins.is_cuda:
        if sort:
            return _sorted(_trace_closest_cuda_sorted, origins, dirs, bvh4, t_max, t_min)
        return _trace_closest_cuda(origins, dirs, bvh4, t_max, t_min)
    if origins.device.type != "cpu":
        raise ValueError(f"trace_closest: unsupported device {origins.device}")
    return trace_closest_plain(origins, dirs, bvh4, t_max, t_min, sort=sort)


def intersect_bvh4(origins, dirs, bvh4, t_min, t_max, sort: bool = True):
    """Closest triangle hit: (t f32[N] BIG on miss, tri_id i32[N] 0 on
    miss), the contract of pallas_traverse.intersect_bvh4_pallas."""
    rec = trace_closest(origins, dirs, bvh4, t_max, t_min=float(t_min), sort=sort)
    return rec["t"], rec["tri_id"]
