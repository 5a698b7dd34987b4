"""Closest-hit ray traversal (counterpart of
raytracer_tpu/ops/pallas_traverse.py).

`trace_closest` has the contract of `trace_closest_pallas`: for rays o/d
f32[N,3] and limits t_max it returns {t (BIG on miss), tri_id (original
face id, 0 on miss), mat_id (0 on miss), normal (the winner's
unnormalized cross(e1, e2)), hit}. `intersect_bvh4` is
`intersect_bvh4_pallas`: the (t, tri_id) pair of that record.

On a CUDA tensor it launches kernel K4 (csrc/trace_closest.cu), one
ray per thread calling K1 (csrc/traverse.cuh), instantiated for the
tree's width (4 or 8; cudalib.bvh_view refuses others). K4 writes the
finished record itself, reads a scalar limit by value or a per-ray one
from the card, and writes only the fields its caller asks for
(`intersect_bvh4`: t and tri_id); the tree's view is built once per tree
(`_view`). On a CPU tensor it runs `_traverse_plain`, the plain PyTorch
version, which takes
the kernel's steps in the kernel's order — brute-force pre-pass, then
the wide BVH nearest child first from a per-ray stack (children ordered
by ops/bvh4.sort_by_key, pushed far to near) — with all live rays
advanced together, one node or leaf per ray per step.

`sort=True` (the JAX default, and what the differentiable path runs) is
K4's coherence-sort path (`trace_closest_pallas(sort=True)`,
pallas_traverse.py:961-1050). On the card it is three launches: the key
kernel (ops/packets.coherence_keys32 in the tree's sort box,
`Bvh4.sort_box`), a stable torch.argsort of the keys (XLA's sort outside
the Pallas call in JAX), and K4 through the permutation (thread i traces
ray perm[i] and writes its record there). The plain version gathers,
traces and scatters back (`trace_closest_plain(perm=)`). The kernel
gives every ray its own walk, so the record of a ray does not depend on
its neighbours: sorted and unsorted calls agree bit for bit, and the
sort can only change how coherent the rays of one warp are. There is no
fallback: a key kernel or K4 that fails raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytracer_tpu_torch.ops.bvh4 import BIG, sort_by_key
from raytracer_tpu_torch.ops.packets import coherence_keys32
from raytracer_tpu_torch.ops.triangle import face_normal, moller_trumbore
from raytracer_tpu_torch.utils import cudalib, profiling

NONE = -1
KERNEL_BLOCK = 128  # threads per block of K4
# Launches, counted by the wrappers: K4's (all, and those through the
# coherence sort) and the key kernel's.
LAUNCHES = profiling.group("launch", ("trace_closest", "trace_closest_sorted", "coherence_keys"))
# Calls of the plain traversal (K1/K4's plain version).
PLAIN_CALLS = profiling.group("plain", ("traverse_plain",))


# K1's cull of the brute pre-pass (csrc/traverse.cuh `brute_skip`). Each
# brute triangle j gets a row of `brute_boxes`: its box padded by
# delta = BOX_PAD x the brute set's extent (lo at 0-2, hi at 4-6) and its
# guard normal m_j = cross(e1, e2) / kappa_j (8-10), kappa_j =
# GUARD_C * 2^-24 * |e1|inf * |e2|inf / delta; the last row holds the set's
# centre c (0-2) and R >= max |v - c|inf over its vertices (3). The kernel
# may skip triangle j only where the slab test of the padded box misses
# [t_min, t_lim) AND |d . m_j| >= (|o - c|inf + R) * |d|inf; it culls every
# triangle first, then tests the survivors in index order.
#
# Why that is exact. Where the float32 Möller–Trumbore test of mt_record
# accepts t in [t_min, t_best), rounding-error analysis of its terms (no
# FMA) bounds the distance (inf-norm) of o + t*d from the exact triangle by
# 24 g8 S D E1 E2 / |a| + ~7u (E1 + E2 + S), where u = 2^-24, g8 = 8u/(1-8u),
# S bounds |o - v0|, D = |d|inf, E = |e|inf and a = -d . cross(e1, e2) is
# MT's determinant (its computed value within 12 g5 D E1 E2 of that). The
# guard keeps |a| >= 1024 u S D E1 E2 / delta - 12 g5 D E1 E2, so the
# distance stays below delta / 4 + delta / 4: the hit point lies inside the
# padded box with a margin larger than the slab test's own rounding
# (3u (S + delta) in space), so the slab test cannot miss it. When the
# origin is so far that 24u S > delta, the guard can never hold and every
# triangle is tested. A ray nearly parallel to a triangle's plane, where
# MT's t is rounding noise, fails the guard and is tested. NaN anywhere
# makes both tests fail: the triangle is tested.
#
# delta: 1e-2 of the extent keeps the guard's excluded cone narrow
# (|cos| below ~1024 u S / delta ~ 0.6% of directions per triangle) while a
# box grows by 1% of the scene, and is far above the slab's rounding, so no
# box is flat where a wall is axis-aligned.
BOX_PAD = 1e-2
GUARD_C = 1024.0
BOX_BUILDS = {"brute_boxes": 0}   # cull tables made (once per tree)
_U = 2.0 ** -24


def _f32_down(x: np.ndarray) -> np.ndarray:
    y = x.astype(np.float32)
    return np.where(y.astype(np.float64) > x, np.nextafter(y, np.float32(-np.inf)), y)


def _f32_up(x: np.ndarray) -> np.ndarray:
    y = x.astype(np.float32)
    return np.where(y.astype(np.float64) < x, np.nextafter(y, np.float32(np.inf)), y)


def brute_boxes(brute_tri) -> torch.Tensor:
    """The cull table f32[Tb+1, 12] of brute triangles f32[Tb, 9] (v0, e1,
    e2), laid out as above; built in float64 and rounded outward. The
    tree's builder makes it once, with the brute set (`Bvh4.brute_box`)."""
    BOX_BUILDS["brute_boxes"] += 1
    tri = brute_tri.detach().cpu().numpy().astype(np.float64)
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)           # [Tb, 3, 3]
    lo_all, hi_all = verts.min(axis=(0, 1)), verts.max(axis=(0, 1))
    delta = BOX_PAD * max(float((hi_all - lo_all).max()), 1e-30)
    out = np.zeros((tri.shape[0] + 1, 12), np.float32)
    out[:-1, 0:3] = _f32_down(verts.min(axis=1) - delta)
    out[:-1, 4:7] = _f32_up(verts.max(axis=1) + delta)
    c = ((lo_all + hi_all) / 2).astype(np.float32)
    r = np.abs(verts - c.astype(np.float64)).max() * (1 + 1e-6)
    out[-1, 0:3] = c
    out[-1, 3] = _f32_up(np.asarray(r))
    kappa = GUARD_C * _U * np.abs(e1).max(axis=1) * np.abs(e2).max(axis=1) / delta
    ok = kappa > 0   # a zero edge: MT's determinant is exactly 0, it never hits
    m = np.cross(e1, e2) / np.where(ok, kappa, 1.0)[:, None]
    out[:-1, 8:11] = np.where(ok[:, None], m, 0.0).astype(np.float32)
    return torch.from_numpy(out).to(brute_tri.device)


def brute_may_hit(o, d, boxes, t_min: float, t_best):
    """Plain mirror of K1's cull rule (csrc/traverse.cuh `brute_skip`,
    the same float32 operations): bool [N, Tb], False where triangle j
    cannot be accepted by MT within [t_min, t_best) for ray (o, d)
    (f32[N, 3] each; t_min a float or f32[N], t_best f32[N]). Used by the
    CPU tests and to count the pre-pass's work; no path calls it."""
    box, frame = boxes[None, :-1], boxes[-1]
    inv = 1.0 / d
    t0 = (box[..., 0:3] - o[:, None]) * inv[:, None]
    t1 = (box[..., 4:7] - o[:, None]) * inv[:, None]
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    lo_t = torch.as_tensor(t_min, dtype=torch.float32, device=o.device).reshape(-1, 1)
    tn = torch.maximum(torch.maximum(torch.maximum(near[..., 0], near[..., 1]), near[..., 2]),
                       lo_t.expand_as(near[..., 0]))
    tf = torch.minimum(torch.minimum(torch.minimum(far[..., 0], far[..., 1]), far[..., 2]),
                       t_best[:, None].expand_as(far[..., 0]))
    miss = tf < tn                      # False on NaN: the box test passes
    m = box[..., 8:11]
    dx, dy, dz = (x[:, None] for x in d.unbind(-1))
    g = dx * m[..., 0] + dy * m[..., 1] + dz * m[..., 2]
    s = torch.abs(o - frame[0:3]).amax(dim=-1) + frame[3]
    sd = s * torch.abs(d).amax(dim=-1)
    steady = torch.abs(g) >= sd[:, None]   # False on NaN: the triangle is tested
    return ~(miss & steady)


def brute_prepass_plain(o, d, bvh, t_lim, t_min: float, cull: bool = True):
    """K1's brute pre-pass as the kernel runs it: with `cull`, every brute
    triangle culled against t_lim first (`brute_may_hit`), then the
    survivors tested with MT in index order against the running best;
    without, every triangle tested. Returns (t_best, prim i32 (-1), mat,
    normal, MT tests i32[N]) for rays f32[N, 3] with limits t_lim f32[N]
    (t_lim <= t_min: dead, no work)."""
    n = o.shape[0]
    t_best = t_lim.to(torch.float32).clone()
    best = torch.full((n,), NONE, dtype=torch.int32, device=o.device)
    mat = torch.zeros((n,), dtype=torch.int32, device=o.device)
    nrm = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    tb = 0 if bvh.brute_tri is None else bvh.brute_tri.shape[0]
    test = (t_best > t_min)[:, None].expand(n, tb)
    if cull and tb:
        test = test & brute_may_hit(o, d, bvh.brute_box, t_min, t_best)
    for j in range(tb):
        rec = bvh.brute_tri[j]
        ok, t = moller_trumbore(o, d, rec[0:3], rec[3:6], rec[6:9])
        win = test[:, j] & ok & (t >= t_min) & (t < t_best)
        t_best = torch.where(win, t, t_best)
        best = torch.where(win, bvh.brute_prim[j], best)
        mat = torch.where(win, bvh.brute_mat[j], mat)
        nrm = torch.where(win[:, None], face_normal(rec[3:6], rec[6:9])[None], nrm)
    return t_best, best, mat, nrm, test.sum(dim=1, dtype=torch.int32)


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
    PLAIN_CALLS.count("traverse_plain")
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

    slot = torch.arange(8, device=dev)

    def tri_leaf(rl, lo, cnt):
        idx = (lo[:, None] + slot[None, :]).clamp(max=bvh.tri.shape[0] - 1)
        leaf_update(rl, bvh.tri[idx], bvh.prim_index[idx], bvh.face_mat[idx],
                    slot[None, :] < cnt[:, None])

    walk_plain(o, 1.0 / d, bvh.bounds, bvh.children, bvh.stack_depth + 4, t_best, live, t_min,
               tri_leaf, steps if count else None)
    return out


def walk_plain(o, inv_d, bounds, children, cap: int, t_best, rays, t_min: float, leaf,
               steps=None, grow=None):
    """Plain version of K1's walk (csrc/traverse.cuh `walk`) for the rays
    `rays` (indices into o / inv_d f32[N,3]) over a K-wide tree (bounds
    [n, K, 6], children [n, K], coded as ops/bvh4's), all live rays one
    node or leaf per step: a node's hit children (slab tests against
    t_best, which the leaf test updates in place) ordered by
    ops/bvh4.sort_by_key, the nearest next, the others pushed far to near
    on a per-ray stack of `cap` entries; a leaf range is handed to
    `leaf(rays, lo, cnt)`. `steps` (i32[N]), where given, counts each
    ray's steps; `grow` (f32[N]), where given, grows every box by the
    ray's own margin (csrc/traverse.cuh slab_grown)."""
    n = o.shape[0]
    dev = o.device
    k_w = children.shape[1]
    stack = torch.zeros((n, cap), dtype=torch.int32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    task = torch.zeros((n,), dtype=torch.int32, device=dev)
    kk = torch.arange(k_w, device=dev)
    while rays.numel():
        if steps is not None:
            steps[rays] += 1
        tk = task[rays]
        nxt = torch.full_like(tk, NONE)

        inner = tk >= 0
        if bool(inner.any()):
            ri = rays[inner]
            node = tk[inner].long()
            b = bounds[node]                                      # [m,K,6]
            ch = children[node]                                   # [m,K]
            oo, ii = o[ri, None, :], inv_d[ri, None, :]
            lo, hi = b[..., 0:3], b[..., 3:6]
            if grow is not None:
                g = grow[ri, None, None]
                lo, hi = lo - g, hi + g
            t0 = (lo - oo) * ii
            t1 = (hi - oo) * ii
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

        at_leaf = ~inner
        if bool(at_leaf.any()):
            code = (-tk[at_leaf] - 2).long()
            leaf(rays[at_leaf], code // 8, code % 8 + 1)

        pop = (nxt == NONE) & (sp[rays] > 0)
        rp = rays[pop]
        sp[rp] -= 1
        nxt[pop] = stack[rp, sp[rp]]
        task[rays] = nxt
        rays = rays[nxt != NONE]


def _finish(t_best, best, mat, nrm):
    """The record of _traverse_plain's result (K4 writes it itself)."""
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


def sort_perm(origins, dirs, bvh4):
    """The coherence order of the rays: the stable argsort of their int32
    keys (ops/packets.coherence_keys32 in the tree's sort box), the plain
    version of the key kernel and the sort."""
    lo, inv_ext = bvh4.sort_box[0:3], bvh4.sort_box[3:6]
    return torch.argsort(coherence_keys32(origins, dirs, lo, inv_ext), stable=True)


def trace_closest_plain(origins, dirs, bvh4, t_max, t_min: float = 1e-3,
                        sort: bool = False, perm=None):
    """The plain PyTorch version of `trace_closest` (any device). With
    `perm` (int64 [N], a permutation of the rays) it is K4 through that
    permutation: gather, trace, scatter back; `sort` takes the coherence
    order (sort_perm)."""
    t_lim = _limits(origins, t_max)
    if sort:
        perm = sort_perm(origins, dirs, bvh4)
    if perm is None:
        return _finish(*_traverse_plain(origins, dirs, bvh4, t_lim, t_min))
    rec = _finish(*_traverse_plain(origins[perm], dirs[perm], bvh4, t_lim[perm], t_min))
    out = {}
    for k, v in rec.items():
        out[k] = torch.empty_like(v)
        out[k][perm] = v
    return out


RECORD = ("t", "tri_id", "mat_id", "normal", "hit")
_DTYPES = {"t": torch.float32, "tri_id": torch.int32, "mat_id": torch.int32,
           "normal": torch.float32, "hit": torch.bool}


def _view(bvh4) -> cudalib.BvhView:
    """cudalib.bvh_view of the tree, built once per tree: kept on the tree
    object with the data_ptrs of its tensors, so a replaced tensor makes a
    new view, and `.to()`, which makes a new tree, a new one too."""
    key = tuple(0 if t is None else t.data_ptr()
                for t in (bvh4.bounds, bvh4.children, bvh4.tri, bvh4.prim_index, bvh4.face_mat,
                          bvh4.brute_tri, bvh4.brute_prim, bvh4.brute_mat, bvh4.brute_box))
    cached = bvh4.__dict__.get("_k4_view")
    if cached is not None and cached[0] == key:
        return cached[1]
    view = cudalib.bvh_view(bvh4)
    object.__setattr__(bvh4, "_k4_view", (key, view))
    return view


def coherence_keys_cuda(origins, dirs, bvh4) -> torch.Tensor:
    """The int32 sort keys (ops/packets.coherence_keys32 in the tree's sort
    box) from the key kernel (csrc/trace_closest.cu)."""
    n = origins.shape[0]
    cudalib.require_cuda("origins", origins, torch.float32, (n, 3))
    cudalib.require_cuda("dirs", dirs, torch.float32, (n, 3))
    cudalib.require_cuda("bvh.sort_box", bvh4.sort_box, torch.float32, (6,))
    keys = torch.empty((n,), dtype=torch.int32, device=origins.device)
    code = cudalib.lib().rt_coherence_keys(origins.data_ptr(), dirs.data_ptr(),
                                           bvh4.sort_box.data_ptr(), n, keys.data_ptr(),
                                           cudalib.stream_handle())
    cudalib.check(code, "coherence key kernel")
    LAUNCHES.count("coherence_keys")
    return keys


def _trace_closest_cuda(origins, dirs, bvh4, t_max, t_min: float, perm=None,
                        fields=RECORD):
    """One K4 launch: the record's `fields` for the rays (through `perm`
    where given); the other outputs are not written."""
    n = origins.shape[0]
    dev = origins.device
    cudalib.require_cuda("origins", origins, torch.float32, (n, 3))
    cudalib.require_cuda("dirs", dirs, torch.float32, (n, 3))
    view = _view(bvh4)
    if torch.is_tensor(t_max) and t_max.dim() > 0:
        t_lim, t_hi = torch.as_tensor(t_max, dtype=torch.float32, device=dev).contiguous(), 0.0
        cudalib.require_cuda("t_max", t_lim, torch.float32, (n,))
    else:
        t_lim, t_hi = None, float(t_max)
    if perm is not None:
        cudalib.require_cuda("perm", perm, torch.int64, (n,))
    rec = {k: torch.empty((n, 3) if k == "normal" else (n,), dtype=_DTYPES[k], device=dev)
           for k in fields}

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = cudalib.lib().rt_trace_closest(
        view, origins.data_ptr(), dirs.data_ptr(), ptr(t_lim), t_hi, float(t_min), n, ptr(perm),
        *(ptr(rec.get(k)) for k in RECORD), KERNEL_BLOCK, cudalib.stream_handle())
    cudalib.check(code, "trace_closest kernel")
    LAUNCHES.count("trace_closest")
    return rec


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


def trace_closest(origins, dirs, bvh4, t_max, t_min: float = 1e-3, sort: bool = True,
                  fields=RECORD):
    """Closest hit for rays origins/dirs f32[N,3] within [t_min, t_max)
    (scalar or f32[N]; t_max <= t_min marks a dead ray), through the
    coherence sort when `sort`: the record's `fields` (all by default).
    CUDA tensors launch K4 at any ray count (after the key kernel and the
    argsort when `sort`), CPU tensors take the plain version."""
    t_min = float(t_min)
    if origins.is_cuda:
        if not sort:
            return _trace_closest_cuda(origins, dirs, bvh4, t_max, t_min, fields=fields)
        perm = torch.argsort(coherence_keys_cuda(origins, dirs, bvh4), stable=True)
        rec = _trace_closest_cuda(origins, dirs, bvh4, t_max, t_min, perm=perm, fields=fields)
        LAUNCHES.count("trace_closest_sorted")
        return rec
    if origins.device.type != "cpu":
        raise ValueError(f"trace_closest: unsupported device {origins.device}")
    rec = trace_closest_plain(origins, dirs, bvh4, t_max, t_min, sort=sort)
    return {k: rec[k] for k in fields}


def intersect_bvh4(origins, dirs, bvh4, t_min, t_max, sort: bool = True):
    """Closest triangle hit: (t f32[N] BIG on miss, tri_id i32[N] 0 on
    miss), the contract of pallas_traverse.intersect_bvh4_pallas; K4
    writes only these two fields."""
    rec = trace_closest(origins, dirs, bvh4, t_max, t_min, sort, fields=("t", "tri_id"))
    return rec["t"], rec["tri_id"]
