"""Lockstep stack traversal of the binary LBVH (port of
raytracer_tpu/ops/traverse.py).

The route of a scene that holds only the LBVH (`Scene.bvh`, no bvh4),
as in the JAX package, where it is XLA code and no Pallas kernel: here
it is plain PyTorch on whatever device the rays are on, the card
included. It is not a stand-in for K4: scenes with a bvh4 never take it.

The whole ray wavefront advances in lockstep. Each step, every active
lane either tests its current internal node's two child boxes (near
child first, the far one pushed on a 64-deep stack) or tests its leaf's
single triangle, with the reference's closest-hit semantics: candidates
on [t_min, closest so far], the slab test hits iff tmax > tmin clamped
(Core/AABB.cuh:123-146). Rays that miss the root box never start. The
loop's `any(active)` is one host read per step; `STATS` counts the
steps and the reads of the calls since it was reset.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.ops.triangle import intersect_tri_single

BIG = np.float32(3.0e38)
STACK_DEPTH = 64
SENTINEL = -1
# Steps of the lockstep loop and host reads, summed over calls.
STATS = {"calls": 0, "steps": 0, "host_reads": 0}


def _slab(origins, inv_d, node_min, node_max, t_lo, t_hi):
    """Batched box slab test (Core/AABB.cuh:123-146).
    Returns (hit bool[N], tmin f32[N])."""
    t0 = (node_min - origins) * inv_d
    t1 = (node_max - origins) * inv_d
    tmin = torch.minimum(t0, t1).max(dim=-1).values
    tmax = torch.maximum(t0, t1).min(dim=-1).values
    tmin = torch.maximum(tmin, t_lo)
    tmax = torch.minimum(tmax, t_hi)
    return tmax > tmin, tmin


def intersect_bvh(origins, dirs, mesh, bvh, t_min, t_max):
    """Closest triangle hit through the LBVH `bvh` of `mesh`.

    origins/dirs: f32[N,3]; t_max: a scalar or f32[N] (pre-pruned, e.g. by
    the sphere pass). Returns (t f32[N] (BIG on a miss), tri_id i32[N] in
    ORIGINAL face order, 0 on a miss)."""
    n = origins.shape[0]
    dev = origins.device
    leaf_base = bvh.left.shape[0]
    left, right, prim_index = bvh.left.long(), bvh.right.long(), bvh.prim_index.long()

    inv_d = 1.0 / dirs  # ±inf on zero components, as in the reference
    t_lo = torch.full((n,), float(t_min), dtype=torch.float32, device=dev)
    t_hi0 = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                               (n,)).clone()

    faces, verts = mesh.faces.long(), mesh.vertices.detach()
    v0_all = verts[faces[:, 0]]
    e1_all = verts[faces[:, 1]] - v0_all
    e2_all = verts[faces[:, 2]] - v0_all

    # Root prune: rays missing the scene box never enter the loop.
    active, _ = _slab(origins, inv_d, bvh.node_min[0], bvh.node_max[0], t_lo, t_hi0)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    t_best = t_hi0
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    STATS["calls"] += 1
    while True:
        STATS["host_reads"] += 1
        if not bool(active.any()):
            break
        STATS["steps"] += 1
        is_leaf = node >= leaf_base
        # Internal: test both children (the gathers of leaf lanes read node 0).
        ni = torch.where(is_leaf, 0, node)
        lc, rc = left[ni], right[ni]
        lhit, lt = _slab(origins, inv_d, bvh.node_min[lc], bvh.node_max[lc], t_lo, t_best)
        rhit, rt = _slab(origins, inv_d, bvh.node_min[rc], bvh.node_max[rc], t_lo, t_best)
        # Near child first (the reference goes left then right,
        # Core/Mesh.cuh:73-74; near-first gives the same hit and prunes more).
        l_near = torch.where(rhit & lhit, lt <= rt, lhit)
        near = torch.where(l_near, lc, rc)
        far = torch.where(l_near, rc, lc)
        both = lhit & rhit
        next_internal = torch.where(both | (lhit ^ rhit), near, SENTINEL)

        # Leaf: the single-triangle test.
        prim = prim_index[torch.where(is_leaf, node - leaf_base, 0)]
        ok, t_tri = intersect_tri_single(origins, dirs, v0_all[prim], e1_all[prim],
                                         e2_all[prim], t_lo, t_best)
        improve = is_leaf & active & ok & (t_tri < t_best)
        t_best = torch.where(improve, t_tri, t_best)
        best_prim = torch.where(improve, prim, best_prim)

        # Stack: push the far child, then descend or pop.
        push = active & ~is_leaf & both
        slot = sp.clamp(0, STACK_DEPTH - 1)
        stack[lanes, slot] = torch.where(push, far, stack[lanes, slot])
        sp = torch.where(push, sp + 1, sp)
        next_node = torch.where(active & ~is_leaf, next_internal, SENTINEL)
        popped = stack[lanes, (sp - 1).clamp(0, STACK_DEPTH - 1)]
        do_pop = (next_node == SENTINEL) & active & (sp > 0)
        next_node = torch.where(do_pop, popped, next_node)
        sp = torch.where(do_pop, sp - 1, sp)
        active = active & (next_node != SENTINEL)
        node = torch.where(active, next_node, 0)

    found = best_prim >= 0
    t = torch.where(found, t_best, torch.full_like(t_best, float(BIG)))
    return t, torch.where(found, best_prim, 0).to(torch.int32)
