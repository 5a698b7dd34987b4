"""LBVH construction in plain PyTorch (port of raytracer_tpu/ops/bvh.py).

Karras 2012 on the mesh's device, every step data-parallel:

  1. Morton-encode the triangle centroids (30 bits, ops/packets.morton3d),
  2. sort the codes stably (ties keep the primitive order),
  3. find every internal node's range and split independently with the
     32-step exponential and binary searches,
  4. refit the boxes bottom-up as a fix-point sweep (tree-depth passes,
     capped at 256).

The result equals the JAX package's tree exactly: the same `left`,
`right` and `prim_index`, and `node_min` / `node_max` bit for bit. For
that the codes are held in int64 (torch's `>>` on int32 is arithmetic
and it has no popcount or clz: `_clz32` smears and counts with exact
integer operations), and every float32 step rounds as JAX's compiled
build does on the CPU. XLA turns the centroid's `/ 3.0` into a product
with float32(1/3) (the port multiplies by a tensor of it, so that CPU and
card round alike: a Python scalar is treated differently on a CUDA
tensor), and LLVM contracts `centroid - lo` with that product into one
fused multiply-add, which `_fma32` computes exactly. The refit makes one
host read per pass.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.packets import morton3d
from raytracer_tpu_torch.scene.types import Bvh, TriMesh


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count of leading zeros of 32-bit values held in int64 (0 → 32):
    smear the top bit down, then count the ones (SWAR popcount)."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return 32 - (((x * 0x01010101) >> 24) & 0xFF)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors, rounded once to float32 as a fused
    multiply-add rounds it. The product is exact in float64; the sum is
    rounded to odd there (TwoSum's error term says which way the rounding
    went), which makes the final rounding to float32 exact."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(torch.float64)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def _pad_flat(lo: torch.Tensor, hi: torch.Tensor):
    """Pad flat boxes by 5e-7 on each side (the reference's
    AABB::padToMinimums, Core/AABB.cuh:181-186): the strict slab test
    would otherwise always miss a zero-thickness box, e.g. every
    axis-aligned Cornell wall."""
    pad = torch.where((hi - lo) < 1e-6, 5e-7, 0.0)
    return lo - pad, hi + pad


def build_lbvh(mesh: TriMesh) -> Bvh:
    """The binary LBVH of `mesh` on its device (int32 children and
    primitive ids, float32 boxes: internal nodes, then the leaves in
    sorted order)."""
    verts, faces = mesh.vertices, mesh.faces.long()
    dev = verts.device
    t = faces.shape[0]
    if t == 1:
        # Degenerate: the root is the single leaf; one dummy internal node
        # pointing at it twice keeps traversal uniform.
        v = verts[faces[0]]
        mn, mx = _pad_flat(v.min(dim=0).values[None, :], v.max(dim=0).values[None, :])
        one = torch.ones((1,), dtype=torch.int32, device=dev)
        return Bvh(left=one, right=one.clone(), node_min=torch.cat([mn, mn]),
                   node_max=torch.cat([mx, mx]), prim_index=torch.zeros_like(one))

    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    tri_min = torch.minimum(torch.minimum(v0, v1), v2)
    tri_max = torch.maximum(torch.maximum(v0, v1), v2)
    total = v0 + v1 + v2
    third = torch.full_like(total, 1.0 / 3.0)
    centroid = total * third
    lo = centroid.min(dim=0).values
    hi = centroid.max(dim=0).values
    extent = torch.clamp_min(hi - lo, 1e-12)
    codes = morton3d(_fma32(total, third, -lo.expand_as(total)) / extent)
    codes_sorted, order = torch.sort(codes, stable=True)

    n_int = t - 1
    i = torch.arange(n_int, dtype=torch.int64, device=dev)
    code_i = codes_sorted[:n_int]

    def delta(b):
        """Longest-common-prefix metric between sorted leaves i and b
        (Karras §4); ties on equal codes broken by leaf index. -1 when b
        is out of range."""
        valid = (b >= 0) & (b < t)
        bc = b.clamp(0, t - 1)
        cb = codes_sorted[bc]
        d = torch.where(code_i == cb, 32 + _clz32(i ^ bc), _clz32(code_i ^ cb))
        return torch.where(valid, d, -1)

    # Direction: toward the longer common-prefix neighbour.
    d = torch.sign(delta(i + 1) - delta(i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i - d)

    # Exponential upper bound for the range length.
    l_max = torch.full((n_int,), 2, dtype=torch.int64, device=dev)
    for _ in range(32):
        grow = delta(i + l_max * d) > delta_min
        l_max = torch.where(grow, l_max * 2, l_max)

    # Binary search for the exact other end j.
    ln = torch.zeros_like(l_max)
    step = l_max // 2
    for _ in range(32):
        take = (step > 0) & (delta(i + (ln + step) * d) > delta_min)
        ln = torch.where(take, ln + step, ln)
        step = step // 2
    j = i + ln * d

    # Binary search for the split position (Karras §4 findSplit).
    delta_node = delta(j)
    s = torch.zeros_like(ln)
    div = 2
    for _ in range(32):
        step = (ln + div - 1) // div  # ceil(l / div)
        take = (step > 0) & (delta(i + (s + step) * d) > delta_node)
        s = torch.where(take, s + step, s)
        div *= 2
    gamma = i + s * d + torch.clamp_max(d, 0)

    lo_ij = torch.minimum(i, j)
    hi_ij = torch.maximum(i, j)
    left = torch.where(lo_ij == gamma, n_int + gamma, gamma).to(torch.int32)
    right = torch.where(hi_ij == gamma + 1, n_int + gamma + 1, gamma + 1).to(torch.int32)

    # Boxes: the leaves in sorted order, then a fix-point refit of the
    # internal nodes (one pass per tree level; each pass reads the last).
    tri_min, tri_max = _pad_flat(tri_min, tri_max)
    node_min = torch.cat([torch.full((n_int, 3), float("inf"), device=dev), tri_min[order]])
    node_max = torch.cat([torch.full((n_int, 3), float("-inf"), device=dev), tri_max[order]])
    li, ri = left.long(), right.long()
    for _ in range(256):
        new_min = torch.minimum(node_min[li], node_min[ri])
        new_max = torch.maximum(node_max[li], node_max[ri])
        changed = bool(((new_min != node_min[:n_int]).any()
                        | (new_max != node_max[:n_int]).any()).item())
        node_min = torch.cat([new_min, node_min[n_int:]])
        node_max = torch.cat([new_max, node_max[n_int:]])
        if not changed:
            break
    return Bvh(left=left, right=right, node_min=node_min, node_max=node_max,
               prim_index=order.to(torch.int32))
