"""Wide BVH tables and their host-side NumPy construction (port of
raytracer_tpu/ops/bvh4.py).

Child encoding (i32):
    >= 0   → internal node index
    == -1  → empty slot (its box is (+inf, -inf))
    <= -2  → leaf range: code = -(2 + lo*8 + (count-1)), count ∈ 1..8

`compute_stack_depth`, `align_leaves_to_rows`, `widen_bvh` and
`build_bvh4` (the collapse of the binary LBVH, ops/bvh.build_lbvh, into
a 4-wide tree: the builder's fallback when the native builder is
unavailable) are the JAX package's NumPy code unchanged, so both
packages build identical tables. `SORT_PAIRS` are the compare-exchange
networks that order a node's children by entry distance, in the plain
traversal and in the CUDA kernel alike (csrc/traverse.cuh), so both
break ties the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracer_tpu_torch.ops.packets import root_box
from raytracer_tpu_torch.scene.types import tensors_to

BIG = np.float32(3.0e38)
STACK_DEPTH = 48
MAX_LEAF = 8  # triangles per leaf range (one 8-aligned row)


@dataclasses.dataclass(frozen=True)
class Bvh4:
    bounds: torch.Tensor      # f32[N4, K, 6] child boxes (min3, max3); empty slots inf/-inf
    children: torch.Tensor    # i32[N4, K] encoded as above
    tri: torch.Tensor         # f32[T, 9] packed (v0,e1,e2) in SORTED leaf order
    prim_index: torch.Tensor  # i32[T] sorted-slot → original face id (-1 on padding)
    face_mat: Optional[torch.Tensor] = None  # i32[T] material ids in SORTED order
    # Two-level split (scene/builder.partition_brute_faces): the large
    # triangles tested brute-force before traversal. Ids are ORIGINAL
    # face indices; padded slots hold degenerate triangles.
    brute_tri: Optional[torch.Tensor] = None   # f32[Tb, 9], Tb % 8 == 0
    brute_prim: Optional[torch.Tensor] = None  # i32[Tb]
    brute_mat: Optional[torch.Tensor] = None   # i32[Tb]
    stack_depth: int = STACK_DEPTH  # worst-case traversal stack bound
    # K1's cull table of the brute set (ops/cuda_traverse.brute_boxes):
    # f32[Tb+1, 12], made with the brute set by whoever builds the tree
    # (scene/builder.build_scene_bvh4) and carried by `.to(device)`.
    brute_box: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    # The coherence keys' frame (K4-sort): f32[6], lo xyz and 1/extent xyz
    # of the root's children (ops/packets.root_box). Made once, when the
    # tree is made, unless given; carried by `.to(device)`. It sets only the
    # order K4 traces the rays in, never a record.
    sort_box: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    # Which builder made the tree: "native" (scene/native.build_bvh4_native)
    # or "lbvh" (build_bvh4 of ops/bvh.build_lbvh); "" when made by hand.
    builder: str = dataclasses.field(default="", compare=False)

    def __post_init__(self):
        if self.sort_box is None:
            object.__setattr__(self, "sort_box", torch.cat(root_box(self)))

    def to(self, device) -> "Bvh4":
        return tensors_to(self, device)


def compute_stack_depth(children: np.ndarray) -> int:
    """Worst-case traversal stack bound: ≤(width−1) pushes per level on a
    root-to-leaf chain → (width−1) × tree depth (+ slack), rounded up to
    8 and capped at 256."""
    depth = np.zeros(children.shape[0], np.int32)
    maxd = 1
    stack = [0]
    depth[0] = 1
    while stack:
        nid = stack.pop()
        for c in children[nid]:
            if c >= 0:
                depth[c] = depth[nid] + 1
                maxd = max(maxd, int(depth[c]))
                stack.append(int(c))
    bound = (children.shape[1] - 1) * maxd + 4
    return min(int((bound + 7) // 8 * 8), 256)


def _leaf_code(lo: int, count: int) -> int:
    return -(2 + lo * 8 + (count - 1))


def align_leaves_to_rows(children: np.ndarray, tri: np.ndarray,
                         prim_index: np.ndarray, face_mat: np.ndarray):
    """Re-pack sorted triangles so every leaf range starts at a multiple
    of 8. Padding slots hold degenerate triangles (e1=e2=0, rejected by
    Möller–Trumbore at the determinant epsilon) with prim -1.

    Returns (children, tri, prim_index, face_mat) with len(tri) % 8 == 0."""
    ch = children.copy()
    flat = ch.reshape(-1)
    leaf_mask = flat <= -2
    codes = -flat[leaf_mask] - 2
    los = codes // 8
    counts = codes % 8 + 1
    nleaf = los.shape[0]
    order = np.argsort(los, kind="stable")  # preserve sorted-slot locality
    new_tri = np.zeros((8 * nleaf, tri.shape[1]), tri.dtype)
    new_prim = np.full((8 * nleaf,), -1, prim_index.dtype)
    new_fmat = np.zeros((8 * nleaf,), face_mat.dtype)
    new_codes = np.empty((nleaf,), np.int64)
    for i in range(nleaf):
        li = int(order[i])
        lo = int(los[li])
        cnt = int(counts[li])
        new_tri[8 * i:8 * i + cnt] = tri[lo:lo + cnt]
        new_prim[8 * i:8 * i + cnt] = prim_index[lo:lo + cnt]
        new_fmat[8 * i:8 * i + cnt] = face_mat[lo:lo + cnt]
        new_codes[li] = _leaf_code(8 * i, cnt)
    flat[leaf_mask] = new_codes.astype(flat.dtype)
    return ch, new_tri, new_prim, new_fmat


# Sorting networks (compare-exchange pair lists) by width: 4 = the
# 5-comparator optimal net, 8 = bitonic (19 comparators).
SORT_PAIRS = {
    4: ((0, 2), (1, 3), (0, 1), (2, 3), (1, 2)),
    8: ((0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6)),
}


def sort_by_key(keys: torch.Tensor, codes: torch.Tensor):
    """K-element sorting network over the trailing axis (K in SORT_PAIRS):
    keys ascending, `codes` permuted alongside. A swap happens only on a
    strictly greater key, exactly as in csrc/traverse.cuh."""
    kc = list(keys.unbind(-1))
    cc = list(codes.unbind(-1))
    for (i, j) in SORT_PAIRS[keys.shape[-1]]:
        sw = kc[i] > kc[j]
        kc[i], kc[j] = torch.where(sw, kc[j], kc[i]), torch.where(sw, kc[i], kc[j])
        cc[i], cc[j] = torch.where(sw, cc[j], cc[i]), torch.where(sw, cc[i], cc[j])
    return torch.stack(kc, -1), torch.stack(cc, -1)


def widen_bvh(b4: Bvh4, width: int = 8) -> Bvh4:
    """Host-side collapse of a BVH4 into a wider tree (default BVH8) by
    greedily absorbing internal children into their parents (largest
    child box first). Leaf codes and the triangle table are untouched, so
    the result is output-invariant; the stack bound is recomputed."""
    ch = b4.children.numpy()
    b = b4.bounds.numpy()
    kw = ch.shape[1]
    if kw >= width:
        return b4

    def slot_area(bb):
        d = np.maximum(bb[3:6] - bb[0:3], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def expand(node: int):
        slots = [(int(ch[node, k]), b[node, k])
                 for k in range(kw) if ch[node, k] != -1]
        while True:
            best = None
            best_a = -1.0
            for i, (c, bb) in enumerate(slots):
                if c >= 0:
                    nc = int((ch[c] != -1).sum())
                    if len(slots) - 1 + nc <= width:
                        a = slot_area(bb)
                        if a > best_a:
                            best_a = a
                            best = i
            if best is None:
                return slots
            c, _ = slots.pop(best)
            slots.extend((int(ch[c, k]), b[c, k])
                         for k in range(kw) if ch[c, k] != -1)

    kept = {0: 0}
    order = [0]
    rows = {}
    stack = [0]
    while stack:
        node = stack.pop()
        slots = expand(node)
        rows[node] = slots
        for c, _ in slots:
            if c >= 0 and c not in kept:
                kept[c] = len(order)
                order.append(c)
                stack.append(c)

    n = len(order)
    bounds = np.empty((n, width, 6), np.float32)
    bounds[:, :, 0:3] = np.inf
    bounds[:, :, 3:6] = -np.inf
    children = np.full((n, width), -1, np.int32)
    for node in order:
        idx = kept[node]
        for slot, (c, bb) in enumerate(rows[node]):
            bounds[idx, slot] = bb
            children[idx, slot] = kept[c] if c >= 0 else c

    return dataclasses.replace(
        b4,
        bounds=torch.from_numpy(bounds),
        children=torch.from_numpy(children),
        stack_depth=compute_stack_depth(children),
    )


def build_bvh4(mesh, bvh) -> Bvh4:
    """Host-side collapse of the binary LBVH (scene/types.Bvh) of `mesh`
    into a BVH4 with 8-aligned leaf rows (CPU tensors)."""
    face_mat_np = mesh.face_mat.cpu().numpy()
    left = bvh.left.cpu().numpy()
    right = bvh.right.cpu().numpy()
    node_min = bvh.node_min.cpu().numpy()
    node_max = bvh.node_max.cpu().numpy()
    prim_index = bvh.prim_index.cpu().numpy()
    n_int = left.shape[0]
    t = n_int + 1

    # Leaf-slot ranges per binary node (leaves are contiguous in Karras).
    lo = np.zeros(2 * t - 1, np.int64)
    hi = np.zeros(2 * t - 1, np.int64)
    lo[n_int:] = np.arange(t)
    hi[n_int:] = np.arange(t)
    # Internal ranges via fix-point sweeps (depth-bounded).
    for _ in range(64):
        new_lo = np.minimum(lo[left], lo[right])
        new_hi = np.maximum(hi[left], hi[right])
        if (new_lo == lo[:n_int]).all() and (new_hi == hi[:n_int]).all():
            break
        lo[:n_int] = new_lo
        hi[:n_int] = new_hi
    count = hi - lo + 1

    def expand(node: int) -> list:
        """Binary children, splitting internal children once more → ≤4."""
        out = []
        for c in (left[node], right[node]):
            if c >= n_int or count[c] <= MAX_LEAF:
                out.append(int(c))
            else:
                out.extend((int(left[c]), int(right[c])))
        return out

    # DFS from the binary root (0), one BVH4 node per visited binary
    # internal node with count > MAX_LEAF.
    bvh4_id: dict = {}
    order: list = []

    if count[0] <= MAX_LEAF:
        # Tiny mesh: a single root with one leaf-range child.
        bounds = np.full((1, 4, 6), 0, np.float32)
        bounds[:, :, 0:3] = np.inf
        bounds[:, :, 3:6] = -np.inf
        bounds[0, 0, 0:3] = node_min[0]
        bounds[0, 0, 3:6] = node_max[0]
        children = np.full((1, 4), -1, np.int32)
        children[0, 0] = _leaf_code(int(lo[0]), int(count[0]))
    else:
        queue = [0]
        bvh4_id[0] = 0
        order.append(0)
        while queue:
            node = queue.pop()
            for c in expand(node):
                if c < n_int and count[c] > MAX_LEAF and c not in bvh4_id:
                    bvh4_id[c] = len(order)
                    order.append(c)
                    queue.append(c)

        n4 = len(order)
        bounds = np.empty((n4, 4, 6), np.float32)
        bounds[:, :, 0:3] = np.inf
        bounds[:, :, 3:6] = -np.inf
        children = np.full((n4, 4), -1, np.int32)
        for idx, node in enumerate(order):
            for slot, c in enumerate(expand(node)):
                bounds[idx, slot, 0:3] = node_min[c]
                bounds[idx, slot, 3:6] = node_max[c]
                if c >= n_int:
                    children[idx, slot] = _leaf_code(int(lo[c]), 1)
                elif count[c] <= MAX_LEAF:
                    children[idx, slot] = _leaf_code(int(lo[c]), int(count[c]))
                else:
                    children[idx, slot] = bvh4_id[c]

    # Triangle data in sorted leaf order, leaf rows 8-aligned.
    verts = mesh.vertices.cpu().numpy()
    faces = mesh.faces.cpu().numpy()[prim_index]
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0

    tri = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
    children, tri, prim_al, fmat_al = align_leaves_to_rows(
        children, tri, prim_index.astype(np.int32),
        face_mat_np[prim_index].astype(np.int32))
    return Bvh4(
        bounds=torch.from_numpy(bounds),
        children=torch.from_numpy(children),
        tri=torch.from_numpy(tri),
        prim_index=torch.from_numpy(prim_al),
        face_mat=torch.from_numpy(fmat_al),
        stack_depth=compute_stack_depth(children),
        builder="lbvh",
    )
