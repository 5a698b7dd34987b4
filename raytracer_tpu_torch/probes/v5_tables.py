"""The v5 table layout of the TPU traversal kernel, which the v5-body
probes read (probes/v5_body.py). The port's own copy of
raytracer_tpu/ops/pallas_traverse.py `_pack_tables` (:129-186), its
`_select_record` (:189-197) and the v5 constants (:64-68, :125-126).

Nodes: f32[ceil(n4/4), 128], node n at row n // 4, lanes 32 * (n % 4):
24 child-box bounds (per child min xyz, max xyz), 4 float-encoded child
codes, 4 zero lanes. A 4-wide tree only: the bounds are reshaped to
(n4, 24), so build the scene with RAYTRACER_TPU_BVH_WIDTH=4.

Triangles: f32[rows, 128], eight 16-lane records per row (v0, e1, e2,
float-encoded prim id, float-encoded material id, 5 zero lanes), the
brute-force rows appended after the leaf rows, then one all-zero row that
chains not at a leaf read (its degenerate records fail Möller–Trumbore).
"""

from __future__ import annotations

import numpy as np
import torch

BIG = np.float32(3.0e38)
HALF_BIG = np.float32(1.5e38)  # orders rep-miss (but visited) children last
P_SUB, P_LANE = 8, 128         # chains per packet, lanes per chain
NONE = np.int32(-1)
NODE_STRIDE = 32               # lanes per node record (4 per row)
TRI_STRIDE = 16                # lanes per triangle record (8 per row)


def pack_tables(bvh4, fmat):
    """(node f32[ceil(n4/4),128], tri f32[rows,128], n_leaf_rows,
    n_brute_rows) of a 4-wide Bvh4 and its per-triangle material ids."""
    bounds = np.asarray(bvh4.bounds, np.float32)
    children = np.asarray(bvh4.children, np.int32)
    tri = np.asarray(bvh4.tri, np.float32)
    n4, t = bounds.shape[0], tri.shape[0]
    if children.shape[1] != 4:
        raise ValueError(f"the v5 layout takes a 4-wide tree, got width {children.shape[1]} "
                         "(build with RAYTRACER_TPU_BVH_WIDTH=4)")
    if not (8 * t + 16 < (1 << 24) and 4 * n4 < (1 << 24)):
        raise ValueError("float-encoded table ids exceed exact-f32 range")
    node_vals = np.concatenate(
        [bounds.reshape(n4, 24), children.astype(np.float32),
         np.zeros((n4, NODE_STRIDE - 28), np.float32)], axis=1)
    pad_n = (-n4) % 4
    if pad_n:
        node_vals = np.concatenate([node_vals, np.zeros((pad_n, NODE_STRIDE), np.float32)])
    node = node_vals.reshape(-1, 4 * NODE_STRIDE)

    if t % 8:
        raise ValueError("Bvh4 triangle table must be leaf-row aligned")

    def pack_rows(tri9, prim, mat):
        tt = tri9.shape[0]
        vals = np.concatenate(
            [np.asarray(tri9, np.float32),
             np.asarray(prim).astype(np.float32)[:, None],
             np.asarray(mat).astype(np.float32)[:, None],
             np.zeros((tt, TRI_STRIDE - 11), np.float32)], axis=1)
        return vals.reshape(-1, 8 * TRI_STRIDE)

    rows = [pack_rows(tri, bvh4.prim_index, fmat)]
    n_leaf_rows = rows[0].shape[0]
    if bvh4.brute_tri is not None:
        if bvh4.brute_tri.shape[0] % 8:
            raise ValueError("brute-force set must fill whole rows")
        rows.append(pack_rows(bvh4.brute_tri, bvh4.brute_prim, bvh4.brute_mat))
    rows.append(np.zeros((1, 8 * TRI_STRIDE), np.float32))
    tri_pack = np.concatenate(rows)
    n_brute_rows = tri_pack.shape[0] - 1 - n_leaf_rows
    return torch.from_numpy(node), torch.from_numpy(tri_pack), n_leaf_rows, n_brute_rows


def select_record(row: torch.Tensor, sub: torch.Tensor, n_options: int, stride: int):
    """Record `sub` of each row: row [..., n_options * stride], sub an
    integer tensor of the leading shape in [0, n_options) → [..., stride],
    as `_select_record`'s select chain picks it."""
    rec = row[..., 0:stride]
    for q in range(1, n_options):
        rec = torch.where((sub == q)[..., None], row[..., q * stride:(q + 1) * stride], rec)
    return rec
