"""The v6 table layout of the dual-unit traversal probe (probes/v6.py): the
port's own copy of scripts/kernel_v6_probe.py `pack_tables_v6` (:49-91).

Nodes: f32[n4, 128], node n at row n: 24 child-box bounds (per child min
xyz, max xyz), 4 float-encoded child codes — an internal child's node row,
-1 for an empty slot, and for a leaf -(2 + its triangle row), since every
leaf range is one 8-aligned row (ops/bvh4.align_leaves_to_rows) — and 100
zero lanes. A 4-wide tree only (RAYTRACER_TPU_BVH_WIDTH=4).

Triangles: the v5 layout (probes/v5_tables.py): eight 16-lane records per
row, the brute-force rows after the leaf rows, then one all-zero row.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.probes.v5_tables import pack_tables


def pack_tables_v6(bvh4, fmat):
    """(node f32[n4, 128], tri f32[rows, 128], n_leaf_rows, n_brute_rows)
    of a 4-wide Bvh4 and its per-triangle material ids."""
    bounds = np.asarray(bvh4.bounds, np.float32)
    n4 = bounds.shape[0]
    if bounds.shape[1] != 4:
        raise ValueError(f"the v6 layout takes a 4-wide tree, got width {bounds.shape[1]} "
                         "(build with RAYTRACER_TPU_BVH_WIDTH=4)")
    _, tri, n_leaf_rows, n_brute_rows = pack_tables(bvh4, fmat)
    if not (n4 < (1 << 24) and tri.shape[0] < (1 << 24)):
        raise ValueError("float-encoded table ids exceed exact-f32 range")
    ch = np.asarray(bvh4.children).astype(np.int64)
    leaf = ch <= -2
    ch[leaf] = -(2 + (-ch[leaf] - 2) // 64)   # the leaf's triangle row
    node = np.concatenate([bounds.reshape(n4, 24), ch.astype(np.float32),
                           np.zeros((n4, 128 - 28), np.float32)], axis=1)
    return torch.from_numpy(node), tri, n_leaf_rows, n_brute_rows
