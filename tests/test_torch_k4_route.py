"""K4-sort's route in the port: the coherence keys ≡ the JAX package's,
the int32 keys sort as the uint32 ones, K4 through a permutation
(trace_closest_plain(perm=), the kernel's plain version) ≡ the unsorted
record, and the sort box the tree carries.

The keys are integers and the records come from one plain traversal per
ray, so every comparison is exact. The kernels themselves (the key kernel
and K4 through perm) are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops.packets import _coherence_keys
from raytracer_tpu_torch.ops.bvh4 import BIG
from raytracer_tpu_torch.ops.cuda_traverse import (RECORD, sort_perm, trace_closest,
                                                   trace_closest_plain)
from raytracer_tpu_torch.ops.packets import coherence_keys, coherence_keys32, root_box
from raytracer_tpu_torch.scene.builder import build_scene_bvh4, tree_width
from raytracer_tpu_torch.scene.types import TriMesh

torch.set_num_threads(2)


def _mesh():
    """300 small triangles and two large ones, which the builder splits
    off into the brute set."""
    rng = np.random.default_rng(9)
    verts = 0.3 * rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (300, 3)).astype(np.int32)
    big = np.float32([[-2, -0.5, -2], [2, -0.5, -2], [0, -0.5, 2.5],
                      [-2, 0.9, 2], [2, 0.9, 2], [0, 0.9, -2.5]])
    verts = np.concatenate([verts, big])
    faces = np.concatenate([faces, [[300, 301, 302], [303, 304, 305]]]).astype(np.int32)
    fmat = rng.integers(0, 5, faces.shape[0]).astype(np.int32)
    return TriMesh(vertices=torch.from_numpy(verts), faces=torch.from_numpy(faces),
                   face_mat=torch.from_numpy(fmat))


@pytest.fixture(scope="module", params=[4, 8])
def tree(request):
    with tree_width(request.param):
        bvh = build_scene_bvh4(_mesh())
    assert bvh.children.shape[1] == request.param and bvh.brute_tri is not None
    return bvh


def _rays(seed, n, box):
    """Rays with -0.0 direction components, origins outside the sort box,
    on its faces and at its corners."""
    rng = np.random.default_rng(seed)
    lo, hi = box[0:3].numpy(), box[0:3].numpy() + 1.0 / box[3:6].numpy()
    o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    q = n // 8
    d[np.arange(q), rng.integers(0, 3, q)] = -0.0
    d[q:2 * q, 1] = 0.0
    axis = rng.integers(0, 3, q)
    face = np.where(rng.uniform(size=q) < 0.5, lo[axis], hi[axis])
    o[2 * q + np.arange(q), axis] = face.astype(np.float32)
    o[3 * q] = lo
    o[3 * q + 1] = hi
    return o, d


def test_coherence_keys_match_jax_at_corners(tree):
    box = tree.sort_box
    o, d = _rays(1, 4096, box)
    assert (np.signbit(d) & (d == 0)).any()
    want = np.asarray(_coherence_keys(jnp.asarray(o), jnp.asarray(d), jnp.asarray(box[0:3]),
                                      jnp.asarray(box[3:6])))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = coherence_keys(to, td, box[0:3], box[3:6]).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    k32 = coherence_keys32(to, td, box[0:3], box[3:6])
    assert k32.dtype == torch.int32
    np.testing.assert_array_equal(k32.numpy().view(np.uint32) ^ np.uint32(0x80000000), want)


def test_int32_keys_sort_as_int64(tree):
    box = tree.sort_box
    o, d = (torch.from_numpy(x) for x in _rays(2, 8192, box))
    k64 = coherence_keys(o, d, box[0:3], box[3:6])
    k32 = coherence_keys32(o, d, box[0:3], box[3:6])
    assert int(k64.max()) >= 2**31 > int(k64.min())   # both halves of the uint32 range
    p32 = torch.argsort(k32, stable=True)
    assert torch.equal(p32, torch.argsort(k64, stable=True))
    assert torch.equal(p32, sort_perm(o, d, tree))
    # Equal keys keep the call order: the stable sort of a key of many ties.
    few = k32 % 7
    assert torch.equal(torch.argsort(few, stable=True), torch.argsort(few.long(), stable=True))


@pytest.mark.parametrize("limit", ["scalar", "per_ray"])
@pytest.mark.parametrize("perm_kind", ["identity", "reversed", "random", "coherence"])
def test_trace_through_perm_equals_unsorted(tree, perm_kind, limit):
    n = 1500
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    # Per ray: a quarter dead (t_max <= t_min), the rest capped or open.
    t_max = (float(BIG) if limit == "scalar" else
             torch.from_numpy(np.where(rng.uniform(size=n) < 0.25, -1.0,
                                       rng.uniform(0.05, 3.0, n)).astype(np.float32)))
    perm = {"identity": torch.arange(n), "reversed": torch.arange(n - 1, -1, -1),
            "random": torch.from_numpy(rng.permutation(n)),
            "coherence": sort_perm(o, d, tree)}[perm_kind]
    got = trace_closest_plain(o, d, tree, t_max, perm=perm)
    want = trace_closest(o, d, tree, t_max, sort=False)
    for k in RECORD:
        assert torch.equal(got[k], want[k]), k
    assert 0.1 < want["hit"].float().mean() < 0.9
    if limit == "per_ray":
        assert not want["hit"][t_max <= 1e-3].any()


def test_sort_box_is_carried(tree):
    lo, inv = root_box(tree)
    assert torch.equal(tree.sort_box, torch.cat([lo, inv]))
    moved = tree.to("cpu")
    assert moved is not tree and torch.equal(moved.sort_box, tree.sort_box)
    given = type(tree)(bounds=tree.bounds, children=tree.children, tri=tree.tri,
                       prim_index=tree.prim_index, sort_box=torch.zeros(6))
    assert torch.equal(given.sort_box, torch.zeros(6))
