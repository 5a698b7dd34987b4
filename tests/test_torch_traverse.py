"""raytracer_tpu_torch traversal (plain version of K1/K4) ≡ brute force
and ≡ the JAX Pallas traversal kernel in interpret mode.

Tolerances follow tests/test_pallas_traverse.py: t within rtol 1e-4 of
brute force (the [N,T] brute force associates the Möller–Trumbore terms
differently), ids equal wherever there is a hit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops.bvh import build_lbvh
from raytracer_tpu.ops.bvh4 import build_bvh4
from raytracer_tpu.ops.pallas_traverse import trace_closest_pallas
from raytracer_tpu.ops.triangle import intersect_tris_brute as jax_brute
from raytracer_tpu.scene.types import TriMesh as JTriMesh
from raytracer_tpu_torch.convert import bvh4_from_numpy, to_numpy_tree
from raytracer_tpu_torch.ops.bvh4 import BIG
from raytracer_tpu_torch.ops.cuda_traverse import trace_closest, trace_closest_plain
from raytracer_tpu_torch.ops.triangle import intersect_tris_brute
from raytracer_tpu_torch.scene.builder import build_scene_bvh4, reference_scene
from raytracer_tpu_torch.scene.types import TriMesh

torch.set_num_threads(2)


def _random_mesh(seed, t=300, v=220):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-1, 1, (v, 3)).astype(np.float32)
    faces = rng.integers(0, v, (t, 3)).astype(np.int32)
    fmat = rng.integers(0, 5, t).astype(np.int32)
    return verts, faces, fmat


def _rays(seed, n):
    rng = np.random.default_rng(100 + seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def _check_vs_brute(rec, tb, ib):
    tb, ib = np.asarray(tb), np.asarray(ib)
    np.testing.assert_allclose(rec["t"].numpy(), tb, rtol=1e-4)
    hit = tb < 1e30
    np.testing.assert_array_equal(rec["hit"].numpy(), hit)
    np.testing.assert_array_equal(rec["tri_id"].numpy()[hit], ib[hit])


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_and_brute_force(seed):
    verts, faces, fmat = _random_mesh(seed)
    jmesh = JTriMesh(vertices=jnp.asarray(verts), faces=jnp.asarray(faces),
                     face_mat=jnp.asarray(fmat))
    jb4 = build_bvh4(jmesh, build_lbvh(jmesh))
    o, d = _rays(seed, 1024)
    jrec = trace_closest_pallas(jnp.asarray(o), jnp.asarray(d), jb4, 3e38, sort=False,
                                interpret=True)
    tb, ib = jax_brute(jnp.asarray(o), jnp.asarray(d), jmesh.vertices, jmesh.faces, 1e-3, 3e38)

    # Same BVH4 tables in the port (handed over through convert.py).
    b4 = bvh4_from_numpy(to_numpy_tree(jb4))
    rec = trace_closest(torch.from_numpy(o), torch.from_numpy(d), b4, BIG)
    _check_vs_brute(rec, tb, ib)
    # XLA contracts the interpreted kernel's multiply-adds differently, so
    # t agrees to rounding (rtol 1e-4, as against brute force); the
    # decisions — hit, id, material — agree exactly.
    np.testing.assert_allclose(rec["t"].numpy(), np.asarray(jrec["t"]), rtol=1e-4)
    for k in ("tri_id", "mat_id", "hit"):
        np.testing.assert_array_equal(rec[k].numpy(), np.asarray(jrec[k]), err_msg=k)
    np.testing.assert_allclose(rec["normal"].numpy(), np.asarray(jrec["normal"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rec["mat_id"].numpy()[rec["hit"].numpy()],
                                  fmat[rec["tri_id"].numpy()][rec["hit"].numpy()])

    # The port's own BVH8 (native builder + widening) over the same mesh.
    b8 = build_scene_bvh4(TriMesh.from_arrays(verts, faces, fmat))
    assert b8.children.shape[1] == 8
    _check_vs_brute(trace_closest(torch.from_numpy(o), torch.from_numpy(d), b8, BIG), tb, ib)


def test_respects_t_max_and_dead_lanes():
    verts, faces, fmat = _random_mesh(2)
    b8 = build_scene_bvh4(TriMesh.from_arrays(verts, faces, fmat))
    o, d = (torch.from_numpy(x) for x in _rays(2, 1500))
    full = trace_closest_plain(o, d, b8, BIG)
    cap = torch.full((1500,), 1.5)
    cap[::7] = -1.0  # dead lanes
    capped = trace_closest_plain(o, d, b8, cap)
    tf, tc = full["t"].numpy(), capped["t"].numpy()
    dead = np.zeros(1500, bool)
    dead[::7] = True
    assert not capped["hit"].numpy()[dead].any()
    assert (tc[dead] == np.float32(BIG)).all()
    live = ~dead
    assert ((tc[live] == np.float32(BIG)) | (tc[live] < 1.5)).all()
    inside = live & (tf < 1.5)
    np.testing.assert_array_equal(tc[inside], tf[inside])
    np.testing.assert_array_equal(capped["tri_id"].numpy()[inside], full["tri_id"].numpy()[inside])


def test_two_level_scene_matches_brute_force():
    """The reference scene: brute-force pre-pass (32 rows) + BVH8 over
    the bunny, against all-pairs over the 82k-triangle mesh."""
    scene = reference_scene()
    rng = np.random.default_rng(9)
    n = 192
    o = np.tile(np.float32([[0.0, 0.05, 0.29]]), (n, 1))
    o[n // 2:] = rng.uniform(-0.25, 0.25, (n // 2, 3))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 4] = np.float32([0.05, -0.2, -1.0]) + 0.05 * d[: n // 4]  # toward the bunny
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    rec = trace_closest(o_t, d_t, scene.bvh4, BIG)
    tb, ib = intersect_tris_brute(o_t, d_t, scene.mesh.vertices, scene.mesh.faces, 1e-3, BIG)
    _check_vs_brute(rec, tb.numpy(), ib.numpy())
    hit = rec["hit"].numpy()
    assert hit.mean() > 0.5
    fm = scene.mesh.face_mat.numpy()
    np.testing.assert_array_equal(rec["mat_id"].numpy()[hit], fm[rec["tri_id"].numpy()[hit]])


def test_kernels_take_only_bvh8():
    """The CUDA kernels are built for widths 4 and 8: a BVH4 (the JAX
    builder's LBVH collapse, through convert.py) and the port's BVH8 pass
    bvh_view's width check and stop only at the CPU-tensor check, while a
    tree widened to 16 is refused before any launch."""
    from raytracer_tpu_torch.ops.bvh4 import widen_bvh
    from raytracer_tpu_torch.utils import cudalib

    verts, faces, fmat = _random_mesh(3)
    jmesh = JTriMesh(vertices=jnp.asarray(verts), faces=jnp.asarray(faces),
                     face_mat=jnp.asarray(fmat))
    b4 = bvh4_from_numpy(to_numpy_tree(build_bvh4(jmesh, build_lbvh(jmesh))))
    assert b4.children.shape[1] == 4
    b8 = build_scene_bvh4(TriMesh.from_arrays(verts, faces, fmat))
    assert b8.children.shape[1] == 8
    for b in (b4, b8):
        with pytest.raises(ValueError, match="CUDA tensor"):
            cudalib.bvh_view(b)
    b16 = widen_bvh(b4, 16)
    assert b16.children.shape[1] == 16
    with pytest.raises(ValueError, match="width 16"):
        cudalib.bvh_view(b16)
