"""K4's coherence-sort path in the port ≡ the JAX package's
`trace_closest_pallas(sort=True)` in interpret mode, on a small BVH4.

Port sorted ≡ port unsorted bitwise (one ray per thread in K4, one ray
per lane in its plain version). Against the interpreted Pallas kernel
the decisions (hit, tri_id, mat_id) are exact, and t and the normal
agree to rounding: XLA contracts the interpreted kernel's multiply-adds
(rtol 1e-4 for t, as tests/test_pallas_traverse.py; 1e-5 for the
normal)."""

import jax.numpy as jnp
import numpy as np
import torch

from raytracer_tpu.ops.pallas_traverse import trace_closest_pallas
from raytracer_tpu.scene.native import build_bvh4_native
from raytracer_tpu.scene.types import TriMesh as JTriMesh
from raytracer_tpu_torch.convert import bvh4_from_numpy, to_numpy_tree
from raytracer_tpu_torch.ops.cuda_traverse import trace_closest

torch.set_num_threads(2)


def test_sorted_equals_unsorted_equals_pallas_sort():
    rs = np.random.default_rng(11)
    verts = rs.uniform(-1, 1, (220, 3)).astype(np.float32)
    faces = rs.integers(0, 220, (300, 3)).astype(np.int32)
    fmat = rs.integers(0, 5, 300).astype(np.int32)
    jb4 = build_bvh4_native(JTriMesh(vertices=jnp.asarray(verts), faces=jnp.asarray(faces),
                                     face_mat=jnp.asarray(fmat)))
    b4 = bvh4_from_numpy(to_numpy_tree(jb4))
    assert b4.children.shape[1] == 4
    n = 1024
    o = rs.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    t_max = rs.uniform(-0.5, 3.0, n).astype(np.float32)  # t_max < 0: dead rays

    jrec = trace_closest_pallas(jnp.asarray(o), jnp.asarray(d), jb4, jnp.asarray(t_max),
                                sort=True, interpret=True)
    to, td, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)
    srt = trace_closest(to, td, b4, tt, sort=True)
    uns = trace_closest(to, td, b4, tt, sort=False)
    for k in srt:
        assert torch.equal(srt[k], uns[k]), k
    for k in ("tri_id", "mat_id", "hit"):
        np.testing.assert_array_equal(srt[k].numpy(), np.asarray(jrec[k]), err_msg=k)
    np.testing.assert_allclose(srt["t"].numpy(), np.asarray(jrec["t"]), rtol=1e-4)
    np.testing.assert_allclose(srt["normal"].numpy(), np.asarray(jrec["normal"]),
                               rtol=1e-5, atol=1e-6)
    assert 0.2 < srt["hit"].float().mean() < 0.9
