"""raytracer_tpu_torch on a 4-wide tree ≡ the JAX package on the same tree.

RAYTRACER_TPU_BVH_WIDTH=4 is set (monkeypatch) for both builders, which
then leave the native BVH4 unwidened; the kernels of csrc/ are built for
widths 4 and 8 (tests/test_torch_cuda.py holds them to their plain
versions on the card). Tolerances are those of the width-8 tests: the
fused frame as tests/test_torch_fused.py (atol 2e-4 / rtol 1e-4 on all
but one pixel in 500), traversal as tests/test_torch_traverse.py (t within
rtol 1e-4, ids, materials and hits equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fused_ref import materials_scenes, render_pair

from raytracer_tpu.ops.pallas_traverse import trace_closest_pallas
from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu.scene.types import TriMesh as JTriMesh
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import bvh4_from_numpy, to_numpy_tree
from raytracer_tpu_torch.models.fused import fused_available
from raytracer_tpu_torch.ops.bvh4 import BIG
from raytracer_tpu_torch.ops.cuda_traverse import trace_closest
from raytracer_tpu_torch.scene.builder import build_scene_bvh4, cornell_materials_scene
from raytracer_tpu_torch.scene.types import TriMesh
from raytracer_tpu_torch.utils import cudalib

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes4():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAYTRACER_TPU_BVH_WIDTH", "4")
        js, ts = materials_scenes()
    assert ts.bvh4.children.shape[1] == 4 == np.asarray(js.bvh4.children).shape[1]
    return js, ts


def test_plain_fused_matches_jax_fused_at_width4(scenes4):
    """The port's plain path loop ≡ the JAX fused kernel in interpret mode,
    one packet (128x8, spp 2, 4 bounces, seed 21), both on the 4-wide tree."""
    out, ref = render_pair(scenes4, 21, width=128, height=8, spp=2, max_bounces=4)
    close = np.isclose(out, ref, atol=2e-4, rtol=1e-4).all(axis=-1)
    assert (~close).sum() <= close.size // 500, np.argwhere(~close)
    np.testing.assert_allclose(out[close], ref[close], atol=2e-4, rtol=1e-4)


def _mesh(seed=5, t=300, v=220):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-1, 1, (v, 3)).astype(np.float32)
    faces = rng.integers(0, v, (t, 3)).astype(np.int32)
    fmat = rng.integers(0, 5, t).astype(np.int32)
    return verts, faces, fmat


def test_trace_closest_plain_matches_pallas_at_width4(monkeypatch):
    """Both builders' 4-wide trees of one mesh are equal, and the port's
    trace_closest (plain) ≡ trace_closest_pallas(interpret=True) on it."""
    monkeypatch.setenv("RAYTRACER_TPU_BVH_WIDTH", "4")
    verts, faces, fmat = _mesh()
    jb = jbuilder.build_scene_bvh4(JTriMesh(vertices=jnp.asarray(verts), faces=jnp.asarray(faces),
                                            face_mat=jnp.asarray(fmat)))
    tb = build_scene_bvh4(TriMesh.from_arrays(verts, faces, fmat))
    assert tb.children.shape[1] == 4
    conv = bvh4_from_numpy(to_numpy_tree(jb))
    for f in ("bounds", "children", "tri", "prim_index", "face_mat"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), getattr(conv, f).numpy(), err_msg=f)
    rng = np.random.default_rng(105)
    o = rng.uniform(-0.9, 0.9, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    jrec = trace_closest_pallas(jnp.asarray(o), jnp.asarray(d), jb, 3e38, sort=False,
                                interpret=True)
    rec = trace_closest(torch.from_numpy(o), torch.from_numpy(d), tb, BIG, sort=False)
    np.testing.assert_allclose(rec["t"].numpy(), np.asarray(jrec["t"]), rtol=1e-4)
    for k in ("tri_id", "mat_id", "hit"):
        np.testing.assert_array_equal(rec[k].numpy(), np.asarray(jrec[k]), err_msg=k)
    assert rec["hit"].float().mean() > 0.5


def test_fused_available_refuses_other_widths(monkeypatch):
    """A tree widened to 16 gets a clear no (the CLI's SystemExit), not an
    error from inside the kernel binding; 4 and 8 are taken."""
    cfg = RenderConfig(width=16, height=8, spp=1)
    for width, ok in ((4, True), (8, True), (16, False)):
        monkeypatch.setenv("RAYTRACER_TPU_BVH_WIDTH", str(width))
        scene = cornell_materials_scene()
        assert scene.bvh4.children.shape[1] == width
        assert fused_available(scene, cfg) is ok
    with pytest.raises(ValueError, match="width 16"):
        cudalib.bvh_view(scene.bvh4)
    from raytracer_tpu_torch import cli

    with pytest.raises(SystemExit, match="--integrator fused needs"):
        cli.main(["--integrator", "fused", "--scene", "cornell_materials", "--device", "cpu",
                  "--width", "16", "--height", "8", "--spp", "1", "--out", "/dev/null"])
