"""raytracer_tpu_torch scene pipeline ≡ the JAX builder, table for table.

The port loads the OBJ files, builds the native SAH BVH4 from the same
`native/scenekit.cpp`, widens it to BVH8 and splits off the brute-force
faces on its own (no JAX on the machine with the card); every table must
equal the JAX builder's bitwise."""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu_torch.convert import scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.scene import builder as tbuilder

torch.set_num_threads(2)

BVH_FIELDS = ("bounds", "children", "tri", "prim_index", "face_mat",
              "brute_tri", "brute_prim", "brute_mat")


def _eq(t, j, what):
    if j is None:
        assert t is None, what
        return
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_scene_equal(ts, js, jbvh):
    for part in ("materials", "spheres"):
        for f in dataclasses.fields(getattr(js, part)):
            _eq(getattr(getattr(ts, part), f.name), getattr(getattr(js, part), f.name),
                f"{part}.{f.name}")
    for f in ("vertices", "faces", "face_mat", "normals", "uvs"):
        _eq(getattr(ts.mesh, f), getattr(js.mesh, f), f"mesh.{f}")
    for f in BVH_FIELDS:
        _eq(getattr(ts.bvh4, f), getattr(jbvh, f), f"bvh4.{f}")
    assert ts.bvh4.stack_depth == jbvh.stack_depth
    assert ts.name == js.name


@pytest.fixture(scope="module")
def jax_reference():
    return jbuilder.reference_scene("assets/models")


@pytest.fixture(scope="module")
def torch_reference():
    return tbuilder.reference_scene()


def test_reference_scene_tables_bitwise(jax_reference, torch_reference):
    _assert_scene_equal(torch_reference, jax_reference, jax_reference.bvh4)
    b = torch_reference.bvh4
    assert b.children.shape == (3648, 8) and b.tri.shape[0] == 111840
    assert b.brute_tri.shape[0] == 32 and b.stack_depth == 64


def test_cornell_materials_tables_bitwise():
    js = jbuilder.cornell_materials_scene("assets/models")
    jbvh = jbuilder.build_scene_bvh4(js.mesh)
    ts = tbuilder.cornell_materials_scene()
    _assert_scene_equal(ts, js, jbvh)
    assert ts.bvh4.brute_tri is None  # too few faces to split


def test_cornell_without_bunny_tables_bitwise():
    js = jbuilder.reference_scene("assets/models", with_bunny=False)
    ts = tbuilder.reference_scene(with_bunny=False)
    _assert_scene_equal(ts, js, js.bvh4)


def test_cornell_spheres_scene_matches():
    js, ts = jbuilder.cornell_spheres_scene(), tbuilder.cornell_spheres_scene()
    for part in ("materials", "spheres"):
        for f in dataclasses.fields(getattr(js, part)):
            _eq(getattr(getattr(ts, part), f.name), getattr(getattr(js, part), f.name), f.name)
    assert ts.bvh4 is None


def test_partition_brute_faces_matches(jax_reference, torch_reference):
    jb, jt = jbuilder.partition_brute_faces(jax_reference.mesh)
    tb, tt = tbuilder.partition_brute_faces(torch_reference.mesh)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tt, jt)


def test_convert_hands_the_jax_scene_over(jax_reference, torch_reference):
    conv = scene_from_numpy(to_numpy_tree(jax_reference))
    _assert_scene_equal(conv, jax_reference, jax_reference.bvh4)
    moved = conv.to("cpu")
    assert moved.bvh4.stack_depth == conv.bvh4.stack_depth


def test_missing_asset_raises(tmp_path):
    """Missing assets are generated (scene/assets.ensure_assets, as in the
    JAX builder); a directory that cannot hold them raises."""
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    with pytest.raises(OSError):
        tbuilder.reference_scene(str(blocker), build_bvh=False)
    d = tmp_path / "models"
    scene = tbuilder.reference_scene(str(d), with_bunny=False, build_bvh=False)
    assert (d / "CornellBox-Original.obj").is_file() and (d / "bunny.obj").is_file()
    assert scene.name == "cornell" and scene.mesh.num_tris == 32
