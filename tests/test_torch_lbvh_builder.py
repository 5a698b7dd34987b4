"""raytracer_tpu_torch's LBVH collapse (ops/bvh4.build_bvh4) and the
scene builder's fallback to it ≡ the JAX package's, bit for bit.

The mesh is the Cornell box with an icosphere of 5,120 triangles inside:
the builder splits the box's 32 large triangles off into the brute set
and builds the tree over the sphere, as it does for the reference scene
(Cornell box + bunny). Both packages' native builders are made to fail;
the widened trees, their brute sets and the remapped ids must be equal.
Every tree here has 5,120 triangles, so JAX compiles its build once."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops.bvh import build_lbvh as jbuild_lbvh
from raytracer_tpu.ops.bvh4 import build_bvh4 as jbuild_bvh4
from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu.scene import native as jnative
from raytracer_tpu.scene.types import TriMesh as JTriMesh
from raytracer_tpu_torch.ops.bvh import build_lbvh
from raytracer_tpu_torch.ops.bvh4 import build_bvh4
from raytracer_tpu_torch.scene import builder, native
from raytracer_tpu_torch.scene.assets import _icosphere
from raytracer_tpu_torch.scene.obj_io import load_scene_objs
from raytracer_tpu_torch.scene.types import TriMesh

torch.set_num_threads(2)

TREE_FIELDS = ("bounds", "children", "tri", "prim_index", "face_mat")
BRUTE_FIELDS = ("brute_tri", "brute_prim", "brute_mat")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(jt, tt, fields):
    for f in fields:
        want, got = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert want.dtype == got.dtype and want.shape == got.shape, f
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f)
    assert jt.stack_depth == tt.stack_depth


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh) of the Cornell box with an icosphere inside,
    and the same pair for the tree half (the brute set split off)."""
    box, _ = load_scene_objs([builder.ASSETS_DIR + "/CornellBox-Original.obj"])
    sv, sf = _icosphere(4)
    sv = (sv * 0.08 + np.asarray([0.05, 0.12, 0.02])).astype(np.float32)
    bv = box.vertices.numpy()
    verts = np.concatenate([bv, sv]).astype(np.float32)
    faces = np.concatenate([box.faces.numpy(), sf + bv.shape[0]]).astype(np.int32)
    fmat = np.concatenate([box.face_mat.numpy(), np.full(len(sf), 3)]).astype(np.int32)
    tm = TriMesh.from_arrays(verts, faces, fmat)
    brute, tree = builder.partition_brute_faces(tm)
    assert len(brute) == 32 and len(tree) == 5120

    def pair(f, m):
        return (JTriMesh(vertices=jnp.asarray(verts), faces=jnp.asarray(f),
                         face_mat=jnp.asarray(m)), TriMesh.from_arrays(verts, f, m))

    return pair(faces, fmat), pair(faces[tree], fmat[tree])


@pytest.fixture
def native_down(monkeypatch):
    """Both packages' native builders fail as a missing toolchain would."""
    def port_fails(*a, **k):
        raise native.NativeUnavailable("g++ not found (test)")

    def jax_fails(*a, **k):
        raise RuntimeError("g++ not found (test)")

    monkeypatch.setattr(native, "build_bvh4_native", port_fails)
    monkeypatch.setattr(jnative, "build_bvh4_native", jax_fails)


def test_build_bvh4_matches_jax_collapse(meshes):
    _, (jsub, tsub) = meshes
    jb = jbuild_lbvh(jsub)
    tb = build_lbvh(tsub)
    np.testing.assert_array_equal(tb.left.numpy(), np.asarray(jb.left))
    j4, t4 = jbuild_bvh4(jsub, jb), build_bvh4(tsub, tb)
    _assert_same(j4, t4, TREE_FIELDS)
    assert t4.builder == "lbvh" and t4.children.shape[1] == 4


@pytest.mark.parametrize("width", [8, 4])
def test_builder_fallback_matches_jax(meshes, native_down, width):
    (jm, tm), _ = meshes
    with builder.tree_width(width):
        want = jbuilder.build_scene_bvh4(jm)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = builder.build_scene_bvh4(tm)
    assert any("native builder is unavailable" in str(w.message)
               and "g++ not found (test)" in str(w.message) for w in caught)
    assert got.builder == "lbvh" and got.children.shape[1] == width
    _assert_same(want, got, TREE_FIELDS + BRUTE_FIELDS)
    prim = got.prim_index.numpy()
    assert set(prim[prim >= 0]) == set(range(32, 32 + 5120))  # ids remapped to the mesh's
    assert got.brute_box is not None and got.brute_box.shape == (got.brute_tri.shape[0] + 1, 12)


def test_builder_takes_the_native_tree_when_it_builds(meshes):
    (_, tm), _ = meshes
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert builder.build_scene_bvh4(tm).builder == "native"


def test_fallback_catches_only_native_unavailable(meshes, monkeypatch):
    (_, tm), _ = meshes

    def broken(*a, **k):
        raise ValueError("a fault in the builder, not an unavailable toolchain")

    monkeypatch.setattr(native, "build_bvh4_native", broken)
    with pytest.raises(ValueError, match="a fault"):
        builder.build_scene_bvh4(tm)


def test_missing_native_source_is_native_unavailable(meshes, monkeypatch, tmp_path):
    (_, tm), _ = meshes
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    with pytest.raises(native.NativeUnavailable, match="source missing"):
        native.build_bvh4_native(tm)
    assert issubclass(native.NativeUnavailable, RuntimeError)
