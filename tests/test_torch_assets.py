"""raytracer_tpu_torch/scene/assets.py ≡ the JAX package's asset writers,
byte for byte, and ≡ the files committed under assets/models.

`ensure_assets` writes only the files that are missing, so the
repository's own directory is never written; a scene built from
generated assets equals the one built from the committed files."""

import os

import numpy as np
import pytest
import torch

from raytracer_tpu.scene import assets as jassets
from raytracer_tpu_torch.scene import assets, builder

torch.set_num_threads(2)

FILES = ("CornellBox-Original.obj", "CornellBox-Original.mtl", "bunny.obj")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Both packages' writers, each into a directory of its own."""
    port, jax = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    paths = assets.ensure_assets(str(port))
    jassets.ensure_assets(str(jax))
    return port, jax, paths


@pytest.mark.parametrize("name", FILES)
def test_writers_match_jax_and_the_committed_files(generated, name):
    port, jax, _ = generated
    got = _read(port / name)
    assert got == _read(jax / name)
    assert got == _read(os.path.join(builder.ASSETS_DIR, name))


def test_ensure_assets_returns_the_paths(generated):
    port, _, paths = generated
    assert paths == {"cornell": str(port / "CornellBox-Original.obj"),
                     "bunny": str(port / "bunny.obj")}


def test_icosphere_matches_jax():
    for subdiv in (0, 2):
        v, f = assets._icosphere(subdiv)
        jv, jf = jassets._icosphere(subdiv)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
        assert f.shape == (20 * 4 ** subdiv, 3)


def test_ensure_assets_writes_only_missing_files(tmp_path):
    cornell = tmp_path / "CornellBox-Original.obj"
    cornell.write_text("# a scene of the user's own\n")
    assets.ensure_assets(str(tmp_path))
    assert cornell.read_text() == "# a scene of the user's own\n"
    assert not (tmp_path / "CornellBox-Original.mtl").exists()
    bunny = tmp_path / "bunny.obj"
    assert bunny.is_file()
    stamp = bunny.stat().st_mtime_ns
    assets.ensure_assets(str(tmp_path))
    assert bunny.stat().st_mtime_ns == stamp


def test_the_repository_directory_is_not_written():
    stamps = {n: os.stat(os.path.join(builder.ASSETS_DIR, n)).st_mtime_ns for n in FILES}
    assets.ensure_assets(builder.ASSETS_DIR)
    builder.cornell_materials_scene(build_bvh=False)
    assert stamps == {n: os.stat(os.path.join(builder.ASSETS_DIR, n)).st_mtime_ns
                      for n in FILES}


def test_reference_scene_builds_from_generated_assets(generated):
    port, _, _ = generated
    got = builder.reference_scene(str(port))
    want = builder.reference_scene()
    for f in ("vertices", "faces", "face_mat"):
        assert torch.equal(getattr(got.mesh, f), getattr(want.mesh, f)), f
    for f in ("bounds", "children", "tri", "prim_index", "brute_tri"):
        assert torch.equal(getattr(got.bvh4, f), getattr(want.bvh4, f)), f
    assert got.mesh.num_tris == 81952 and got.bvh4.builder == "native"
