"""The differentiable renderer (models/megakernel.py, render.py) ≡ the JAX
package's render_image, and its own invariants.

Against JAX: the cross-compiler tolerance of the ROADMAP (at most 0.5%
of elements beyond 5e-4 + 2e-4·|x|, channel means within 1e-3); on these
frames every element agrees to 2e-7. Within the port: how samples and
rows are batched does not change a pixel (bitwise), the spp-batched
chunked render equals the single pass to float rounding (atol 2e-6),
and the edge-aware term is exactly 0.0 in the forward pass."""

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.render import render_image as jrender_image
from raytracer_tpu.scene.builder import build_scene_bvh4 as jbuild_bvh4
from raytracer_tpu.scene.builder import cornell_materials_scene as jcornell_materials
from raytracer_tpu.scene.builder import cornell_spheres_scene as jcornell_spheres
from raytracer_tpu_torch.camera import make_camera, showcase_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.render import render_image, render_image_chunked
from raytracer_tpu_torch.scene.builder import cornell_materials_scene, cornell_spheres_scene

torch.set_num_threads(2)

ATOL, RTOL, BAD_FRAC, MEAN_TOL = 5e-4, 2e-4, 0.005, 1e-3
INSIDE = dict(position=(0.0, 0.05, 0.29), pitch=-5.0)  # the showcase pose


def _agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    bad = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert bad.mean() <= BAD_FRAC, bad.mean()
    assert np.abs(got.mean(axis=(0, 1)) - want.mean(axis=(0, 1))).max() <= MEAN_TOL


@pytest.mark.parametrize("scene_name,rng_impl", [("cornell_spheres", "jax"),
                                                 ("cornell_materials", "jax"),
                                                 ("cornell_materials", "ktf")])
def test_render_image_matches_jax(scene_name, rng_impl):
    kw = dict(width=12, height=12, spp=4, max_bounces=3, rng_impl=rng_impl)
    if scene_name == "cornell_spheres":
        js, pose = jcornell_spheres(), {}
    else:
        js, pose = jcornell_materials(), INSIDE
        js = js.replace(bvh4=jbuild_bvh4(js.mesh))
    jcam = jmake_camera(aspect_ratio=1.0, fov_degrees=80.0, aperture=1e-6, **pose)
    want = jrender_image(js, jcam, JRenderConfig(**kw), jax.random.key(17))
    got = render_image(scene_from_numpy(to_numpy_tree(js)), camera_from_numpy(to_numpy_tree(jcam)),
                       RenderConfig(**kw), 17)
    _agree(got.numpy(), want)
    assert float(np.asarray(want).mean()) > 0.05


def test_sample_and_row_batching_is_bitwise():
    """One sample per trace, all samples in one trace, and row chunks
    give the same pixels bit for bit (draws are keyed by pixel and
    sample; samples accumulate in index order)."""
    scene = cornell_spheres_scene()
    cfg = RenderConfig(width=10, height=6, spp=3, max_bounces=3, rng_impl="jax")
    cam = make_camera(aspect_ratio=cfg.aspect_ratio, position=(0.0, 0.5, 1.6), pitch=-14.0)
    whole = render_image(scene, cam, cfg, 4)
    per_sample = render_image(scene, cam, cfg.replace(max_rays_per_pass=60), 4)
    assert torch.equal(whole, per_sample)
    chunked = render_image_chunked(scene, cam, cfg.replace(spp_per_pass=3, max_rays_per_pass=20), 4)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("rng_impl", ["jax", "ktf"])
def test_chunked_spp_batches_equal_single_pass(rng_impl):
    scene = cornell_materials_scene()
    cfg = RenderConfig(width=16, height=8, spp=4, max_bounces=4, rng_impl=rng_impl)
    cam = make_camera(aspect_ratio=cfg.aspect_ratio, **INSIDE)
    single = render_image(scene, cam, cfg, 9)
    chunked = render_image_chunked(scene, cam, cfg.replace(spp_per_pass=2, max_rays_per_pass=48), 9)
    torch.testing.assert_close(chunked, single, atol=2e-6, rtol=1e-6)
    assert single.mean() > 0.05


def test_edge_term_forward_is_exactly_zero():
    scene = cornell_materials_scene()
    assert scene.light_rect is not None
    cfg = RenderConfig(width=12, height=12, spp=2, max_bounces=4, reference_emission_quirk=False)
    cam = make_camera(aspect_ratio=1.0, **INSIDE)
    off = render_image(scene, cam, cfg, 11)
    on = render_image(scene, cam, cfg.replace(edge_aware_lights=True), 11)
    assert torch.equal(on, off)
    assert off.mean() > 0.01


def test_light_rect_matches_jax_and_refuses_non_coplanar_lights():
    from raytracer_tpu_torch.scene.builder import fit_light_rect
    from raytracer_tpu_torch.scene.types import DIFFUSE_LIGHT, Materials, TriMesh

    want = np.asarray(jcornell_materials().light_rect)
    np.testing.assert_array_equal(cornell_materials_scene(build_bvh=False).light_rect.numpy(),
                                  want)
    verts = np.float32([[0, 1, 0], [1, 1, 0], [0, 1, 1], [0, 2, 0], [1, 2.5, 0], [0, 2, 1]])
    mesh = TriMesh.from_arrays(verts, [[0, 1, 2], [3, 4, 5]], [0, 0])
    mats = Materials.from_lists([DIFFUSE_LIGHT], [(0, 0, 0)], [(4, 4, 4)])
    with pytest.warns(UserWarning, match="not coplanar"):
        assert fit_light_rect(mesh, mats) is None


def test_cli_megakernel_renders_a_png_on_the_cpu(tmp_path):
    from raytracer_tpu_torch import cli

    out = tmp_path / "m.png"
    npy = tmp_path / "m.npy"
    cli.main(["--device", "cpu", "--integrator", "megakernel", "--scene", "cornell_spheres",
              "--width", "16", "--height", "8", "--spp", "2", "--max-bounces", "3",
              "--out", str(out), "--npy", str(npy)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    img = np.load(npy)
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3)
    want = render_image(cornell_spheres_scene(), showcase_camera(cfg), cfg, 0)
    np.testing.assert_array_equal(img, want.numpy())
