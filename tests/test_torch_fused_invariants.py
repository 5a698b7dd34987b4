"""raytracer_tpu_torch fused path loop: the invariants the TPU suite holds
bitwise (host chunking, lane layout), the spp split, the CPU dispatch
rule of the wrapper, and the preflight known answer on the reference
scene (assets/expected_preflight.json), all through the plain version."""

import json

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.camera import showcase_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.fused import fused_available, render_image_fused
from raytracer_tpu_torch.ops import cuda_megakernel
from raytracer_tpu_torch.schedule import _tiled_pixel_grid, blocked_pixel_grid
from raytracer_tpu_torch.scene.builder import cornell_materials_scene, reference_scene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return cornell_materials_scene()


def test_fused_available(scene):
    assert fused_available(scene, RenderConfig(width=128, height=8))
    assert not fused_available(scene.replace(bvh4=None), RenderConfig(width=128, height=8))


def test_host_chunked_matches_whole(scene):
    cfg = RenderConfig(width=128, height=64, spp=1, max_bounces=3)
    cam = showcase_camera(cfg)
    px, py, _ = _tiled_pixel_grid(cfg)
    whole = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py)
    chunked = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py,
                                                 host_chunk_packets=3)
    assert torch.equal(whole, chunked)


def test_blocked_grid_matches_strip_grid(scene):
    cfg = RenderConfig(width=128, height=32, spp=1, max_bounces=3)
    cam = showcase_camera(cfg)
    px, py, inv = _tiled_pixel_grid(cfg)
    strip = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 6, px, py)[inv]
    px2, py2, inv2 = blocked_pixel_grid(cfg, 32, 32, 8, 16)
    blk = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 6, px2, py2)[inv2]
    assert torch.equal(strip, blk)


def test_spp_batched_matches_single_pass(scene):
    """sample_offset keying: spp split across passes is invariant
    (tests/test_fused_megakernel.py:180 tolerance)."""
    cfg1 = RenderConfig(width=128, height=8, spp=4, max_bounces=4, spp_per_pass=4)
    cfg2 = cfg1.replace(spp_per_pass=2)
    cfg3 = cfg1.replace(spp_per_pass=3)
    a = render_image_fused(scene, showcase_camera(cfg1), cfg1, 9)
    b = render_image_fused(scene, showcase_camera(cfg2), cfg2, 9)
    c = render_image_fused(scene, showcase_camera(cfg3), cfg3, 9)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version(scene):
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=2)
    calls = cuda_megakernel.PLAIN_CALLS["render_plain"]
    launches = cuda_megakernel.LAUNCHES["render_fused"]
    img = render_image_fused(scene, showcase_camera(cfg), cfg, 0)
    plain = render_image_fused(scene, showcase_camera(cfg), cfg, 0, plain=True)
    assert torch.equal(img, plain)
    assert cuda_megakernel.PLAIN_CALLS["render_plain"] == calls + 2
    assert cuda_megakernel.LAUNCHES["render_fused"] == launches


def test_preflight_known_answer():
    """128x40, spp 2, mb 12, showcase camera, seed 0 on the reference
    scene: mean within 1e-3 relative of the committed ktf mean."""
    with open("assets/expected_preflight.json") as f:
        expected = json.load(f)["mean_rgb_ktf"]
    cfg = RenderConfig(width=128, height=40, spp=2, max_bounces=12)
    img = render_image_fused(reference_scene(), showcase_camera(cfg), cfg, 0)
    assert img.shape == (40, 128, 3) and bool(torch.isfinite(img).all())
    assert abs(img.mean().item() - expected) <= 1e-3 * expected


def test_cli_renders_a_png_on_the_cpu(tmp_path):
    from raytracer_tpu_torch import cli

    out = tmp_path / "r.png"
    npy = tmp_path / "r.npy"
    cli.main(["--device", "cpu", "--integrator", "fused", "--scene", "cornell_materials",
              "--width", "32", "--height", "16", "--spp", "1", "--max-bounces", "3",
              "--out", str(out), "--npy", str(npy)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.load(npy).shape == (16, 32, 3)
    with pytest.raises(SystemExit, match="needs a bvh4 scene"):
        cli.main(["--device", "cpu", "--integrator", "fused", "--scene", "cornell_spheres",
                  "--width", "8", "--height", "8", "--spp", "1", "--out", str(out)])
