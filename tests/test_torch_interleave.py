"""The G = 2 fused path loop (K5) on the CPU: the interleave switch and
its argument rules, the plain version it takes there, and the JAX
package's G = 2 kernel (interpret mode) against the port's render.

K5 equals K3 per lane, so its plain version is K3's (`_render_plain`);
the kernel itself is held to K3 bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 11)."""

import jax
import numpy as np
import pytest
import torch
from torch_fused_ref import materials_scenes

from raytracer_tpu.camera import showcase_camera as jshowcase
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.models.wavefront import _tiled_pixel_grid as j_tiled_pixel_grid
from raytracer_tpu.ops.pallas_megakernel import render_tiles_fused as jrender_tiles_fused
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.camera import showcase_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.fused import render_image_fused
from raytracer_tpu_torch.ops import cuda_megakernel
from raytracer_tpu_torch.schedule import _tiled_pixel_grid
from raytracer_tpu_torch.scene.builder import cornell_materials_scene

torch.set_num_threads(2)
ENV = "RAYTRACER_TPU_INTERLEAVE"


@pytest.fixture(scope="module")
def scene():
    return cornell_materials_scene()


def test_interleave_switch(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert cuda_megakernel._default_interleave() == 1
    for value, g in (("1", 1), ("2", 2)):
        monkeypatch.setenv(ENV, value)
        assert cuda_megakernel._default_interleave() == g
    for value in ("0", "3", "two"):
        monkeypatch.setenv(ENV, value)
        with pytest.raises(ValueError):
            cuda_megakernel._default_interleave()


def test_interleave_argument_rules(scene, monkeypatch):
    cfg = RenderConfig(width=128, height=8, spp=1, max_bounces=2)
    cam = showcase_camera(cfg)
    px, py, _ = _tiled_pixel_grid(cfg)

    def render(**kw):
        return cuda_megakernel.render_tiles_fused(scene, cam, cfg, 0, px, py, **kw)

    monkeypatch.delenv(ENV, raising=False)
    for bad in (0, 3):
        with pytest.raises(ValueError, match="interleave"):
            render(interleave=bad)
    with pytest.raises(ValueError, match="interleave=1"):
        render(profile=True, interleave=2)
    monkeypatch.setenv(ENV, "2")
    with pytest.raises(ValueError, match="interleave=1"):
        render(profile=True)
    assert len(render(profile=True, interleave=1)) == 3
    monkeypatch.setenv(ENV, "5")
    with pytest.raises(ValueError, match="interleave"):
        render()


def test_cpu_interleave2_takes_the_plain_version(scene, monkeypatch):
    cfg = RenderConfig(width=32, height=32, spp=1, max_bounces=3)
    cam = showcase_camera(cfg)
    calls = cuda_megakernel.PLAIN_CALLS["render_plain"]
    launches = dict(cuda_megakernel.LAUNCHES)
    g1 = render_image_fused(scene, cam, cfg, 2, interleave=1)
    g2 = render_image_fused(scene, cam, cfg, 2, interleave=2)
    monkeypatch.setenv(ENV, "2")
    g2_env = render_image_fused(scene, cam, cfg, 2)
    assert torch.equal(g1, g2) and torch.equal(g1, g2_env)
    assert cuda_megakernel.PLAIN_CALLS["render_plain"] == calls + 3
    assert cuda_megakernel.LAUNCHES == launches


def test_cli_with_interleave2_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, "2")
    out = tmp_path / "g2.png"
    calls = cuda_megakernel.PLAIN_CALLS["render_plain"]
    cli.main(["--device", "cpu", "--integrator", "fused", "--scene", "cornell_materials",
              "--width", "32", "--height", "16", "--spp", "1", "--max-bounces", "3",
              "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert cuda_megakernel.PLAIN_CALLS["render_plain"] == calls + 1


def test_jax_g2_matches_port():
    """The JAX package's G = 2 kernel (interpret, 128x16: two packets
    merged) against the port's render under the image tolerance: at most
    0.5% of elements beyond 5e-4 + 2e-4|x|, means within 1e-3."""
    js, ts = materials_scenes()
    jcfg = JRenderConfig(width=128, height=16, spp=2, max_bounces=4, rng_impl="ktf")
    cfg = RenderConfig(width=128, height=16, spp=2, max_bounces=4, rng_impl="ktf")
    jpx, jpy, _ = j_tiled_pixel_grid(jcfg)
    ref = np.asarray(jrender_tiles_fused(js, jshowcase(jcfg), jcfg, jax.random.key(8), jpx, jpy,
                                         interpret=True, interleave=2))
    px, py, _ = _tiled_pixel_grid(cfg)
    out = cuda_megakernel.render_tiles_fused(ts, showcase_camera(cfg), cfg, 8, px, py,
                                             interleave=2).numpy()
    assert np.isfinite(out).all()
    bad = np.abs(out - ref) > 5e-4 + 2e-4 * np.abs(ref)
    assert bad.mean() <= 0.005
    assert np.abs(out.mean(axis=0) - ref.mean(axis=0)).max() <= 1e-3
