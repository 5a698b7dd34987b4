"""raytracer_tpu_torch/ops/cuda_lane_grid.py on the CPU: the plain closed
form is the numpy builders' (px, py, inv) bit for bit, dtypes included,
and the JAX package's builders' value for value, at sizes that divide
exactly, pad on one axis, on both, or are narrower than a packet; a
padded lane always lies after its pixel's own lane, so "the first lane
wins" needs no scatter; the renders that take it give the numpy grids'
images bit for bit, with one plain call inside their grid span. The
kernel is held to the plain version on the card
(tests/test_torch_cuda.py)."""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.models.fused import _fused_pixel_grid as j_fused_pixel_grid
from raytracer_tpu.models.wavefront import _tiled_pixel_grid as j_tiled_pixel_grid
from raytracer_tpu.schedule import blocked_pixel_grid as j_blocked_pixel_grid
from raytracer_tpu_torch.camera import showcase_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.fused import _fused_pixel_grid, fused_lanes, render_image_fused
from raytracer_tpu_torch.models.wavefront import render_image_wavefront, render_pixels_wavefront
from raytracer_tpu_torch.ops import cuda_lane_grid as lg
from raytracer_tpu_torch.render import mean_over_passes
from raytracer_tpu_torch.schedule import _tiled_pixel_grid, blocked_pixel_grid
from raytracer_tpu_torch.scene.builder import cornell_materials_scene, cornell_spheres_scene
from raytracer_tpu_torch.utils import profiling

torch.set_num_threads(2)

# Exact (2560x1440, 1920x1088), padded on one axis (1920x1080, 33x64), on
# both (17x9, 1x1), narrower than a packet of either layout (24x40, 100x7).
SIZES = [(2560, 1440), (1920, 1088), (1920, 1080), (33, 64), (17, 9), (1, 1), (24, 40), (100, 7)]
PADDED = [(layout, w, h) for layout, (pw, ph) in (("blocked", (32, 32)), ("tiled", (128, 8)))
          for w, h in SIZES if w % pw or h % ph]
# layout: (the port's numpy builder, the JAX package's, the plain closed form)
LAYOUTS = {
    "blocked": (lambda cfg: blocked_pixel_grid(cfg, 32, 32, 8, 16),
                lambda cfg: j_blocked_pixel_grid(cfg, 32, 32, 8, 16),
                lambda cfg: lg.build(cfg.width, cfg.height, lg.BLOCKED, "cpu")),
    "tiled": (_tiled_pixel_grid, j_tiled_pixel_grid, lambda cfg: lg.tiled_lane_grid(cfg, "cpu")),
    "fused": (_fused_pixel_grid, j_fused_pixel_grid, lambda cfg: lg.lane_grid(cfg, "cpu")),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("w,h", SIZES)
def test_plain_lane_grid_is_the_numpy_grid(w, h, layout):
    """The plain closed form against the port's numpy builders (bit for
    bit, dtypes included) and the JAX package's (value for value: its
    int64 arrays become int32 on the way into jnp)."""
    numpy_grid, jax_grid, plain = LAYOUTS[layout]
    cfg = RenderConfig(width=w, height=h)
    calls = lg.PLAIN_CALLS["lane_grid"]
    got, want = plain(cfg), numpy_grid(cfg)
    assert lg.PLAIN_CALLS["lane_grid"] == calls + 1
    ref = jax_grid(JRenderConfig(width=w, height=h))
    for name, g, x, j in zip(("px", "py", "inv"), got, want, ref):
        assert g.dtype == x.dtype and g.device.type == "cpu", name
        assert torch.equal(g, x), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("layout,w,h", PADDED)
def test_padded_lanes_lie_after_their_pixels_own_lane(layout, w, h):
    """inv is one lane per pixel (distinct, rendering that pixel); every
    other lane is a padded duplicate of some pixel, and lies after that
    pixel's lane. So the first lane of each pixel is its own, as the
    numpy builders' reversed scatter makes it."""
    px, py, inv = LAYOUTS[layout][2](RenderConfig(width=w, height=h))
    n = px.shape[0]
    pix = (h - 1 - py.long()) * w + px.long()
    assert n > w * h and inv.shape == (w * h,)
    assert torch.equal(pix[inv], torch.arange(w * h))
    own = torch.zeros(n, dtype=torch.bool)
    own[inv] = True
    assert int(own.sum()) == w * h
    lanes = torch.arange(n)
    assert bool((inv[pix[~own]] < lanes[~own]).all())
    first = torch.full((w * h,), n).scatter_reduce(0, pix, lanes, "amin")
    assert torch.equal(first, inv)


def test_layouts_and_devices_out_of_range_raise():
    with pytest.raises(ValueError, match="sub-blocks"):
        lg.build(16, 16, (32, 32, 8, 12), "cpu")
    with pytest.raises(ValueError, match="sub-blocks"):
        lg.build(16, 16, (32, 16, 8, 16), "cpu")
    with pytest.raises(ValueError, match="sub-blocks"):
        lg.build(0, 16, lg.TILED, "cpu")
    with pytest.raises(ValueError, match="sub-blocks"):
        lg.build(16, 16, (32, 32, 0, 16), "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        lg.build(16, 16, lg.TILED, "meta")
    assert lg.fused_layout(RenderConfig(width=64, height=32)) == lg.BLOCKED
    assert lg.fused_layout(RenderConfig(width=64, height=40)) == lg.TILED


def _numpy_grid_image(integrator, scene, cam, cfg, seed):
    """The image through the numpy grid, as the renders built it before
    the grid moved to the device."""
    if integrator == "fused":
        px, py, inv = _fused_pixel_grid(cfg)
        acc = fused_lanes(scene, cam, cfg, seed, px, py, plain=True)
    else:
        px, py, inv = _tiled_pixel_grid(cfg)
        acc = mean_over_passes(cfg, cfg.spp, lambda s, done: render_pixels_wavefront(
            scene, cam, px, py, cfg, seed, spp=s, sample_offset=done))
    return acc[inv].reshape(cfg.height, cfg.width, 3)


@pytest.mark.parametrize("integrator,w,h", [("fused", 32, 32), ("fused", 17, 9),
                                             ("wavefront", 17, 9), ("wavefront", 32, 32)])
def test_render_equals_the_numpy_grid_image_with_one_plain_call(integrator, w, h):
    """render_image_fused(plain=True) and render_image_wavefront on the
    CPU: the numpy grid's image bit for bit, and their grid span holds one
    plain lane-grid call."""
    if integrator == "fused":
        scene = cornell_materials_scene()
        render = functools.partial(render_image_fused, plain=True)
    else:
        scene, render = cornell_spheres_scene(), render_image_wavefront
    cfg = RenderConfig(width=w, height=h, spp=2, max_bounces=3, rng_impl="ktf")
    cam = showcase_camera(cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        got = render(scene, cam, cfg, 7)
    (grid,) = [s for s in profiling.recorded() if s.name == f"rt.{integrator}.grid"]
    assert grid.counts == {"plain.lane_grid": 1}
    assert torch.equal(got, _numpy_grid_image(integrator, scene, cam, cfg, 7))
    assert got.mean() > 0.01
