"""raytracer_tpu_torch/schedule.py: the profile-guided schedule against
raytracer_tpu/schedule.py.

The ordering is numpy on both sides (quantile buckets, Morton codes,
lexsort, first-lane-wins inverse), so the same lane costs must give the
same permutation bit for bit. The port's build_schedule profiles through
the plain version of K3-profile here; a scheduled render is a pure
relabeling of lanes, so it must equal the tile-ordered render exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu import schedule as jschedule
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.models.wavefront import _tiled_pixel_grid as j_tiled_pixel_grid
from raytracer_tpu_torch import schedule
from raytracer_tpu_torch.camera import make_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops.cuda_megakernel import render_tiles_fused
from raytracer_tpu_torch.scene.builder import cornell_materials_scene

torch.set_num_threads(2)


def _lanes(w, h):
    """The tiled lane grid of both packages (equal), and seeded costs with
    ties, as K3-profile's integer counts have."""
    px, py, _ = schedule._tiled_pixel_grid(RenderConfig(width=w, height=h))
    jpx, jpy, _ = j_tiled_pixel_grid(JRenderConfig(width=w, height=h))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))
    cost = np.random.default_rng(w + h).integers(8, 60, px.shape[0]).astype(np.float32)
    return px, py, cost


def test_morton2_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 16, 4096)
    y = rng.integers(0, 1 << 16, 4096)
    np.testing.assert_array_equal(schedule._morton2(x, y), jschedule._morton2(x, y))


@pytest.mark.parametrize("n_buckets", [1, 4])
def test_order_by_cost_matches_jax(n_buckets):
    w, h = 128, 40  # the preflight frame: 5 packets
    px, py, cost = _lanes(w, h)
    got = schedule.order_by_cost(px, py, torch.from_numpy(cost), RenderConfig(width=w, height=h),
                                 n_buckets=n_buckets)
    want = jschedule.order_by_cost(jnp.asarray(px.numpy()), jnp.asarray(py.numpy()), cost,
                                   JRenderConfig(width=w, height=h), n_buckets=n_buckets)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_order_by_row_cost_matches_jax():
    px, py, cost = _lanes(128, 32)
    got = schedule.order_by_row_cost(px, py, cost)
    want = jschedule.order_by_row_cost(jnp.asarray(px.numpy()), jnp.asarray(py.numpy()), cost)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_scheduled_render_bit_identical():
    """tests/test_schedule.py's sizes: 128x16, spp 2, mb 5, a profile at
    spp 1 into 4 buckets."""
    scene = cornell_materials_scene()
    cfg = RenderConfig(width=128, height=16, spp=2, max_bounces=5)
    cam = make_camera(aspect_ratio=cfg.width / cfg.height, fov_degrees=cfg.fov_degrees,
                      aperture=cfg.aperture, position=(0.0, 0.05, 0.29), pitch=-5.0)
    px, py, inv = schedule._tiled_pixel_grid(cfg)
    base = render_tiles_fused(scene, cam, cfg, 7, px, py)[inv]
    px2, py2, inv2 = schedule.build_schedule(scene, cam, cfg, 7, profile_spp=1, n_buckets=4)
    assert not torch.equal(px2, px)  # the schedule moved lanes
    sched = render_tiles_fused(scene, cam, cfg, 7, px2, py2)[inv2]
    assert torch.equal(base, sched)
