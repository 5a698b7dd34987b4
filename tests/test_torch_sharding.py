"""The port's sharded renders and train step (raytracer_tpu_torch/parallel)
≡ its single-device paths, and ≡ the JAX package's sharded functions.

The port shards over an 8-device CPU mesh (make_mesh(["cpu"] * 8)), JAX
over its 8 virtual CPU devices (tests/conftest.py). Within the port
every sharded render is bit for bit its single-device render (draws are
keyed by pixel, sample and bounce, and each lane is computed alone); the
2D mesh averages its sample windows in another order (atol 2e-6, rtol
1e-5, as tests/test_sharding.py). Against JAX, the differentiable and
the rebalanced wavefront renders are held to the image tolerance of
tests/test_torch_megakernel.py (at most 0.5% of elements beyond 5e-4 +
2e-4·|x|, means within 1e-3), and the rebalance's per-shard iterations
to JAX's bound (tests/test_sharding.py:157-159). JAX's own rebalanced
image is within 6e-8 of its single-device one, but at 128x64, 6
bounces, the port's single-device wavefront already differs from JAX's
on ~25 of 8,192 pixels (by up to 0.25, both draw families): an ulp of
cos/sin or a normal sends a deep path elsewhere. So atol 5e-7 cannot
hold there against JAX, and the port's rebalance is held bit for bit to
the port's single-device wavefront instead."""

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.diff import inverse as jinv
from raytracer_tpu.parallel import sharding as jsh
from raytracer_tpu.render import render_image as jrender_image
from raytracer_tpu.scene.builder import cornell_spheres_scene as jcornell_spheres
from raytracer_tpu_torch.camera import make_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import (camera_from_numpy, params_from_numpy, scene_from_numpy,
                                         to_numpy_tree)
from raytracer_tpu_torch.diff import inverse
from raytracer_tpu_torch.models.fused import render_image_fused
from raytracer_tpu_torch.models.wavefront import render_image_wavefront
from raytracer_tpu_torch.parallel import multihost
from raytracer_tpu_torch.parallel import sharding as sh
from raytracer_tpu_torch.render import render_image
from raytracer_tpu_torch.scene.builder import cornell_materials_scene, cornell_spheres_scene

torch.set_num_threads(2)

ATOL, RTOL, BAD_FRAC, MEAN_TOL = 5e-4, 2e-4, 0.005, 1e-3   # tests/test_torch_megakernel.py
INSIDE = dict(position=(0.0, 0.05, 0.29), pitch=-5.0)       # the showcase pose


@pytest.fixture(scope="module")
def spheres():
    return cornell_spheres_scene()


@pytest.fixture(scope="module")
def mesh8():
    return sh.make_mesh(["cpu"] * 8)


def _cam(cfg, **pose):
    return make_camera(aspect_ratio=cfg.width / cfg.height, fov_degrees=cfg.fov_degrees,
                       aperture=cfg.aperture, **pose)


def _jcam(cfg):
    return jmake_camera(aspect_ratio=cfg.width / cfg.height, fov_degrees=cfg.fov_degrees,
                        aperture=cfg.aperture)


def _near_jax(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) > ATOL + RTOL * np.abs(want)).mean() <= BAD_FRAC
    assert np.abs(got.mean(axis=(0, 1)) - want.mean(axis=(0, 1))).max() <= MEAN_TOL
    assert float(want.mean()) > 0.05


def test_sharded_render_is_the_render_and_near_jax(spheres, mesh8):
    kw = dict(width=16, height=16, spp=4, max_bounces=4)
    cfg = RenderConfig(**kw)
    got = sh.render_image_sharded(spheres, _cam(cfg), cfg, 123, mesh=mesh8)
    assert torch.equal(got, render_image(spheres, _cam(cfg), cfg, 123))
    jcfg = JRenderConfig(**kw)
    _near_jax(got, jsh.render_image_sharded(jcornell_spheres(), _jcam(jcfg), jcfg,
                                            jax.random.key(123), mesh=jsh.make_mesh()))


@pytest.mark.parametrize("interleave", [True, False])
def test_wavefront_over_shards_is_bitwise(spheres, mesh8, interleave):
    """128x128: 16 packets over 8 shards, a real round-robin permutation."""
    cfg = RenderConfig(width=128, height=128, spp=1, max_bounces=3)
    single = render_image_wavefront(spheres, _cam(cfg), cfg, 17)
    got = sh.render_image_wavefront_sharded(spheres, _cam(cfg), cfg, 17, mesh=mesh8,
                                            interleave=interleave)
    assert torch.equal(got, single)
    assert float(single.mean()) > 0.05


def test_rebalanced_wavefront_is_bitwise_and_near_jax(spheres, mesh8):
    kw = dict(width=128, height=64, spp=2, max_bounces=6)
    cfg = RenderConfig(**kw)
    stats = {"stage_iterations": [], "host_reads": 0}
    got, iters = sh.render_image_wavefront_rebalanced(spheres, _cam(cfg), cfg, 9, mesh=mesh8,
                                                      rebalance_div=8, report_iters=True,
                                                      stats=stats)
    assert torch.equal(got, render_image_wavefront(spheres, _cam(cfg), cfg, 9))
    assert iters.shape == (8,) and iters.dtype == torch.int32
    assert bool((iters >= 1).all()) and bool((iters < cfg.spp * cfg.max_bounces + 8).all())
    # Each shard of 1,024 lanes (cap 128): the full buffer, the cascade
    # stage of 512, then its stripe's drain.
    assert len(stats["stage_iterations"]) == 8 * 3
    jcfg = JRenderConfig(**kw)
    want, jiters = jsh.render_image_wavefront_rebalanced(
        jcornell_spheres(), _jcam(jcfg), jcfg, jax.random.key(9), mesh=jsh.make_mesh(),
        rebalance_div=8, report_iters=True)
    _near_jax(got, want)
    assert np.asarray(jiters).shape == iters.shape


def test_rebalance_cap_and_bundle(spheres):
    """A bundle holds the pending lanes and then inert fill rows (origin
    -1, no sample budget); the stripe drain leaves the fill rows as they
    are and returns every pending lane finished."""
    from raytracer_tpu_torch.models import wavefront as wf
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid

    assert wf.rebalance_cap(1024, 8) == 128 and wf.rebalance_cap(5, 8) == 1
    assert wf.rebalance_cap(4, 1) == 4
    cfg = RenderConfig(width=128, height=8, spp=2, max_bounces=4)
    px, py, _ = _tiled_pixel_grid(cfg)
    state, bundle = wf.rebalance_local(spheres, _cam(cfg), px, py, cfg, 3, 2, 0, 512, 1)
    assert bundle.shape == (512, wf.BUNDLE_COLS)
    origin = bundle[:, -1]
    k = int((origin >= 0).sum())
    assert 0 < k <= 512 and bool((origin[k:] == -1).all())
    assert bool((origin[:k] >= 1024).all()) and bool((origin[:k] < 2048).all())
    res, iters = wf.rebalance_stripe(spheres, _cam(cfg), bundle, 0, 1, cfg, 3, 2, 0)
    assert iters > 0 and torch.equal(res[:, 0], origin)
    fill_acc = res[k:, 1:].contiguous().view(torch.float32)
    assert bool((fill_acc == 0).all())


def test_fused_over_shards_is_bitwise():
    """The plain version of K3 per shard, 16 packets over 8 shards, ≡
    render_image_fused (blocked lanes); 7 shards do not divide 16 packets."""
    scene = cornell_materials_scene()
    cfg = RenderConfig(width=128, height=128, spp=1, max_bounces=3, rng_impl="ktf")
    cam = _cam(cfg, **INSIDE)
    single = render_image_fused(scene, cam, cfg, 5)
    got = sh.render_image_fused_sharded(scene, cam, cfg, 5, mesh=sh.make_mesh(["cpu"] * 8))
    assert torch.equal(got, single)
    assert float(single.mean()) > 0.05
    with pytest.raises(ValueError, match="packet count"):
        sh.render_image_fused_sharded(scene, cam, cfg, 5, mesh=sh.make_mesh(["cpu"] * 7))


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
def test_2d_mesh_matches_single_device(spheres, integrator):
    cfg = RenderConfig(width=16, height=16, spp=8, max_bounces=4)
    cam = _cam(cfg)
    mesh2d = sh.make_mesh_2d(4, 2, ["cpu"] * 8)
    assert mesh2d.shape == {sh.RAY_AXIS: 4, sh.SPP_AXIS: 2}
    single = (render_image if integrator == "megakernel" else render_image_wavefront)(
        spheres, cam, cfg, 77)
    got = sh.render_image_sharded_2d(spheres, cam, cfg, 77, mesh=mesh2d, integrator=integrator)
    torch.testing.assert_close(got, single, atol=2e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        sh.render_image_sharded_2d(spheres, cam, cfg, 77, mesh=mesh2d, spp=7,
                                   integrator=integrator)
    with pytest.raises(ValueError, match="need 8 devices"):
        sh.make_mesh_2d(4, 2, ["cpu"] * 4)


def test_train_step_over_eight_shards(mesh8):
    """From the JAX package's noised params: the 8-shard step (weighted
    shard losses, summed gradients) against the unsharded step."""
    js = jcornell_spheres()
    jcfg = JRenderConfig(width=16, height=8, spp=2, max_bounces=3)
    jcam = _jcam(jcfg)
    target = np.asarray(jrender_image(js, jcam, jcfg, jax.random.key(99)))
    jparams = jinv.init_params(js, key=jax.random.key(1), noise=0.1)
    scene, cam = scene_from_numpy(to_numpy_tree(js)), camera_from_numpy(to_numpy_tree(jcam))
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3)
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()})
    state = inverse.adam_init(params)
    tgt = torch.from_numpy(np.array(target))
    step_1 = inverse.make_train_step(scene, cam, cfg, tgt)
    step_8 = inverse.make_train_step(scene, cam, cfg, tgt, mesh=mesh8)
    p1, s1, l1, p8, s8, l8 = (*step_1(params, state, 5), *step_8(params, state, 5))
    assert np.isfinite(float(l1)) and np.isfinite(float(l8))
    np.testing.assert_allclose(float(l8), float(l1), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(p8[k].numpy(), p1[k].numpy(), atol=1e-6)
        assert s8.mu[k].shape == s1.mu[k].shape
    # A second step from there, and a pixel count that needs padding (7 shards).
    step_7 = inverse.make_train_step(scene, cam, cfg, tgt, mesh=sh.make_mesh(["cpu"] * 7))
    q1, _, m1 = step_1(p1, s1, 6)
    q7, _, m7 = step_7(p8, s8, 6)
    np.testing.assert_allclose(float(m7), float(m1), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(q7[k].numpy(), q1[k].numpy(), atol=1e-6)
    with pytest.raises(TypeError):
        inverse.make_train_step(scene, cam, cfg, tgt, mesh=object())


def test_interleave_packets_and_pixel_grid_match_jax():
    """16 packets over 8 shards: a real permutation, JAX's exactly, that
    unperm undoes; 2 packets over 8: the contiguous fallback. The padded
    grid is JAX's too."""
    px16 = torch.arange(16 * 1024, dtype=torch.int32)
    pxp, _, unperm = sh._interleave_packets(px16, px16, 8)
    jpx, _, junperm = jsh._interleave_packets(np.arange(16 * 1024, dtype=np.int32),
                                              np.arange(16 * 1024, dtype=np.int32), 8)
    assert unperm is not None and not torch.equal(unperm, torch.arange(unperm.numel()))
    np.testing.assert_array_equal(pxp.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(unperm.numpy(), np.asarray(junperm))
    assert torch.equal(pxp[unperm], px16)
    px2 = torch.arange(2 * 1024, dtype=torch.int32)
    assert sh._interleave_packets(px2, px2, 8)[2] is None
    cfg = RenderConfig(width=13, height=5)
    px, py, n = sh._padded_pixel_grid(cfg, 8)
    jpx, jpy, jn = jsh._padded_pixel_grid(JRenderConfig(width=13, height=5), 8)
    assert n == jn == 65 and px.shape[0] == 72
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))


def test_scaling_report_rows_against_one_device(spheres):
    """The 1-device row is always measured and is the norm."""
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3)
    rep = multihost.scaling_report(spheres, _cam(cfg), cfg, 3, device_counts=[2, 4],
                                   devices=["cpu"] * 8)
    assert set(rep) == {1, 2, 4}
    assert rep[1]["efficiency"] == 1.0
    for c in (2, 4):
        assert 0.0 < rep[c]["efficiency"] < 10.0 and rep[c]["seconds"] > 0.0
    assert set(multihost.scaling_report(spheres, _cam(cfg), cfg, 3, devices=["cpu"])) == {1}


def test_multihost_helpers_without_a_process_group(spheres, mesh8, monkeypatch):
    """Single-process: initialize() is a no-op, global_mesh() is the
    local mesh, render_image_multihost is the render bit for bit."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() is False
    assert multihost.global_mesh("cpu").devices == (torch.device("cpu"),)
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3)
    img = multihost.render_image_multihost(spheres, _cam(cfg), cfg, 21, mesh8)
    assert torch.equal(img, render_image(spheres, _cam(cfg), cfg, 21))


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sh.make_mesh_2d(1, 1)
    mesh = sh.make_mesh(["cpu", "cpu"])
    assert mesh.size == 2 and mesh.local_shards() == [0, 1] and mesh.home == torch.device("cpu")
    parts = {0: torch.tensor([1.0, 2.0]), 1: torch.tensor([3.0, 4.0])}
    assert torch.equal(mesh.gather(parts), torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert torch.equal(mesh.all_sum(parts), torch.tensor([4.0, 6.0]))
    assert all(torch.equal(v, mesh.gather(parts)) for v in mesh.all_gather(parts).values())


def test_cli_sharded_on_the_cpu(tmp_path, spheres):
    from raytracer_tpu_torch import cli

    out, npy = tmp_path / "s.png", tmp_path / "s.npy"
    cli.main(["--sharded", "--device", "cpu", "--scene", "cornell_spheres", "--width", "24",
              "--height", "12", "--spp", "2", "--max-bounces", "3", "--camera", "reference",
              "--out", str(out), "--npy", str(npy)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    cfg = RenderConfig(width=24, height=12, spp=2, max_bounces=3)
    want = render_image(spheres, _cam(cfg), cfg, 0)
    np.testing.assert_array_equal(np.load(npy), want.numpy())
