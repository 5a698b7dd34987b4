"""The wavefront integrator (models/wavefront.py) and its closest hit
(ops/intersect.trace_frame_fused) ≡ the JAX package's, and their own
invariants.

Against JAX (run with drain_cascade=(): one while_loop instead of one
per stage; JAX's own test holds the cascade bit for bit): atol 2e-4,
rtol 1e-4 on every pixel but at most one (the triage rule's near-tie
flips). The port's cornell_materials frames go through
trace_frame_fused (K4's plain version here), JAX's through its generic
route, as the JAX package takes on the CPU. Within the port: the
cascade is bitwise, the spp split agrees to rounding, and the
wavefront traces the megakernel's paths (same draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.models.wavefront import render_image_wavefront as jrender_wavefront
from raytracer_tpu.ops.intersect import trace_frame_fused as jtrace_frame_fused
from raytracer_tpu.scene.builder import build_scene_bvh4 as jbuild_bvh4
from raytracer_tpu.scene.builder import cornell_materials_scene as jcornell_materials
from raytracer_tpu.scene.builder import cornell_spheres_scene as jcornell_spheres
from raytracer_tpu_torch.camera import make_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.models import wavefront
from raytracer_tpu_torch.models.wavefront import render_image_wavefront
from raytracer_tpu_torch.ops.intersect import fused_trace_available, trace_frame_fused
from raytracer_tpu_torch.render import iter_spp_accumulation, render_image
from raytracer_tpu_torch.scene.builder import cornell_materials_scene, cornell_spheres_scene
from raytracer_tpu_torch.utils import profiling

torch.set_num_threads(2)

INSIDE = dict(position=(0.0, 0.05, 0.29), pitch=-5.0)  # the showcase pose


def _jax_scene(name):
    if name == "cornell_spheres":
        return jcornell_spheres(), {}
    js = jcornell_materials()
    return js.replace(bvh4=jbuild_bvh4(js.mesh)), INSIDE


def _within_image_tolerance(got, want, atol=2e-4, rtol=1e-4, max_bad_pixels=1):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    close = np.isclose(got, want, atol=atol, rtol=rtol).all(axis=-1)
    assert (~close).sum() <= max_bad_pixels, np.argwhere(~close)


@pytest.mark.parametrize("scene_name,rng_impl", [("cornell_spheres", "jax"),
                                                 ("cornell_spheres", "ktf"),
                                                 ("cornell_materials", "ktf")])
def test_port_wavefront_equals_jax_wavefront(scene_name, rng_impl):
    kw = dict(width=16, height=8, spp=4, max_bounces=4, rng_impl=rng_impl)
    js, pose = _jax_scene(scene_name)
    jcam = jmake_camera(aspect_ratio=2.0, fov_degrees=80.0, aperture=1e-6, **pose)
    want = jrender_wavefront(js, jcam, JRenderConfig(**kw, drain_cascade=()), jax.random.key(7))
    scene = scene_from_numpy(to_numpy_tree(js))
    assert fused_trace_available(scene) == (scene_name == "cornell_materials")
    got = render_image_wavefront(scene, camera_from_numpy(to_numpy_tree(jcam)),
                                 RenderConfig(**kw), 7)
    _within_image_tolerance(got.numpy(), want)
    assert float(np.asarray(want).mean()) > 0.05


def _frame_rays(n, seed):
    """n rays from inside the Cornell box (the showcase camera's
    neighbourhood) in seeded directions, and a seeded active mask."""
    rs = np.random.default_rng(seed)
    o = (rs.uniform(-0.2, 0.2, (n, 3)) + np.array([0.0, 0.25, 0.0])).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    active = rs.uniform(size=n) < 0.7
    return o, d, active


@pytest.fixture(scope="module")
def jax_frame_hits():
    """JAX's trace_frame_fused in interpret mode on 1024 seeded rays of
    cornell_materials, without and with an active mask (the interpreted
    kernel's first call compiles it: ~15 s here; the second reuses it)."""
    js, _ = _jax_scene("cornell_materials")
    o, d, active = _frame_rays(1024, 5)
    want = {flag: jtrace_frame_fused(js, jnp.asarray(o), jnp.asarray(d), 1e-3, interpret=True,
                                     sort=False, active=jnp.asarray(active) if flag else None)
            for flag in (False, True)}
    return scene_from_numpy(to_numpy_tree(js)), o, d, active, want


@pytest.mark.parametrize("with_active", [False, True])
def test_trace_frame_fused_equals_jax_interpret(jax_frame_hits, with_active):
    scene, o, d, active, wants = jax_frame_hits
    want = wants[with_active]
    got = trace_frame_fused(scene, torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                            active=torch.from_numpy(active) if with_active else None)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.front_face.numpy(), np.asarray(want.front_face))
    for f in want.params._fields:
        np.testing.assert_array_equal(getattr(got.params, f).numpy(),
                                      np.asarray(getattr(want.params, f)), err_msg=f)
    hit = got.hit.numpy()
    np.testing.assert_allclose(got.point.numpy()[hit], np.asarray(want.point)[hit],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(want.normal)[hit],
                               rtol=1e-4, atol=1e-6)
    assert 0.3 < hit.mean()
    if with_active:
        # Inactive lanes trace with the limit -1: they miss every triangle,
        # so they hit exactly where a sphere is hit.
        from raytracer_tpu_torch.ops.intersect import BIG
        from raytracer_tpu_torch.ops.sphere import intersect_spheres

        ts, _ = intersect_spheres(torch.from_numpy(o), torch.from_numpy(d), scene.spheres.center,
                                  scene.spheres.radius, 1e-3, BIG)
        off = ~active
        np.testing.assert_array_equal(hit[off], (ts < float(BIG)).numpy()[off])
        full = trace_frame_fused(scene, torch.from_numpy(o), torch.from_numpy(d), 1e-3)
        assert hit[off].sum() < full.hit.numpy()[off].sum()


@pytest.mark.parametrize("scene_name,rng_impl", [("cornell_materials", "ktf"),
                                                 ("cornell_spheres", "jax")])
def test_drain_cascade_is_bitwise(scene_name, rng_impl):
    """The cascade packs pending lanes into smaller buffers; every lane's
    result is the uncompacted one's bit for bit."""
    scene = cornell_materials_scene() if scene_name == "cornell_materials" \
        else cornell_spheres_scene()
    pose = INSIDE if scene_name == "cornell_materials" else {}
    cfg = RenderConfig(width=24, height=12, spp=8, max_bounces=8, rng_impl=rng_impl)
    cam = make_camera(aspect_ratio=cfg.aspect_ratio, **pose)
    with profile(activities=[ProfilerActivity.CPU]):
        with_cascade = render_image_wavefront(scene, cam, cfg, 17)
    spans = profiling.recorded()
    plain = render_image_wavefront(scene, cam, cfg.replace(drain_cascade=()), 17)
    assert torch.equal(with_cascade, plain)
    caps = wavefront.cascade_caps(2048, cfg.drain_cascade)
    assert caps == [1024, 256, 64, 16]
    stages = [s for s in spans if s.name == "rt.wavefront.stage"]
    stage_iterations = [len(profiling.children(s, spans, "rt.wavefront.iteration"))
                        for s in stages]
    host_reads = sum(s.counts.get("host_reads", 0) for s in spans)
    assert len(stage_iterations) == 1 + len(caps)
    assert host_reads == sum(stage_iterations) + 2 * len(caps) + 1
    assert sum(s.counts.get("wavefront.iterations", 0) for s in stages) == sum(stage_iterations)
    assert with_cascade.mean() > 0.05


def test_spp_split_equals_single_pass():
    scene = cornell_materials_scene()
    cfg = RenderConfig(width=16, height=8, spp=8, max_bounces=4, rng_impl="ktf", spp_per_pass=8)
    cam = make_camera(aspect_ratio=cfg.aspect_ratio, **INSIDE)
    single = render_image_wavefront(scene, cam, cfg, 5)
    split = render_image_wavefront(scene, cam, cfg.replace(spp_per_pass=2), 5)
    torch.testing.assert_close(split, single, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("scene_name,rng_impl", [("cornell_spheres", "jax"),
                                                 ("cornell_materials", "ktf")])
def test_wavefront_traces_the_megakernel_paths(scene_name, rng_impl):
    """Same key, same draws: the wavefront's image is the megakernel
    renderer's up to the order of the sample sums."""
    scene = cornell_materials_scene() if scene_name == "cornell_materials" \
        else cornell_spheres_scene()
    pose = INSIDE if scene_name == "cornell_materials" else {}
    cfg = RenderConfig(width=16, height=8, spp=4, max_bounces=6, rng_impl=rng_impl)
    cam = make_camera(aspect_ratio=cfg.aspect_ratio, **pose)
    wf = render_image_wavefront(scene, cam, cfg, 11)
    mk = render_image(scene, cam, cfg, 11)
    torch.testing.assert_close(wf, mk, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("integrator", ["wavefront", "fused"])
def test_iter_spp_accumulation_adds_up_to_one_pass(integrator):
    """The batches' sums add up to the one-pass image (the fused branch
    runs the plain path loop on CPU tensors)."""
    from raytracer_tpu_torch.models.fused import render_image_fused

    scene = cornell_materials_scene()
    cfg = RenderConfig(width=16, height=8, spp=4, max_bounces=4, rng_impl="ktf")
    cam = make_camera(aspect_ratio=cfg.aspect_ratio, **INSIDE)
    done, acc = [], None
    for d, batch_sum in iter_spp_accumulation(scene, cam, cfg, 3, integrator=integrator,
                                              spp_per_batch=2):
        done.append(d)
        acc = batch_sum if acc is None else acc + batch_sum
    assert done == [2, 4]
    one = (render_image_wavefront if integrator == "wavefront" else render_image_fused)(
        scene, cam, cfg, 3)
    torch.testing.assert_close(acc / cfg.spp, one, atol=2e-5, rtol=1e-5)


def test_cli_defaults_to_the_wavefront(tmp_path):
    from raytracer_tpu_torch import cli

    out, npy = tmp_path / "w.png", tmp_path / "w.npy"
    cli.main(["--device", "cpu", "--scene", "cornell_spheres", "--width", "16", "--height", "8",
              "--spp", "2", "--max-bounces", "3", "--out", str(out), "--npy", str(npy)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3)
    from raytracer_tpu_torch.camera import showcase_camera

    want = render_image_wavefront(cornell_spheres_scene(), showcase_camera(cfg), cfg, 0)
    np.testing.assert_array_equal(np.load(npy), want.numpy())
