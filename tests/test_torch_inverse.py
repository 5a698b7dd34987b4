"""Inverse rendering (diff/inverse.py) ≡ the JAX package's diff/inverse.py.

JAX's exact params, keys and Adam state are handed to the port
(convert.params_from_numpy, key_words, adam_state_from_numpy). Adam and
the cosine schedule agree to 1 ulp of float32 (pow and cos round by
libm); the init noise to 3 ulp of the normals (tests/test_torch_rng.py);
one make_train_step_multi step to 2e-6 in the loss and 1e-6 in the new
params (renders agree to 2e-7). Accumulating over chunks of pairs gives
the multi-pair step's loss to 1e-6 and params to 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.diff import inverse as jinv
from raytracer_tpu.render import render_image as jrender_image
from raytracer_tpu.scene.builder import cornell_spheres_scene
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import (adam_state_from_numpy, camera_from_numpy, key_words,
                                         params_from_numpy, scene_from_numpy, to_numpy_tree)
from raytracer_tpu_torch.diff import inverse as tinv
from raytracer_tpu_torch.utils import rng

torch.set_num_threads(2)

CFG = dict(width=16, height=8, spp=2, max_bounces=2, reference_emission_quirk=False)
SCALES = {"cam_yaw": 2.0, "cam_position": 0.3}


@pytest.fixture(scope="module")
def setup():
    js = cornell_spheres_scene()
    jcam = jmake_camera(aspect_ratio=2.0, fov_degrees=80.0, aperture=1e-6,
                        position=(0.0, 0.5, 1.6), pitch=-14.0)
    keys = jax.random.split(jax.random.key(12), 4)
    targets = jnp.stack([jrender_image(js, jcam, JRenderConfig(**CFG), k) for k in keys])
    params = jinv.init_params(js, fields=("albedo", "emission"), key=jax.random.key(6),
                              noise=0.1)
    params["cam_yaw"] = jcam.yaw + 1.0
    params["cam_position"] = jcam.position + jnp.asarray([0.01, 0.0, -0.01])
    return js, jcam, keys, targets, params


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def test_init_params_noise_matches_jax():
    """One subkey per field in SORTED name order (JAX flattens a dict by
    sorted keys), reflected into the domains."""
    js = cornell_spheres_scene()
    ts = scene_from_numpy(to_numpy_tree(js))
    fields = ("roughness", "albedo", "ior", "emission")
    want = jinv.init_params(js, fields=fields, key=jax.random.key(41), noise=0.15)
    got = tinv.init_params(ts, fields=fields, key=rng.key(41), noise=0.15)
    assert list(got) == list(fields)
    for k in fields:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-7,
                                   err_msg=k)
    assert not torch.equal(got["albedo"], ts.materials.albedo)


def test_adam_update_and_cosine_lr_match_jax():
    rs = np.random.default_rng(0)
    p = {"albedo": rs.uniform(0, 1, (5, 3)).astype(np.float32),
         "cam_yaw": np.float32(-89.0), "cam_position": rs.normal(size=3).astype(np.float32)}
    jstate = jinv.adam_init({k: jnp.asarray(v) for k, v in p.items()})
    tstate = tinv.adam_init(params_from_numpy(p))
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p)
    jlr, tlr = jinv.cosine_lr(0.03, 7, 0.05), tinv.cosine_lr(0.03, 7, 0.05)
    for step in range(9):
        np.testing.assert_allclose(tlr(step), float(jlr(jnp.int32(step))), rtol=2e-7)
        g = {k: rs.normal(size=np.shape(v)).astype(np.float32) for k, v in p.items()}
        jstate, jp = jinv.adam_update(jstate, {k: jnp.asarray(v) for k, v in g.items()}, jp,
                                      lr=jlr(jstate.step), lr_scales=SCALES)
        tstate, tp = tinv.adam_update(tstate, params_from_numpy(g), tp, lr=tlr(tstate.step),
                                      lr_scales=SCALES)
        assert tstate.step == int(jstate.step)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=3e-7, atol=1e-7)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(jstate.nu[k]), rtol=3e-7)
    # JAX's state hands over: the next update from it is the port's.
    handed = adam_state_from_numpy(jstate.step, _np(jstate.mu), _np(jstate.nu))
    assert handed.step == tstate.step
    for k in p:
        np.testing.assert_array_equal(handed.mu[k].numpy(), np.asarray(jstate.mu[k]))


def test_train_step_multi_matches_jax(setup):
    js, jcam, keys, targets, params = setup
    jstep = jinv.make_train_step_multi(js, jcam, JRenderConfig(**CFG), targets, keys, lr=0.02,
                                       lr_fn=jinv.cosine_lr(0.02, 5), lr_scales=SCALES)
    jp, js1, jl = jstep(params, jinv.adam_init(params))

    tparams = params_from_numpy(_np(params))
    tstep = tinv.make_train_step_multi(
        scene_from_numpy(to_numpy_tree(js)), camera_from_numpy(to_numpy_tree(jcam)),
        RenderConfig(**CFG), torch.from_numpy(np.array(targets)),
        key_words(jax.random.key_data(keys)), lr=0.02, lr_fn=tinv.cosine_lr(0.02, 5),
        lr_scales=SCALES)
    tp, ts1, tl = tstep(tparams, tinv.adam_init(tparams))
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-6)
    assert float(tl) > 1e-4
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
        assert not np.array_equal(tp[k].numpy(), np.asarray(params[k]))  # every field moved


def test_accum_step_equals_multi(setup):
    js, jcam, keys, targets, params = setup
    ts, cam = scene_from_numpy(to_numpy_tree(js)), camera_from_numpy(to_numpy_tree(jcam))
    tk, tt = key_words(jax.random.key_data(keys)), torch.from_numpy(np.array(targets))
    cfg = RenderConfig(**CFG)
    p0 = params_from_numpy(_np(params))
    kw = dict(lr=0.02, lr_fn=tinv.cosine_lr(0.02, 5), lr_scales=SCALES)
    step_a = tinv.make_train_step_multi(ts, cam, cfg, tt, tk, **kw)
    step_b = tinv.make_train_step_accum(ts, cam, cfg, tt, tk, chunk=2, **kw)
    pa, sa, pb, sb = dict(p0), tinv.adam_init(p0), dict(p0), tinv.adam_init(p0)
    for _ in range(3):
        pa, sa, la = step_a(pa, sa)
        pb, sb, lb = step_b(pb, sb)
        assert abs(float(la) - float(lb)) < 1e-6
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tinv.make_train_step_accum(ts, cam, cfg, tt, tk, chunk=3)


def test_single_target_step_is_the_one_pair_multi_step(setup):
    js, jcam, keys, targets, params = setup
    ts, cam = scene_from_numpy(to_numpy_tree(js)), camera_from_numpy(to_numpy_tree(jcam))
    cfg = RenderConfig(**CFG)
    p0 = params_from_numpy(_np(params))
    k0 = key_words(jax.random.key_data(keys[:1]))
    target = torch.from_numpy(np.array(targets[:1]))
    single = tinv.make_train_step(ts, cam, cfg, target[0], lr=0.02, lr_scales=SCALES)
    multi = tinv.make_train_step_multi(ts, cam, cfg, target, k0, lr=0.02, lr_scales=SCALES)
    ps, ss, ls = single(p0, tinv.adam_init(p0), (k0[0][0], k0[1][0]))
    pm, sm, lm = multi(p0, tinv.adam_init(p0))
    assert torch.equal(ls, lm)
    for k in ps:
        assert torch.equal(ps[k], pm[k]), k
    with pytest.raises(TypeError, match="Mesh"):
        tinv.make_train_step(ts, cam, cfg, target[0], mesh=object())


def test_apply_params_clips_with_jaxs_gradient():
    """The domain clip splits the gradient in half at the bound, as JAX's
    maximum/minimum do (a mirror's roughness sits exactly at 0)."""
    ts = scene_from_numpy(to_numpy_tree(cornell_spheres_scene()))
    rough = ts.materials.roughness.clone().requires_grad_(True)
    scene = tinv._apply_params(ts, {"roughness": rough})
    (g,) = torch.autograd.grad(scene.materials.roughness.sum(), rough)
    want = jax.grad(lambda r: jnp.sum(jnp.clip(r, 0.0, 1.0)))(jnp.asarray(rough.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    moved = tinv._apply_cam(camera_from_numpy(to_numpy_tree(jmake_camera(1.0))),
                            {"cam_yaw": torch.tensor(-80.0), "cam_fov": torch.tensor(60.0)})
    assert float(moved.yaw) == -80.0 and float(moved.fov_degrees) == 60.0
    assert dataclasses.is_dataclass(moved)


def _sky_color_site():
    from raytracer_tpu_torch.ops import tonemap
    from raytracer_tpu_torch.utils import vecmath as vm

    d = torch.from_numpy(np.random.default_rng(3).normal(size=(257, 3)).astype(np.float32))
    t = 0.5 * (vm.normalize(d, eps=1e-20)[..., 1:2] + 1.0)
    old = ((1.0 - t) * torch.tensor(tonemap.SKY_BOTTOM, dtype=torch.float32)
           + t * torch.tensor(tonemap.SKY_TOP, dtype=torch.float32))
    return tonemap.sky_color(d), old


def _ktf_sampler_site(bounce):
    from raytracer_tpu_torch.utils import ktf

    trace = ktf.TraceDraws(torch.tensor(7, dtype=torch.int32), torch.tensor(-9, dtype=torch.int32),
                           torch.arange(40, dtype=torch.int32), 3, 5)
    smp = trace.sampler(bounce)
    old = dataclasses.replace(smp, bounce=torch.tensor(bounce, dtype=torch.int32))
    assert smp.bounce.dtype == old.bounce.dtype and smp.bounce.shape == old.bounce.shape
    return (torch.cat([smp.bounce.reshape(1).float(), smp.scatter_unit_vector().reshape(-1),
                       smp.rr_uniform()]),
            torch.cat([old.bounce.reshape(1).float(), old.scatter_unit_vector().reshape(-1),
                       old.rr_uniform()]))


def _camera_target_site():
    from raytracer_tpu_torch.camera import make_camera

    pos = torch.tensor([0.1, -0.05, 0.29], requires_grad=True)
    target = (0.013, -0.2, 0.0071)
    cam = make_camera(aspect_ratio=1.0, position=pos, target=target)
    old = torch.linalg.vector_norm(pos - torch.as_tensor(target, dtype=torch.float32))
    return cam.focus_dist.detach(), old.detach()


def _sphere_limit_site():
    from raytracer_tpu_torch.ops.sphere import BIG, intersect_spheres

    rs = np.random.default_rng(5)
    o = torch.from_numpy(rs.uniform(-0.3, 0.3, (300, 3)).astype(np.float32))
    d = torch.from_numpy(rs.normal(size=(300, 3)).astype(np.float32))
    c = torch.from_numpy(rs.uniform(-0.3, 0.3, (4, 3)).astype(np.float32))
    r = torch.tensor([0.05, 0.1, 0.2, 999.0])
    new = intersect_spheres(o, d, c, r, 1e-3, BIG)
    old = intersect_spheres(o, d, c, r, 1e-3, torch.as_tensor(BIG, dtype=torch.float32))
    return torch.cat([new[0], new[1].float()]), torch.cat([old[0], old[1].float()])


CAPTURE_SAFE_SITES = {"sky_color": _sky_color_site, "ktf_sampler_b0": lambda: _ktf_sampler_site(0),
                      "ktf_sampler_b3": lambda: _ktf_sampler_site(3),
                      "ktf_sampler_b5": lambda: _ktf_sampler_site(5),
                      "camera_target": _camera_target_site, "sphere_limit": _sphere_limit_site}


@pytest.mark.parametrize("site", list(CAPTURE_SAFE_SITES))
def test_capture_safe_constants_give_the_old_values(site):
    """Each per-call copy from the host that a CUDA graph cannot capture,
    now a device constant made once or a fill, gives the value of the
    copy it replaced bit for bit."""
    new, old = CAPTURE_SAFE_SITES[site]()
    assert new.dtype == old.dtype and torch.equal(new, old)


def test_accum_step_stays_eager_on_the_cpu():
    """On CPU tensors make_train_step_accum runs its chunks eagerly: one
    `rt.train.forward` and one `rt.train.backward` span a chunk, no
    capture, no replay; the benchmark's graph_replays_per_step.train reads
    0 there, and nothing for a program without ChunkGraph."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import manifest
    from benchmark.run import Run
    from raytracer_tpu_torch.camera import make_camera
    from raytracer_tpu_torch.render import render_image
    from raytracer_tpu_torch.scene.builder import cornell_materials_scene
    from raytracer_tpu_torch.utils import profiling

    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=3, rng_impl="ktf",
                       reference_emission_quirk=False, edge_aware_lights=True)
    scene = cornell_materials_scene()
    cam = make_camera(aspect_ratio=1.0, position=(0.0, -0.05, 0.29), pitch=-10.0)
    keys = rng.split(rng.key(40), 2)
    with torch.no_grad():
        tg = torch.stack([render_image(scene, cam, cfg, (keys[0][j], keys[1][j]))
                          for j in range(2)])
    params = tinv.init_params(scene, key=rng.key(41), noise=0.15)
    step = tinv.make_train_step_accum(scene, cam, cfg, tg, keys, chunk=1, lr=0.03)
    before = dict(tinv.GRAPHS)
    state = tinv.adam_init(params)
    params, state, _ = step(params, state)
    with profile(activities=[ProfilerActivity.CPU]):
        params, state, loss = step(params, state)
    assert dict(tinv.GRAPHS) == before and bool(torch.isfinite(loss))
    names = [r.name for r in profiling.recorded()]
    assert names.count("rt.train.step") == 1
    assert names.count("rt.train.forward") == names.count("rt.train.backward") == 2
    assert "rt.train.replay" not in names
    run = Run(trace={}, traced=[(0.0, 1)])
    reader = manifest.metric_reader("graph_replays_per_step.train")
    assert reader.read(run) == 0.0
    graph_cls = tinv.ChunkGraph
    del tinv.ChunkGraph
    try:
        assert reader.read(run) is None
    finally:
        tinv.ChunkGraph = graph_cls
