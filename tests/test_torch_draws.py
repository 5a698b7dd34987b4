"""The draw sites of the differentiable path (utils/rng.TraceDraws,
utils/ktf.TraceDraws) ≡ the per-method chains and the JAX package.

On CPU tensors a site's numbers are the per-method chain (KeySampler and
KtfSampler with kernel=False), the plain version of the draw kernels in
csrc/ktf.cu; tests/test_torch_cuda.py holds the kernels to that chain on
the card. Inputs are seeded numpy keys; a trace's lanes are sample-major
over a pixel count that is no multiple of 32, with a first sample above
0. Against the chain every number is held bitwise. Against JAX, keys,
bits and uniforms are held bitwise; the unit vectors and disks, which go
through erf_inv's log1p or through cos/sin, are held to the bounds of
tests/test_torch_rng.py (2e-7 absolute, the jax family) and
tests/test_torch_ktf_camera.py (1e-6 absolute, the ktf family)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.render import render_image as jrender_image
from raytracer_tpu.scene.builder import build_scene_bvh4 as jbuild_bvh4
from raytracer_tpu.scene.builder import cornell_materials_scene as jcornell_materials
from raytracer_tpu.utils import ktf as jktf
from raytracer_tpu.utils import rng as jrng
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import (camera_from_numpy, key_words, scene_from_numpy,
                                         to_numpy_tree)
from raytracer_tpu_torch.render import render_image
from raytracer_tpu_torch.utils import ktf, rng

torch.set_num_threads(2)

N_PIXELS, SAMPLES, S0 = 123, 3, 5   # 369 lanes, sample-major
MIN_BOUNCES = 3


def _pixels(seed):
    return np.random.default_rng(seed).integers(0, 2560 * 1440, N_PIXELS).astype(np.int32)


def _lane_samples():
    return (np.arange(SAMPLES, dtype=np.int32) + S0).repeat(N_PIXELS)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 3])
def test_jax_family_sites_match_the_chain_and_jax(seed):
    pix = _pixels(seed)
    pkeys = rng.lane_keys(rng.key(seed), torch.from_numpy(pix))
    draws = rng.TraceDraws(pkeys, SAMPLES, S0)
    cam = draws.camera()
    # The chain: pixel keys tiled over the samples, the samples folded in.
    lane_keys = rng.fold((pkeys[0].repeat(SAMPLES), pkeys[1].repeat(SAMPLES)),
                         torch.from_numpy(_lane_samples()), kernel=False)
    chain = rng.KeySampler(lane_keys, kernel=False)
    for got, want in zip(draws.lane_keys(), lane_keys):
        assert torch.equal(got, want)
    for got, want in zip(cam.jitter_uv() + cam.lens_disk(),
                         chain.jitter_uv() + chain.lens_disk()):
        assert torch.equal(got, want)
    # JAX: the same lanes through the JAX package's discipline.
    jkeys = jrng.fold(jrng.lane_keys(jax.random.key(seed), jnp.asarray(np.tile(pix, SAMPLES))),
                      jnp.asarray(_lane_samples()))
    for got, want in zip(draws.lane_keys(), key_words(jax.random.key_data(jkeys))):
        assert torch.equal(got, want)
    js = jrng.KeySampler(jkeys)
    for got, want in zip(cam.jitter_uv(), js.jitter_uv()):
        _equal(got, want)
    for got, want in zip(cam.lens_disk(), js.lens_disk()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-7)

    for bounce in (0, 2, MIN_BOUNCES, 5):
        rr = bounce >= MIN_BOUNCES
        site = draws.bounce(bounce, rr)
        smp = rng.KeySampler(rng.fold(lane_keys, bounce, kernel=False), kernel=False)
        jb = jrng.KeySampler(jrng.fold(jkeys, bounce))
        assert torch.equal(site.scatter_unit_vector(), smp.scatter_unit_vector())
        assert torch.equal(site.dielectric_uniform(), smp.dielectric_uniform())
        _equal(site.dielectric_uniform(), jb.dielectric_uniform())
        np.testing.assert_allclose(site.scatter_unit_vector().numpy(),
                                   np.asarray(jb.scatter_unit_vector()), rtol=0, atol=2e-7)
        if rr:
            assert torch.equal(site.rr_uniform(), smp.rr_uniform())
            _equal(site.rr_uniform(), jb.rr_uniform())
        else:
            with pytest.raises(ValueError, match="without the roulette draw"):
                site.rr_uniform()


@pytest.mark.parametrize("seed", [0, 21, (3 << 32) | 0x9E3779B9])
def test_ktf_family_sites_match_the_chain_and_jax(seed):
    pix = _pixels(seed + 1)
    k0, k1 = (torch.tensor(w, dtype=torch.int32) for w in ktf.key_words(seed))
    draws = ktf.TraceDraws(k0, k1, torch.from_numpy(pix), SAMPLES, S0)
    lane_pix, lane_s = np.tile(pix, SAMPLES), _lane_samples()
    cam = draws.camera()
    chain = ktf.KtfSampler(k0, k1, torch.from_numpy(lane_pix), torch.from_numpy(lane_s),
                           torch.tensor(0, dtype=torch.int32))
    for got, want in zip(cam.jitter_uv() + cam.lens_disk(),
                         chain.jitter_uv() + chain.lens_disk()):
        assert torch.equal(got, want)
    js = jktf.sampler(jax.random.key(seed), lane_pix, lane_s, 0)
    for got, want in zip(cam.jitter_uv(), js.jitter_uv()):
        _equal(got, want)
    for got, want in zip(cam.lens_disk(), js.lens_disk()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    for bounce in (1, MIN_BOUNCES, 7):
        rr = bounce >= MIN_BOUNCES
        site = draws.bounce(bounce, rr)
        smp = chain.at(bounce=bounce)
        jb = jktf.sampler(jax.random.key(seed), lane_pix, lane_s, bounce)
        assert torch.equal(site.scatter_unit_vector(), smp.scatter_unit_vector())
        assert torch.equal(site.dielectric_uniform(), smp.dielectric_uniform())
        _equal(site.dielectric_uniform(), jb.dielectric_uniform())
        np.testing.assert_allclose(site.scatter_unit_vector().numpy(),
                                   np.asarray(jb.scatter_unit_vector()), rtol=0, atol=1e-6)
        if rr:
            assert torch.equal(site.rr_uniform(), smp.rr_uniform())
            _equal(site.rr_uniform(), jb.rr_uniform())


def test_ktf_family_keys_per_pixel_match_the_chain():
    """Key words per pixel (several keys in one render, as pairs_loss
    renders them): lane l reads its pixel's words, not a tiled copy."""
    rs = np.random.default_rng(4)
    pix = _pixels(4)
    k0, k1 = (torch.from_numpy(rs.integers(-2**31, 2**31, N_PIXELS).astype(np.int32))
              for _ in range(2))
    draws = ktf.TraceDraws(k0, k1, torch.from_numpy(pix), SAMPLES, S0)
    chain = ktf.KtfSampler(k0.repeat(SAMPLES), k1.repeat(SAMPLES),
                           torch.from_numpy(np.tile(pix, SAMPLES)),
                           torch.from_numpy(_lane_samples()), torch.tensor(4, dtype=torch.int32))
    site = draws.bounce(4, True)
    for name in ("rr_uniform", "scatter_unit_vector", "dielectric_uniform"):
        assert torch.equal(getattr(site, name)(), getattr(chain, name)()), name
    assert torch.equal(draws.sampler(4).rr_uniform(), chain.rr_uniform())


def test_a_site_draws_once():
    """A site computes its numbers on the first call of any method and
    serves the others from them (one kernel launch on the card)."""
    made = []
    site = ktf.Draws(lambda: made.append(1) or {"rr": torch.zeros(2),
                                                 "scatter": torch.zeros(2, 3),
                                                 "dielectric": torch.ones(2)})
    site.rr_uniform()
    site.scatter_unit_vector()
    site.dielectric_uniform()
    assert len(made) == 1
    assert rng.as_sampler(site) is site


@pytest.mark.parametrize("rng_impl", ["jax", "ktf"])
def test_render_draws_once_per_site_and_matches_jax(rng_impl, monkeypatch):
    """The slice: render_pixels over several traces (a sample offset per
    trace) takes one camera site and one site per bounce in each trace,
    and the image agrees with the JAX package's under the cross-compiler
    tolerance of tests/test_torch_megakernel.py (at most 0.5% of elements
    beyond 5e-4 + 2e-4·|x|, channel means within 1e-3)."""
    module = rng if rng_impl == "jax" else ktf
    calls = {"camera": 0, "bounce": 0}
    for name in calls:
        real = getattr(module, f"{name}_draws")

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, f"{name}_draws", counted)
    kw = dict(width=10, height=7, spp=5, max_bounces=4, rng_impl=rng_impl)
    js = jcornell_materials()
    js = js.replace(bvh4=jbuild_bvh4(js.mesh))
    pose = dict(position=(0.0, 0.05, 0.29), pitch=-5.0)
    jcam = jmake_camera(aspect_ratio=10 / 7, fov_degrees=80.0, aperture=0.02, **pose)
    want = np.asarray(jrender_image(js, jcam, JRenderConfig(**kw), jax.random.key(11)))
    cfg = RenderConfig(**kw, max_rays_per_pass=2 * 70)   # traces of 2, 2 and 1 samples
    got = render_image(scene_from_numpy(to_numpy_tree(js)),
                       camera_from_numpy(to_numpy_tree(jcam)), cfg, 11).numpy()
    assert calls == {"camera": 3, "bounce": 3 * kw["max_bounces"]}
    assert np.isfinite(got).all()
    assert (np.abs(got - want) > 5e-4 + 2e-4 * np.abs(want)).mean() <= 0.005
    assert np.abs(got.mean(axis=(0, 1)) - want.mean(axis=(0, 1))).max() <= 1e-3
    assert float(want.mean()) > 0.05
