"""raytracer_tpu_torch ktf RNG, camera and tone map ≡ the JAX package.

Inputs come from numpy seeds and go through both packages. The integer
RNG is held bitwise; draws that pass through cos/sin are held to 1e-6
absolute (the two libraries' transcendental functions may round
differently by an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu import camera as jcam
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.ops import tonemap as jtone
from raytracer_tpu.utils import ktf as jktf
from raytracer_tpu_torch import camera as tcam
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import camera_from_numpy, to_numpy_tree
from raytracer_tpu_torch.ops import tonemap as ttone
from raytracer_tpu_torch.utils import ktf

torch.set_num_threads(2)

SEEDS = (0, 21, (3 << 32) | 0x9E3779B9)


def _counters(n, seed):
    rng = np.random.default_rng(seed)
    c0 = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    c1 = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return c0, c1


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_match_jax_keys(seed):
    jk0, jk1 = jktf.key_words(jax.random.key(seed))
    assert ktf.key_words(seed) == (int(jk0), int(jk1))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_and_u01_bitwise(seed):
    c0, c1 = _counters(100_000, seed + 1)
    k0, k1 = ktf.key_words(seed)
    jx0, jx1 = jktf.threefry2x32(jnp.int32(k0), jnp.int32(k1), c0, c1)
    tx0, tx1 = ktf.threefry2x32(k0, k1, torch.from_numpy(c0), torch.from_numpy(c1))
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))
    np.testing.assert_array_equal(tx1.numpy(), np.asarray(jx1))
    np.testing.assert_array_equal(ktf.u01(tx0).numpy(), np.asarray(jktf.u01(jx0)))
    # The CPU wrapper of the K2 kernel is the plain version.
    kx0, _ = ktf.threefry2x32_kernel(k0, k1, torch.from_numpy(c0), torch.from_numpy(c1))
    np.testing.assert_array_equal(kx0.numpy(), np.asarray(jx0))


def _from_exact(port, ref, exact) -> str:
    """How far the port's and JAX's values are from `exact` (float64)."""
    parts = []
    for who, v in (("the port (torch)", port), ("JAX", ref)):
        off = np.abs(v.astype(np.float64) - exact)
        parts.append(f"{who}: max |value - exact| {off.max():.3g}, {int((off > 1e-6).sum())} "
                     f"of {off.size} beyond 1e-6")
    return "; ".join(parts)


@pytest.mark.parametrize("seed", SEEDS)
def test_sampler_methods_match(seed):
    rng = np.random.default_rng(seed % 1000)
    n = 20_000
    pixel = rng.integers(0, 2560 * 1440, n).astype(np.int32)
    sample = rng.integers(0, 4096, n).astype(np.int32)
    bounce = rng.integers(0, 20, n).astype(np.int32)
    js = jktf.sampler(jax.random.key(seed), pixel, sample, bounce)
    ts = ktf.sampler(seed, torch.from_numpy(pixel), torch.from_numpy(sample),
                     torch.from_numpy(bounce))
    for purpose in (ktf.JITTER, ktf.LENS, ktf.RR, ktf.SCATTER, ktf.DIELECTRIC):
        np.testing.assert_array_equal(ts.uniform(purpose).numpy(),
                                      np.asarray(js.uniform(purpose)))
        for a, b in zip(ts.uniform_pair(purpose), js.uniform_pair(purpose)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # lens_disk from the (bitwise equal) uniforms in float64: the failure
    # message says how far each side is from it.
    u1, u2 = (u.numpy().astype(np.float64) for u in ts.uniform_pair(ktf.LENS))
    disk = (np.sqrt(u1) * np.cos(2 * np.pi * u2), np.sqrt(u1) * np.sin(2 * np.pi * u2))
    exact = ((None, None), disk)
    for a, b, e in zip((ts.jitter_uv(), ts.lens_disk()), (js.jitter_uv(), js.lens_disk()), exact):
        for x, y, ex in zip(a, b, e):
            x, y = x.numpy(), np.asarray(y)
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=0,
                                       err_msg="" if ex is None else _from_exact(x, y, ex))
    np.testing.assert_array_equal(ts.rr_uniform().numpy(), np.asarray(js.rr_uniform()))
    np.testing.assert_array_equal(ts.dielectric_uniform().numpy(),
                                  np.asarray(js.dielectric_uniform()))
    np.testing.assert_allclose(ts.scatter_unit_vector().numpy(),
                               np.asarray(js.scatter_unit_vector()), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.disk(ktf.LENS).numpy(), np.asarray(js.disk(ktf.LENS)),
                               atol=1e-6, rtol=0)
    moved = ts.at(sample=7, bounce=3)
    np.testing.assert_array_equal(moved.uniform(ktf.RR).numpy(),
                                  np.asarray(js.at(sample=7, bounce=3).uniform(ktf.RR)))


CAMERAS = [
    dict(position=(0.0, 0.05, 0.29), pitch=-5.0),                      # showcase
    dict(),                                                             # reference pose
    dict(position=(0.3, -0.2, 1.5), yaw=-70.0, pitch=12.0, aperture=0.05, fov_degrees=55.0),
]


@pytest.mark.parametrize("kw", CAMERAS)
def test_camera_basis_and_rays(kw):
    cfg = RenderConfig(width=96, height=64)
    jc = jcam.make_camera(aspect_ratio=cfg.aspect_ratio, **kw)
    tc = tcam.make_camera(aspect_ratio=cfg.aspect_ratio, **kw)
    # The converted JAX camera and the port's own constructor agree.
    conv = camera_from_numpy(to_numpy_tree(jc))
    for f in ("position", "yaw", "pitch", "world_up", "fov_degrees", "aperture", "focus_dist"):
        np.testing.assert_array_equal(getattr(conv, f).numpy(), getattr(tc, f).numpy())
    jb, tb = jcam.camera_basis(jc), tcam.camera_basis(tc)
    for k in jb:
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), rtol=1e-6, atol=1e-7)

    rng = np.random.default_rng(3)
    px = rng.integers(0, cfg.width, 4096).astype(np.int32)
    py = rng.integers(0, cfg.height, 4096).astype(np.int32)
    pix = (py * cfg.width + px).astype(np.int32)
    jo, jd = jcam.generate_rays(jc, jnp.asarray(px), jnp.asarray(py), cfg.width, cfg.height,
                                jktf.sampler(jax.random.key(5), pix, 3, 0))
    to, td = tcam.generate_rays(tc, torch.from_numpy(px), torch.from_numpy(py), cfg.width,
                                cfg.height, ktf.sampler(5, torch.from_numpy(pix), 3, 0))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)


def test_showcase_camera_matches():
    cfg = JRenderConfig(width=2560, height=1440)
    jc = jcam.showcase_camera(cfg)
    tc = tcam.showcase_camera(RenderConfig(width=2560, height=1440))
    np.testing.assert_array_equal(tc.focus_dist.numpy(), np.asarray(jc.focus_dist))
    assert tc.aspect_ratio == jc.aspect_ratio


def test_to_rgba8_exact():
    rng = np.random.default_rng(8)
    lin = rng.uniform(-0.5, 2.0, (64, 48, 3)).astype(np.float32)
    lin[0, :4, 0] = [0.0, 0.998001, 0.999 ** 2, 1.0]
    np.testing.assert_array_equal(ttone.to_rgba8(torch.from_numpy(lin)).numpy(),
                                  np.asarray(jtone.to_rgba8(jnp.asarray(lin))))
    d = rng.normal(size=(512, 3)).astype(np.float32)
    np.testing.assert_allclose(ttone.sky_color(torch.from_numpy(d)).numpy(),
                               np.asarray(jtone.sky_color(jnp.asarray(d))), rtol=1e-6)
