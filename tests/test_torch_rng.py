"""raytracer_tpu_torch.utils.rng ≡ jax.random and raytracer_tpu/utils/rng.py.

Keys reach the port as their int32 words (convert.key_words). Bits,
uniforms, fold_in, split and every KeySampler draw that is built from
uniforms alone are held bitwise. Normals go through erf_inv, whose
log1p rounds differently in XLA and in torch: they are held to 3 ulp
(measured maximum 3 over 106,496 draws of 4,096 keys), and the unit vectors and disks
built from them to 2e-7 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.utils import rng as jrng
from raytracer_tpu_torch.convert import key_words
from raytracer_tpu_torch.utils import rng

torch.set_num_threads(2)

NORMAL_ULP = 3


def _words(keys):
    return key_words(jax.random.key_data(keys))


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", [0, 40, 2**32 - 7])
def test_key_fold_in_and_split_bitwise(seed):
    k = jax.random.key(seed)
    tk = rng.key(seed)
    assert tuple(int(w) for w in tk) == tuple(int(w) for w in _words(k))
    for d in (0, 5, 123456):
        want = _words(jax.random.fold_in(k, d))
        got = rng.fold_in(tk, d)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    want = _words(jax.random.split(k, 16))
    got = rng.split(tk, 16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", [(), (3,), (5, 4)])
def test_bits_uniform_bitwise_and_normal_ulp(shape):
    keys = jax.random.split(jax.random.key(7), 2048)
    tk = _words(keys)
    jb = jax.vmap(lambda k: jax.random.bits(k, shape))(keys)
    np.testing.assert_array_equal(rng.random_bits(tk, shape).numpy(),
                                  np.asarray(jb).view(np.int32))
    ju = jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)
    np.testing.assert_array_equal(rng.random_uniform(tk, shape).numpy(), np.asarray(ju))
    jn = jax.vmap(lambda k: jax.random.normal(k, shape))(keys)
    assert _ulp(rng.random_normal(tk, shape).numpy(), jn).max() <= NORMAL_ULP


def test_erf_inv_is_xlas_polynomial():
    """Within 2 ulp of XLA's ErfInv across (-1, 1), exact at ±1, and not
    torch.erfinv (a different algorithm)."""
    u = np.linspace(-0.99999994, 0.99999994, 200_001).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    got = rng.erf_inv(torch.from_numpy(u)).numpy()
    assert _ulp(got, want).max() <= 2
    edge = rng.erf_inv(torch.tensor([-1.0, 1.0])).numpy()
    assert np.isneginf(edge[0]) and np.isposinf(edge[1])


def test_lane_keys_and_key_sampler_draws():
    rs = np.random.default_rng(3)
    pix = rs.integers(0, 2560 * 1440, 1000).astype(np.int32)
    smp_ids = rs.integers(0, 64, 1000).astype(np.int32)
    jkeys = jrng.fold(jrng.fold(jrng.lane_keys(jax.random.key(9), jnp.asarray(pix)),
                                jnp.asarray(smp_ids)), 2)
    tkeys = rng.fold(rng.fold(rng.lane_keys(rng.key(9), torch.from_numpy(pix)),
                              torch.from_numpy(smp_ids)), 2)
    assert all(torch.equal(g, w) for g, w in zip(tkeys, _words(jkeys)))

    js, ts = jrng.KeySampler(jkeys), rng.as_sampler(tkeys)
    for name in ("rr_uniform", "dielectric_uniform"):
        np.testing.assert_array_equal(getattr(ts, name)().numpy(),
                                      np.asarray(getattr(js, name)()), err_msg=name)
    for a, b in zip(ts.jitter_uv(), js.jitter_uv()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(ts.scatter_unit_vector().numpy(),
                               np.asarray(js.scatter_unit_vector()), rtol=0, atol=2e-7)
    for a, b in zip(ts.lens_disk(), js.lens_disk()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-7)
    assert rng.as_sampler(ts) is ts
