"""The jax.random Threefry family on int32 tensors, and the pixel-keyed
draw discipline built on it (port of raytracer_tpu/utils/rng.py).

The JAX package's default RNG (`rng_impl="jax"`) keys every draw by

    lane_key = fold(fold(fold(base, pixel_id), sample), bounce)
    draw     = jax.random.{uniform,normal} of fold(lane_key, purpose)

A key here is a pair (k0, k1) of int32 tensors of one shape: the two
uint32 words of a jax.random threefry key, reinterpreted as int32 (a key
array is the same pair with a leading shape). The functions reproduce
jax.random under `jax_threefry_partitionable=True`, the default of
jax 0.9:

    key(seed)          = (0, seed mod 2^32)
    fold_in(k, d)      = threefry2x32(k, (0, d))
    split(k, n)[i]     = threefry2x32(k, (0, i))
    random_bits(k, s)  = x0 ^ x1 of threefry2x32(k, (0, i)), i the
                         row-major index into shape s
    uniform            = bitcast(bits >>> 9 | 0x3F800000) - 1, scaled
    normal             = sqrt(2) * erf_inv(uniform on (nextafter(-1, 0), 1))

Bits and uniforms are bitwise those of jax.random. `erf_inv` is XLA's
float32 ErfInv (Giles' polynomial) restated in torch ops; torch.erfinv
is another function. Its log1p may round differently from XLA's, so
normals agree to a few ulp (tests/test_torch_rng.py states the bound).

Every Threefry call goes through `ktf.threefry2x32_kernel`: kernel K2
(csrc/ktf.cu) on CUDA tensors, the plain version on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.utils.ktf import _i32, threefry2x32_kernel

# Purpose tags (distinct constants folded into lane keys).
P_RAYGEN_JITTER_U = 0x11
P_RAYGEN_JITTER_V = 0x12
P_RAYGEN_LENS = 0x13
P_RR = 0x21
P_SCATTER_UNIT = 0x31
P_DIELECTRIC = 0x32

_ONE_BITS = int(np.float32(1.0).view(np.int32))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's ErfInv32 coefficients (w < 5, w >= 5), highest power first.
_ERFINV_LT5 = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def key(seed: int, device=None):
    """jax.random.key(seed) as its int32 words (0, seed mod 2^32)."""
    return (torch.zeros((), dtype=torch.int32, device=device),
            torch.tensor(_i32(seed), dtype=torch.int32, device=device))


def _cipher(k, c0, c1):
    return threefry2x32_kernel(k[0], k[1], c0, c1)


def fold_in(k, data):
    """jax.random.fold_in over a key array: `data` is an int or an int32
    tensor that broadcasts against the key words."""
    d = torch.as_tensor(data, dtype=torch.int32, device=k[0].device)
    return _cipher(k, torch.zeros_like(d), d)


def split(k, num: int):
    """jax.random.split(k, num) for one key → key array of shape [num]."""
    i = torch.arange(num, dtype=torch.int32, device=k[0].device)
    return _cipher(k, torch.zeros_like(i), i)


def random_bits(k, shape=()):
    """jax.random.bits(k, shape) (uint32 as int32) for a key array of
    shape K → int32[*K, *shape]."""
    size = int(np.prod(shape))
    if size >= 2 ** 31:
        raise ValueError(f"random_bits: {size} draws per key exceed the int32 counter")
    i = torch.arange(size, dtype=torch.int32, device=k[0].device).reshape(shape)
    lead = (...,) + (None,) * len(shape)
    x0, x1 = _cipher((k[0][lead], k[1][lead]), torch.zeros_like(i), i)
    return x0 ^ x1


def random_uniform(k, shape=(), minval: float = 0.0, maxval: float = 1.0):
    """jax.random.uniform(k, shape, float32, minval, maxval)."""
    bits = random_bits(k, shape)
    fbits = ((bits >> 9) & ((1 << 23) - 1)) | _ONE_BITS
    floats = fbits.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * span + lo, lo)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (Giles' single-precision polynomial)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def random_normal(k, shape=()):
    """jax.random.normal(k, shape, float32)."""
    u = random_uniform(k, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erf_inv(u)


# --- the pixel-keyed discipline (raytracer_tpu/utils/rng.py) ----------


def lane_keys(base, lane_ids):
    """key[i] = fold_in(base, lane_ids[i]) — an [N] key array. `base` may
    itself be a key array that broadcasts against lane_ids (one base
    key per lane when several keys share a render)."""
    return fold_in(base, lane_ids)


def fold(keys, x):
    """Fold a scalar or a per-lane int32 tensor into a key array."""
    return fold_in(keys, x)


def uniform(keys, purpose: int) -> torch.Tensor:
    """U[0,1) per lane."""
    return random_uniform(fold(keys, purpose))


def random_unit_vector(keys, purpose: int) -> torch.Tensor:
    """Uniform direction on the unit sphere, [N,3]: a normalized
    isotropic Gaussian."""
    g = random_normal(fold(keys, purpose), (3,))
    n = torch.sqrt(g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2])
    return g / torch.clamp_min(n, 1e-12)[..., None]


def random_in_unit_disk(keys, purpose: int) -> torch.Tensor:
    """Uniform point in the unit disk (z = 0), [N,3], polar closed form."""
    u = random_uniform(fold(keys, purpose), (2,))
    r = torch.sqrt(u[..., 0])
    theta = float(np.float32(2.0 * np.pi)) * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)


class KeySampler(NamedTuple):
    """jax.random-backed sampler over (pixel, sample, bounce)-folded lane
    keys — the Sampler protocol of utils/ktf.KtfSampler."""

    keys: tuple  # (k0, k1) int32 [N]

    def jitter_uv(self):
        return uniform(self.keys, P_RAYGEN_JITTER_U), uniform(self.keys, P_RAYGEN_JITTER_V)

    def lens_disk(self):
        d = random_in_unit_disk(self.keys, P_RAYGEN_LENS)
        return d[..., 0], d[..., 1]

    def rr_uniform(self):
        return uniform(self.keys, P_RR)

    def scatter_unit_vector(self):
        return random_unit_vector(self.keys, P_SCATTER_UNIT)

    def dielectric_uniform(self):
        return uniform(self.keys, P_DIELECTRIC)


def as_sampler(keys_or_sampler):
    """Lane keys (k0, k1) become a KeySampler; samplers pass through."""
    if hasattr(keys_or_sampler, "rr_uniform"):
        return keys_or_sampler
    return KeySampler(tuple(keys_or_sampler))
