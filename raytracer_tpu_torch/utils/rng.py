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

Every Threefry call goes through `ktf.threefry2x32_kernel` (kernel K2,
csrc/ktf.cu, on CUDA tensors; the plain version on CPU tensors) unless
`kernel=False` asks for the plain version on any device. The paths draw
through `TraceDraws`: one draw kernel per camera and per bounce on the
card (csrc/ktf.cu), whose plain version is the per-method chain below.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.utils import ktf
from raytracer_tpu_torch.utils.ktf import _i32, threefry2x32, threefry2x32_kernel

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


def _cipher(k, c0, c1, kernel=True):
    return (threefry2x32_kernel if kernel else threefry2x32)(k[0], k[1], c0, c1)


def fold_in(k, data, kernel=True):
    """jax.random.fold_in over a key array: `data` is an int or an int32
    tensor that broadcasts against the key words."""
    d = torch.as_tensor(data, dtype=torch.int32, device=k[0].device)
    return _cipher(k, torch.zeros_like(d), d, kernel)


def split(k, num: int):
    """jax.random.split(k, num) for one key → key array of shape [num]."""
    i = torch.arange(num, dtype=torch.int32, device=k[0].device)
    return _cipher(k, torch.zeros_like(i), i)


def random_bits(k, shape=(), kernel=True):
    """jax.random.bits(k, shape) (uint32 as int32) for a key array of
    shape K → int32[*K, *shape]."""
    size = int(np.prod(shape))
    if size >= 2 ** 31:
        raise ValueError(f"random_bits: {size} draws per key exceed the int32 counter")
    i = torch.arange(size, dtype=torch.int32, device=k[0].device).reshape(shape)
    lead = (...,) + (None,) * len(shape)
    x0, x1 = _cipher((k[0][lead], k[1][lead]), torch.zeros_like(i), i, kernel)
    return x0 ^ x1


def random_uniform(k, shape=(), minval: float = 0.0, maxval: float = 1.0, kernel=True):
    """jax.random.uniform(k, shape, float32, minval, maxval)."""
    bits = random_bits(k, shape, kernel)
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


def random_normal(k, shape=(), kernel=True):
    """jax.random.normal(k, shape, float32)."""
    u = random_uniform(k, shape, _NORMAL_LO, 1.0, kernel)
    return _SQRT2 * erf_inv(u)


# --- the pixel-keyed discipline (raytracer_tpu/utils/rng.py) ----------


def lane_keys(base, lane_ids):
    """key[i] = fold_in(base, lane_ids[i]) — an [N] key array. `base` may
    itself be a key array that broadcasts against lane_ids (one base
    key per lane when several keys share a render)."""
    return fold_in(base, lane_ids)


def fold(keys, x, kernel=True):
    """Fold a scalar or a per-lane int32 tensor into a key array."""
    return fold_in(keys, x, kernel)


def uniform(keys, purpose: int, kernel=True) -> torch.Tensor:
    """U[0,1) per lane."""
    return random_uniform(fold(keys, purpose, kernel), kernel=kernel)


def random_unit_vector(keys, purpose: int, kernel=True) -> torch.Tensor:
    """Uniform direction on the unit sphere, [N,3]: a normalized
    isotropic Gaussian."""
    g = random_normal(fold(keys, purpose, kernel), (3,), kernel)
    n = torch.sqrt(g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2])
    return g / torch.clamp_min(n, 1e-12)[..., None]


def random_in_unit_disk(keys, purpose: int, kernel=True) -> torch.Tensor:
    """Uniform point in the unit disk (z = 0), [N,3], polar closed form."""
    u = random_uniform(fold(keys, purpose, kernel), (2,), kernel=kernel)
    r = torch.sqrt(u[..., 0])
    theta = float(np.float32(2.0 * np.pi)) * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)


class KeySampler(NamedTuple):
    """jax.random-backed sampler over (pixel, sample, bounce)-folded lane
    keys — the Sampler protocol of utils/ktf.KtfSampler. Each method is
    the chain of folds and draws (K2 launches on CUDA tensors; the plain
    Threefry with kernel=False)."""

    keys: tuple  # (k0, k1) int32 [N]
    kernel: bool = True

    def jitter_uv(self):
        return (uniform(self.keys, P_RAYGEN_JITTER_U, self.kernel),
                uniform(self.keys, P_RAYGEN_JITTER_V, self.kernel))

    def lens_disk(self):
        d = random_in_unit_disk(self.keys, P_RAYGEN_LENS, self.kernel)
        return d[..., 0], d[..., 1]

    def rr_uniform(self):
        return uniform(self.keys, P_RR, self.kernel)

    def scatter_unit_vector(self):
        return random_unit_vector(self.keys, P_SCATTER_UNIT, self.kernel)

    def dielectric_uniform(self):
        return uniform(self.keys, P_DIELECTRIC, self.kernel)


# --- draw sites: one kernel launch per site on the card -------------------


class TraceDraws:
    """The draws of one trace of render.render_pixels in the jax family:
    `samples` samples of n pixels with lane keys `pkeys` ((k0, k1) [n],
    lane_keys' output), sample-major (lane l is pixel l % n at sample
    s0 + l // n). `camera()` is the trace's camera draw site, which also
    makes the sample-folded lane keys; `bounce(b, rr)` folds the bounce
    into those."""

    def __init__(self, pkeys, samples: int, s0: int):
        self.pkeys, self.samples, self.s0 = pkeys, int(samples), int(s0)
        self._camera = ktf.Draws(lambda: camera_draws(self.pkeys, self.samples, self.s0))

    def camera(self) -> "ktf.Draws":
        return self._camera

    def lane_keys(self):
        """The sample-folded lane keys (k0, k1) [n * samples]."""
        return self._camera.numbers()["keys"]

    def bounce(self, bounce: int, rr: bool) -> "ktf.Draws":
        return ktf.Draws(lambda: bounce_draws(self.lane_keys(), bounce, rr))


def camera_draws_plain(pkeys, samples: int, s0: int, kernel: bool = False) -> dict:
    """Plain version of the jax camera draw kernel: the pixel keys tiled
    over the samples, the samples folded in, then KeySampler's chain (K2
    for each fold and draw with kernel=True, the route before the
    kernel)."""
    n, dev = pkeys[0].shape[0], pkeys[0].device
    s = (torch.arange(samples, dtype=torch.int32, device=dev) + s0).repeat_interleave(n)
    keys = fold((pkeys[0].repeat(samples), pkeys[1].repeat(samples)), s, kernel)
    smp = KeySampler(keys, kernel)
    ju, jv = smp.jitter_uv()
    lx, ly = smp.lens_disk()
    return dict(keys=keys, jitter_u=ju, jitter_v=jv, lens_x=lx, lens_y=ly)


def bounce_draws_plain(keys, bounce: int, rr: bool, kernel: bool = False) -> dict:
    """Plain version of the jax bounce draw kernel: the bounce folded into
    the lane keys, then KeySampler's chain."""
    smp = KeySampler(fold(keys, bounce, kernel), kernel)
    out = dict(scatter=smp.scatter_unit_vector(), dielectric=smp.dielectric_uniform())
    if rr:
        out["rr"] = smp.rr_uniform()
    return out


def camera_draws(pkeys, samples: int, s0: int) -> dict:
    """The jax family's camera draws of a trace (and its lane keys): one
    launch of the camera draw kernel (csrc/ktf.cu) on CUDA tensors, the
    plain version on CPU tensors."""
    if pkeys[0].device.type == "cpu":
        return camera_draws_plain(pkeys, samples, s0)
    from raytracer_tpu_torch.utils import cudalib

    n, dev = pkeys[0].shape[0], pkeys[0].device
    for name, k in zip(("k0", "k1"), pkeys):
        cudalib.require_cuda(name, k, torch.int32, (n,))
    total = ktf._lanes(n, samples)
    out, d = ktf.camera_outputs(total, dev)
    keys = torch.empty((2, total), dtype=torch.int32, device=dev)
    cudalib.check(cudalib.lib().rt_draws_camera_jax(
        pkeys[0].data_ptr(), pkeys[1].data_ptr(), n, total, int(s0), keys.data_ptr(),
        out.data_ptr(), cudalib.stream_handle()), "camera draw kernel (jax)")
    ktf.LAUNCHES.count("camera_draws")
    return dict(d, keys=(keys[0], keys[1]))


def bounce_draws(keys, bounce: int, rr: bool) -> dict:
    """The jax family's draws of one bounce over lane keys (k0, k1) [N]
    (the roulette draw only when `rr`): one launch of the bounce draw
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if keys[0].device.type == "cpu":
        return bounce_draws_plain(keys, bounce, rr)
    from raytracer_tpu_torch.utils import cudalib

    total, dev = keys[0].shape[0], keys[0].device
    for name, k in zip(("k0", "k1"), keys):
        cudalib.require_cuda(name, k, torch.int32, (total,))
    out, d = ktf.bounce_outputs(total, rr, dev)
    cudalib.check(cudalib.lib().rt_draws_bounce_jax(
        keys[0].data_ptr(), keys[1].data_ptr(), total, int(bounce), int(bool(rr)),
        out.data_ptr(), cudalib.stream_handle()), "bounce draw kernel (jax)")
    ktf.LAUNCHES.count("bounce_draws")
    return d


def as_sampler(keys_or_sampler):
    """Lane keys (k0, k1) become a KeySampler; samplers pass through."""
    if hasattr(keys_or_sampler, "rr_uniform"):
        return keys_or_sampler
    return KeySampler(tuple(keys_or_sampler))
