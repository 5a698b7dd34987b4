"""Counter-based Threefry-2x32 RNG on int32 tensors (port of
raytracer_tpu/utils/ktf.py).

This is the plain PyTorch version of kernel K2; the CUDA version is
`csrc/ktf.cuh`, compiled into the path-loop kernel, and `csrc/ktf.cu`,
whose draw kernels give the differentiable path one launch per draw
site (`TraceDraws`, `Draws`). Both follow one
spec — standard Threefry-2x32 (20 rounds) with the counter layout

  c0 = pixel_id
  c1 = (sample << 9) | (bounce << 4) | purpose

and the uniform map u01(bits) = f32(bits >>> 9) * 2^-23 — so the port
draws the same bits as the JAX package for the same key words.

Key words: under JAX's default 32-bit mode `jax.random.key(seed)` holds
(0, seed mod 2^32); `key_words(seed)` returns the same pair as int32
without JAX.

Integer arithmetic: adds wrap in two's complement exactly like uint32
adds. torch's `>>` on int32 is an ARITHMETIC shift, so every logical
right shift below masks off the sign-extended bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from raytracer_tpu_torch.utils import profiling

# Purpose tags (must stay < 16; see the counter layout above).
JITTER = 1      # raygen pixel jitter: (u, v) from one block
LENS = 2        # raygen lens-disk sample: (u1, u2) from one block
RR = 3          # Russian-roulette survival draw
SCATTER = 4     # material unit-vector sample: (u1, u2) from one block
DIELECTRIC = 5  # Schlick reflect-vs-refract draw

_PARITY = int(np.int32(np.uint32(0x1BD11BDA)))
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
TWO_PI = 2.0 * math.pi


def _i32(x) -> int:
    """Python int → the int32 with the same low 32 bits."""
    return int(np.uint32(int(x) & 0xFFFFFFFF).astype(np.int32))


def _srl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int32 by a constant 0 < r < 32."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _srl(x, 32 - r)


def key_words(seed: int) -> tuple[int, int]:
    """Integer seed → (k0, k1) int32 key words of jax.random.key(seed)."""
    return 0, _i32(seed)


def threefry2x32(k0, k1, c0: torch.Tensor, c1: torch.Tensor):
    """Standard Threefry-2x32, 20 rounds, on int32 tensors (k0/k1 python
    ints or int32 tensors, c0/c1 broadcastable int32 tensors). Returns
    (x0, x1) int32."""
    PLAIN_CALLS.count("threefry2x32")
    c0 = torch.as_tensor(c0, dtype=torch.int32)
    c1 = torch.as_tensor(c1, dtype=torch.int32, device=c0.device)
    k0 = _i32(k0) if not torch.is_tensor(k0) else k0
    k1 = _i32(k1) if not torch.is_tensor(k1) else k1
    ks2 = k0 ^ k1 ^ _PARITY
    if not torch.is_tensor(ks2):
        ks2 = _i32(ks2)
    x0 = c0 + k0
    x1 = c1 + k1

    def four_rounds(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        return x0, x1

    # Injection schedule: after group i (1-based), x0 += ks[i%3],
    # x1 += ks[(i+1)%3] + i, with ks = [k0, k1, ks2].
    x0, x1 = four_rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + k1, x1 + ks2 + 1
    x0, x1 = four_rounds(x0, x1, _ROT_B)
    x0, x1 = x0 + ks2, x1 + k0 + 2
    x0, x1 = four_rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + k0, x1 + k1 + 3
    x0, x1 = four_rounds(x0, x1, _ROT_B)
    x0, x1 = x0 + k1, x1 + ks2 + 4
    x0, x1 = four_rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + ks2, x1 + k0 + 5
    return x0, x1


def u01(bits: torch.Tensor) -> torch.Tensor:
    """int32 random bits → f32 uniform in [0, 1): f32(bits >>> 9) * 2^-23
    (exact)."""
    return _srl(bits, 9).to(torch.float32) * (2.0 ** -23)


def counter(sample, bounce, purpose: int) -> torch.Tensor:
    """c1 word: (sample << 9) | (bounce << 4) | purpose."""
    s = torch.as_tensor(sample, dtype=torch.int32)
    b = torch.as_tensor(bounce, dtype=torch.int32, device=s.device)
    return (s << 9) | (b << 4) | purpose


def unit_vector_parts(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform direction on the unit sphere from 2 uniforms: z = 1-2u1,
    phi = 2*pi*u2 (Core/Utility.cuh:73-76 distribution)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    return r * torch.cos(phi), r * torch.sin(phi), z


@dataclass(frozen=True)
class KtfSampler:
    """Per-lane draw context: pixel ids + the (sample, bounce) word.
    Works on any tensor shape; the trig-derived draws return separate
    tensors (`*_parts`) or components stacked on a new last axis.

    Key words are python ints or int32 tensors that broadcast against
    the pixels (one key per lane when several keys share one render).
    `kernel=True` draws through `threefry2x32_kernel` (K2 on CUDA
    tensors); the default is the plain version on any device."""

    k0: object            # int or i32 tensor
    k1: object
    pixel: torch.Tensor   # i32[...] pixel ids (c0)
    sample: torch.Tensor  # i32 scalar or [...] per-lane sample index
    bounce: torch.Tensor  # i32 scalar or [...] per-lane bounce index
    kernel: bool = False

    def _block(self, purpose: int):
        cipher = threefry2x32_kernel if self.kernel else threefry2x32
        return cipher(self.k0, self.k1, self.pixel,
                      counter(self.sample, self.bounce, purpose))

    def uniform(self, purpose: int) -> torch.Tensor:
        a, _ = self._block(purpose)
        return u01(a)

    def uniform_pair(self, purpose: int):
        a, b = self._block(purpose)
        return u01(a), u01(b)

    def unit_vector_parts(self, purpose: int):
        """Uniform direction on the unit sphere (`unit_vector_parts` of
        the module) from the block's two uniforms."""
        return unit_vector_parts(*self.uniform_pair(purpose))

    def unit_vector(self, purpose: int) -> torch.Tensor:
        return torch.stack(self.unit_vector_parts(purpose), dim=-1)

    def disk_parts(self, purpose: int):
        """Uniform point in the unit disk (polar closed form;
        Core/Utility.cuh:55-62 distribution)."""
        u1, u2 = self.uniform_pair(purpose)
        r = torch.sqrt(u1)
        theta = TWO_PI * u2
        return r * torch.cos(theta), r * torch.sin(theta)

    def disk(self, purpose: int) -> torch.Tensor:
        x, y = self.disk_parts(purpose)
        return torch.stack([x, y, torch.zeros_like(x)], dim=-1)

    # --- Sampler protocol (raytracer_tpu/utils/rng.py) ---
    def jitter_uv(self):
        return self.uniform_pair(JITTER)

    def lens_disk(self):
        return self.disk_parts(LENS)

    def rr_uniform(self):
        return self.uniform(RR)

    def scatter_unit_vector(self):
        return self.unit_vector(SCATTER)

    def dielectric_uniform(self):
        return self.uniform(DIELECTRIC)

    def at(self, sample=None, bounce=None) -> "KtfSampler":
        dev = self.pixel.device
        return replace(
            self,
            sample=self.sample if sample is None
            else torch.as_tensor(sample, dtype=torch.int32, device=dev),
            bounce=self.bounce if bounce is None
            else torch.as_tensor(bounce, dtype=torch.int32, device=dev))


def sampler(key, pixel_ids, sample=0, bounce=0) -> KtfSampler:
    """Integer seed (the port's stand-in for a jax.random key) or key
    words (k0, k1) → sampler that draws through K2 on CUDA tensors."""
    k0, k1 = key if isinstance(key, tuple) else key_words(key)
    pixel = torch.as_tensor(pixel_ids, dtype=torch.int32)
    dev = pixel.device
    if torch.is_tensor(k0):
        k0, k1 = k0.to(dev), k1.to(dev)
    return KtfSampler(k0=k0, k1=k1, pixel=pixel,
                      sample=torch.as_tensor(sample, dtype=torch.int32, device=dev),
                      bounce=torch.as_tensor(bounce, dtype=torch.int32, device=dev),
                      kernel=True)


# K2 launches: the Threefry blocks of csrc/ktf.cu's two entry points, and
# its draw kernels (camera and bounce draws, both families).
LAUNCHES = profiling.group("launch", ("threefry2x32", "camera_draws", "bounce_draws"))
# Calls of the plain Threefry (K2's plain version).
PLAIN_CALLS = profiling.group("plain", ("threefry2x32",))
KERNEL_BLOCK = 256


def threefry2x32_kernel(k0, k1, c0, c1):
    """`threefry2x32` through kernel K2 on CUDA tensors (csrc/ktf.cu; the
    path loop runs the same __device__ code inline), through the plain
    version above on CPU tensors. Keys are python ints or int32 tensors;
    keys and counters broadcast against each other."""
    c0 = torch.as_tensor(c0, dtype=torch.int32)
    if c0.device.type == "cpu":
        return threefry2x32(k0, k1, c0, c1)
    from raytracer_tpu_torch.utils import cudalib

    dev = c0.device
    keyed = torch.is_tensor(k0) or torch.is_tensor(k1)
    parts = [c0, torch.as_tensor(c1, dtype=torch.int32, device=dev)]
    if keyed:
        parts += [torch.as_tensor(k, dtype=torch.int32, device=dev) for k in (k0, k1)]
    shape = torch.broadcast_shapes(*(p.shape for p in parts))
    flat = [p.expand(shape).reshape(-1).contiguous() for p in parts]
    n = flat[0].numel()
    for name, t in zip(("c0", "c1", "k0", "k1"), flat):
        cudalib.require_cuda(name, t, torch.int32, (n,))
    x0, x1 = torch.empty_like(flat[0]), torch.empty_like(flat[0])
    if keyed:
        code = cudalib.lib().rt_ktf_threefry_keyed(
            flat[2].data_ptr(), flat[3].data_ptr(), flat[0].data_ptr(), flat[1].data_ptr(), n,
            x0.data_ptr(), x1.data_ptr(), KERNEL_BLOCK, cudalib.stream_handle())
    else:
        code = cudalib.lib().rt_ktf_threefry(
            _i32(k0) & 0xFFFFFFFF, _i32(k1) & 0xFFFFFFFF, flat[0].data_ptr(),
            flat[1].data_ptr(), n, x0.data_ptr(), x1.data_ptr(), KERNEL_BLOCK,
            cudalib.stream_handle())
    cudalib.check(code, "threefry2x32 kernel")
    LAUNCHES.count("threefry2x32")
    return x0.reshape(shape), x1.reshape(shape)


# --- draw sites: one kernel launch per site on the card -------------------


class Draws:
    """The Sampler protocol over the numbers of one draw site, which
    `make()` returns as a dict (jitter_u, jitter_v, lens_x, lens_y at a
    trace's camera; rr, scatter, dielectric at a bounce) on the first
    call of any method: one draw kernel on CUDA tensors, the per-method
    chain on CPU tensors. Draws are counter-based, so computing a site's
    numbers together changes none of them."""

    def __init__(self, make):
        self._make, self._out = make, None

    def numbers(self) -> dict:
        if self._out is None:
            self._out = self._make()
        return self._out

    def jitter_uv(self):
        d = self.numbers()
        return d["jitter_u"], d["jitter_v"]

    def lens_disk(self):
        d = self.numbers()
        return d["lens_x"], d["lens_y"]

    def rr_uniform(self):
        d = self.numbers()
        if "rr" not in d:
            raise ValueError("this bounce's draws were made without the roulette draw "
                             "(bounce below min_bounces)")
        return d["rr"]

    def scatter_unit_vector(self):
        return self.numbers()["scatter"]

    def dielectric_uniform(self):
        return self.numbers()["dielectric"]


@dataclass(frozen=True)
class TraceDraws:
    """The draws of one trace of render.render_pixels in the ktf family:
    `samples` samples of the n pixels `pixel`, sample-major (lane l is
    pixel l % n at sample s0 + l // n), under key words k0, k1 (int32,
    0-d or one per pixel). `camera()` and `bounce(b, rr)` are the trace's
    draw sites."""

    k0: torch.Tensor
    k1: torch.Tensor
    pixel: torch.Tensor   # i32[n]
    samples: int
    s0: int

    def camera(self) -> Draws:
        return Draws(lambda: camera_draws(self))

    def bounce(self, bounce: int, rr: bool) -> Draws:
        return Draws(lambda: bounce_draws(self, bounce, rr))

    def sampler(self, bounce: int, kernel: bool = False) -> KtfSampler:
        """The per-method chain over the trace's lanes (tiled keys and
        pixel ids, a sample per lane) at `bounce`."""
        n, m, dev = self.pixel.shape[0], self.samples, self.pixel.device
        samples = (torch.arange(m, dtype=torch.int32, device=dev) + self.s0).repeat_interleave(n)

        def tile(w):
            return w if w.dim() == 0 else w.repeat(m)

        return KtfSampler(tile(self.k0), tile(self.k1), self.pixel.repeat(m), samples,
                          torch.tensor(bounce, dtype=torch.int32, device=dev), kernel=kernel)


def camera_draws_plain(trace: TraceDraws, kernel: bool = False) -> dict:
    """Plain version of the ktf camera draw kernel: KtfSampler's chain
    (K2 for each draw with kernel=True, the route before the kernel)."""
    smp = trace.sampler(0, kernel)
    ju, jv = smp.jitter_uv()
    lx, ly = smp.lens_disk()
    return dict(jitter_u=ju, jitter_v=jv, lens_x=lx, lens_y=ly)


def bounce_draws_plain(trace: TraceDraws, bounce: int, rr: bool, kernel: bool = False) -> dict:
    """Plain version of the ktf bounce draw kernel (KtfSampler's chain)."""
    smp = trace.sampler(bounce, kernel)
    out = dict(scatter=smp.scatter_unit_vector(), dielectric=smp.dielectric_uniform())
    if rr:
        out["rr"] = smp.rr_uniform()
    return out


def _lanes(n: int, samples: int) -> int:
    total = n * samples
    if total >= 2 ** 31:
        raise ValueError(f"{total} lanes: the draw kernels index them with int32")
    return total


def camera_outputs(total: int, dev):
    """The camera draw kernels' output: rows jitter u, jitter v, lens x,
    lens y of f32[total] each, and their dict."""
    out = torch.empty((4, total), dtype=torch.float32, device=dev)
    return out, dict(jitter_u=out[0], jitter_v=out[1], lens_x=out[2], lens_y=out[3])


def bounce_outputs(total: int, rr: bool, dev):
    """The bounce draw kernels' output: rows roulette and dielectric of
    f32[total] each, then the unit vectors f32[total, 3], and their dict."""
    out = torch.empty((5 * total,), dtype=torch.float32, device=dev)
    d = dict(dielectric=out[total:2 * total], scatter=out[2 * total:].view(total, 3))
    if rr:
        d["rr"] = out[:total]
    return out, d


def _trace_args(trace: TraceDraws):
    from raytracer_tpu_torch.utils import cudalib

    n = trace.pixel.shape[0]
    cudalib.require_cuda("pixel", trace.pixel, torch.int32, (n,))
    step = 0 if trace.k0.dim() == 0 else 1
    for name, k in (("k0", trace.k0), ("k1", trace.k1)):
        cudalib.require_cuda(name, k, torch.int32, () if step == 0 else (n,))
    return (trace.k0.data_ptr(), trace.k1.data_ptr(), step, trace.pixel.data_ptr(), n,
            _lanes(n, trace.samples), int(trace.s0))


def camera_draws(trace: TraceDraws) -> dict:
    """The ktf family's camera draws of a trace: one launch of the camera
    draw kernel (csrc/ktf.cu) on CUDA tensors, the plain version on CPU
    tensors."""
    if trace.pixel.device.type == "cpu":
        return camera_draws_plain(trace)
    from raytracer_tpu_torch.utils import cudalib

    args = _trace_args(trace)
    out, d = camera_outputs(args[5], trace.pixel.device)
    cudalib.check(cudalib.lib().rt_draws_camera_ktf(*args, out.data_ptr(),
                                                    cudalib.stream_handle()),
                  "camera draw kernel (ktf)")
    LAUNCHES.count("camera_draws")
    return d


def bounce_draws(trace: TraceDraws, bounce: int, rr: bool) -> dict:
    """The ktf family's draws of one bounce of a trace (the roulette draw
    only when `rr`): one launch of the bounce draw kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if trace.pixel.device.type == "cpu":
        return bounce_draws_plain(trace, bounce, rr)
    from raytracer_tpu_torch.utils import cudalib

    args = _trace_args(trace)
    out, d = bounce_outputs(args[5], rr, trace.pixel.device)
    cudalib.check(cudalib.lib().rt_draws_bounce_ktf(*args, int(bounce), int(bool(rr)),
                                                    out.data_ptr(), cudalib.stream_handle()),
                  "bounce draw kernel (ktf)")
    LAUNCHES.count("bounce_draws")
    return d
