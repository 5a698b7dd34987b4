"""Threefry-2x32 (20 rounds) keyed by (pixel, sample, bounce, purpose):
the counter-based draws the system under test specifies for its ktf
family, written again from the Threefry specification (Salmon et al.,
SC'11) on int64 tensors that hold uint32 values.

Counter words: c0 = pixel id, c1 = (sample << 9) | (bounce << 4) |
purpose. A uniform is f32(x >> 9) * 2^-23. Key words (k0, k1) of an
integer seed are (0, seed mod 2^32).
"""

from __future__ import annotations

import math

import torch

JITTER, LENS, RR, SCATTER, DIELECTRIC = 1, 2, 3, 4, 5
M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
TWO_PI = 2.0 * math.pi


def key_words(seed: int) -> tuple[int, int]:
    return 0, int(seed) & M32


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & M32


def threefry(k0, k1, c0, c1):
    """(x0, x1), int64 tensors in [0, 2^32): Threefry-2x32-20 of counters
    (c0, c1) under key (k0, k1); keys and counters broadcast."""
    c0 = _u32(c0)
    dev = c0.device
    k0, k1, c1 = _u32(k0).to(dev), _u32(k1).to(dev), _u32(c1).to(dev)
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for group in range(5):
        for r in _ROT[group % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        i = group + 1
        x0 = (x0 + ks[i % 3]) & M32
        x1 = (x1 + ks[(i + 1) % 3] + i) & M32
    return x0, x1


def uniform_bits(x: torch.Tensor) -> torch.Tensor:
    return (x >> 9).to(torch.float32) * (2.0 ** -23)


class Draws:
    """Draws of lanes with pixel ids `pixel` at `sample` and `bounce`
    (tensors or ints that broadcast), under key words (k0, k1), which are
    ints or per-lane tensors."""

    def __init__(self, k0, k1, pixel, sample, bounce):
        self.k0, self.k1, self.pixel = k0, k1, pixel
        self.c1base = (_u32(sample).to(pixel.device) << 9) | (_u32(bounce).to(pixel.device) << 4)

    def pair(self, purpose: int):
        a, b = threefry(self.k0, self.k1, self.pixel, self.c1base | purpose)
        return uniform_bits(a), uniform_bits(b)

    def uniform(self, purpose: int):
        return self.pair(purpose)[0]

    def unit_vector(self, purpose: int):
        """Uniform direction: z = 1 - 2 u1, phi = 2 pi u2."""
        u1, u2 = self.pair(purpose)
        z = 1.0 - 2.0 * u1
        r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = TWO_PI * u2
        return r * torch.cos(phi), r * torch.sin(phi), z

    def disk(self, purpose: int):
        """Uniform point of the unit disk: r = sqrt(u1), theta = 2 pi u2."""
        u1, u2 = self.pair(purpose)
        r = torch.sqrt(u1)
        theta = TWO_PI * u2
        return r * torch.cos(theta), r * torch.sin(theta)
