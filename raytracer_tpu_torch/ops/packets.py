"""Coherence sort keys for the traversal kernel's sort path (port of
`_coherence_keys` in raytracer_tpu/ops/packets.py, with `morton3d` of
raytracer_tpu/ops/bvh.py).

The key of a ray is its 3-bit direction octant above 29 bits of its
origin's Morton code, so bounce rays from nearby points in similar
directions sort next to each other. The JAX package computes it in
uint32; here it is int64, because `octant << 29` overflows int32. The
values are the same, so a stable argsort gives the same permutation.
`coherence_keys32` is the same key with its top bit flipped, as int32: a
signed sort orders it as the unsigned key, and a radix sort of 32 bits
takes half the passes of one of 64. It is the plain version of K4-sort's
key kernel (csrc/trace_closest.cu).
"""

from __future__ import annotations

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (standard Morton magic)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(points01: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) for points f32[N,3] in [0,1]^3."""
    q = torch.clamp(points01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) | _expand_bits(q[:, 2])


def coherence_keys(origins, dirs, scene_lo, scene_inv_extent) -> torch.Tensor:
    """int64 sort key per ray: direction octant << 29 | Morton(origin) >> 1."""
    neg = (dirs < 0).to(torch.int64)
    octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)
    o01 = torch.clamp((origins - scene_lo) * scene_inv_extent, 0.0, 1.0)
    return (octant << 29) | (morton3d(o01) >> 1)


def coherence_keys32(origins, dirs, scene_lo, scene_inv_extent) -> torch.Tensor:
    """int32 sort key per ray: coherence_keys ^ 2^31, wrapped to int32.
    Its stable argsort is coherence_keys' (and the JAX package's)."""
    return (coherence_keys(origins, dirs, scene_lo, scene_inv_extent) ^ 0x80000000).to(
        torch.int32)


def root_box(bvh4):
    """(lo, 1/extent) of the tree's root children, as the JAX sort path
    computes them (empty slots excluded from the upper corner)."""
    b = bvh4.bounds[0]
    lo = torch.min(b[:, 0:3], dim=0).values
    big = 3.0e38
    hi = torch.max(torch.where(b[:, 3:6] > -big, b[:, 3:6], torch.full_like(b[:, 3:6], -big)),
                   dim=0).values
    return lo, 1.0 / torch.clamp_min(hi - lo, 1e-12)
