"""Render configuration (port of raytracer_tpu/config.py, unchanged).

The reference hardcodes all of these as compile-time constants:
resolution/FOV/aperture (EntryPoint.cu:16-20), spp modes
(Core/Camera.cuh:11,64), bounce limits + Russian roulette
(CUDAKernels.h:106-108). Here they live in one frozen dataclass;
`PRESETS` mirrors the five BASELINE.json milestone configs. Fields
that only the JAX integrators read (drain_cascade, sort_rays, the
edge-aware options, rng_impl) are kept so that one config means the
same thing to both packages; the port's fused path always draws from
the ktf counter RNG.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 2560
    height: int = 1440
    spp: int = 2000                # HQ mode, Core/Camera.cuh:64
    max_bounces: int = 20          # CUDAKernels.h:106
    min_bounces: int = 3           # RR start, CUDAKernels.h:107
    rr_max_prob: float = 0.95      # CUDAKernels.h:108
    t_min: float = 0.001           # CUDAKernels.h:123
    fov_degrees: float = 80.0      # EntryPoint.cu:19
    aperture: float = 1e-6         # EntryPoint.cu:20
    # Parity quirk toggle: the reference returns emitted light
    # *unattenuated* by path throughput (CUDAKernels.h:133-134).
    # True reproduces that; False applies physically-correct attenuation.
    reference_emission_quirk: bool = True
    # Rays processed per device invocation; images bigger than this are
    # rendered in chunks to bound live wavefront memory (SURVEY.md §7).
    max_rays_per_pass: int = 1 << 20
    # spp per inner accumulation pass (bounds peak memory for huge spp).
    spp_per_pass: int = 64
    # Drain-tail compaction cascade for the wavefront integrator: once
    # the pending-lane count falls below n/div, the survivors are packed
    # (one nonzero+gather, outside the hot loop) into an n/div-sized
    # buffer and the bounce loop continues there. Kills the late-frame
    # iterations where <10% of lanes are live but every sweep still
    # paid full-size camera/RNG/traversal cost (~50 ms/iteration at 2K).
    # Bit-exact: RNG is (pixel,sample,bounce)-keyed and per-lane fp
    # accumulation order is preserved (tests/test_wavefront.py).
    # () disables compaction (the round-1 lane-stable behavior). Stage
    # overhead is ~18 gather/scatter thunks (~10 ms at 2K) vs ~50 ms per
    # saved full-size iteration, so the cascade starts early (n/2).
    drain_cascade: tuple = (2, 8, 32, 128)
    # Re-sort the live wavefront by (direction octant, origin Morton
    # cell) before each bounce's traversal. MEASURED HARMFUL with the
    # sub-warp kernel + two-level split (the argsort/permute gathers
    # cost more than the saved traversal: 2K frame 3.7s -> 11.6s with
    # sorting on); kept as an option for denser scenes. Only affects
    # the fused Pallas path; results identical modulo closest-hit ties.
    sort_rays: bool = False
    # Edge-aware / reparameterized visibility for inverse rendering
    # (BASELINE north star; diff path only): adds a VALUE-ZERO
    # smoothed-boundary light-visibility term (control variate:
    # soft - stop_grad(soft)) to the megakernel integrator, so
    # parameters that move ray DIRECTIONS (metal roughness, dielectric
    # IOR, camera) get nonzero gradients through the light-hit
    # discontinuity that the detached traversal otherwise kills. The
    # forward image is bit-identical with the flag on or off
    # (tests/test_grad.py).
    edge_aware_lights: bool = False
    # Relative sigmoid bandwidth of the smoothed light boundary, as a
    # fraction of the light's half-extent.
    edge_bandwidth: float = 0.15
    # RNG implementation: "jax" (jax.random fold chains — the default
    # and historical oracle) or "ktf" (utils/ktf.py counter-based
    # Threefry-2x32 on plain int32 ops — the SAME function the fused
    # Pallas megakernel runs in-kernel, so fused ≡ wavefront ≡
    # megakernel equality holds bit-for-bit within the ktf family;
    # across families agreement is statistical only).
    rng_impl: str = "jax"

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# The five milestone configurations from BASELINE.json.
PRESETS = {
    # (1) Cornell with analytic spheres only — CPU-runnable golden config.
    "cornell_spheres_256": RenderConfig(width=256, height=256, spp=16, max_bounces=4),
    # (2) Cornell triangles + all four material types.
    "cornell_materials_512": RenderConfig(width=512, height=512, spp=64, max_bounces=8),
    # (3) bunny mesh with LBVH at 1080p.
    "bunny_1080p": RenderConfig(width=1920, height=1080, spp=256, max_bounces=20),
    # (4) inverse-rendering config (small for optimization loops).
    "inverse_render": RenderConfig(width=128, height=128, spp=32, max_bounces=6),
    # (5) the full reference workload (README.md:11 "high quality" mode).
    "reference_2k": RenderConfig(width=2560, height=1440, spp=2000, max_bounces=20),
}
