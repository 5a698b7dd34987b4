"""Wavefront path tracer with lane-stable path regeneration (port of
raytracer_tpu/models/wavefront.py): the JAX package's default
integrator.

Every lane owns one pixel and a sample budget. Each iteration advances
every live lane by one bounce, and a lane whose path ended starts its
pixel's next sample in the same iteration, so a frame takes about the
mean path length × spp iterations plus a drain tail. Per iteration the
work on the card is the draws (kernel K2's Threefry blocks, with the
sample and bounce per lane), one closest-hit call through
ops/intersect.trace_frame_fused (kernel K4, K1 inline) and elementwise
PyTorch.

The JAX module's `lax.while_loop` conditions and its raygen
`lax.cond` are host decisions here: before each iteration one
device-to-host read fetches the pending count and the count of lanes
that may claim a sample; raygen is skipped when none may (the claim
selects would leave the state as it is).

The drain cascade (cfg.drain_cascade) packs the pending lanes into
smaller buffers once per stage (torch.nonzero and a gather) and
scatters them back when the stage ends. The result is bit for bit the
uncompacted one: a lane's draws depend on (pixel, sample, bounce) only,
its accumulator rides along as a running total, and K4 and every
elementwise operation work per lane. A stage's cap is only a threshold
on the pending count (nonzero gathers exactly the pending lanes), so it
is n // div with no rounding and no floor: the JAX module's 1024-lane
packets and PACKET_MIN_RAYS were the TPU kernel's shape.

Forward-only; runs under torch.no_grad(). The cross-shard rebalanced
drain (`render_pixels_wavefront_rebalanced`) is not ported (ROADMAP
M12).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.camera import generate_rays
from raytracer_tpu_torch.ops import intersect as isect
from raytracer_tpu_torch.ops import materials as mat_ops
from raytracer_tpu_torch.ops import tonemap
from raytracer_tpu_torch.render import as_key
from raytracer_tpu_torch.schedule import _tiled_pixel_grid
from raytracer_tpu_torch.utils import ktf
from raytracer_tpu_torch.utils import rng as rngu


def _lane_pkeys(cfg, key, px, py):
    """Per-lane pixel-keyed RNG base, a function of (key, pixel id): a
    ktf sampler, or the jax family's lane keys (one K2 launch)."""
    ids = py * cfg.width + px
    if cfg.rng_impl == "ktf":
        return ktf.sampler(key, ids)
    return rngu.lane_keys(as_key(key, px.device), ids)


def _take(pkeys, idx):
    """The lane subset `idx` of _lane_pkeys' result."""
    if isinstance(pkeys, ktf.KtfSampler):
        return ktf.KtfSampler(pkeys.k0, pkeys.k1, pkeys.pixel[idx], pkeys.sample,
                              pkeys.bounce, pkeys.kernel)
    return pkeys[0][idx], pkeys[1][idx]


def _wavefront_body_maker(scene, cam, cfg, spp: int, sample_offset: int, use_fused: bool):
    """make_body(px, py, pkeys) → body(state, claim_any): one bounce of
    every lane of `state`; `claim_any` says whether some lane may start
    a sample (raygen runs only then)."""
    use_ktf = cfg.rng_impl == "ktf"

    def make_body(px, py, pkeys):
        def body(state, claim_any: bool):
            active = state["active"]
            sample = state["sample"]
            bounce = torch.where(active, state["bounce"], 0)

            # Regeneration: idle lanes with budget start their next sample.
            claim = ~active & (sample < spp)
            if use_ktf:
                skeys = pkeys.at(sample=sample + sample_offset, bounce=0)
                kb = skeys.at(bounce=bounce)
            else:
                skeys = rngu.fold(pkeys, sample + sample_offset)
                kb = rngu.fold(skeys, bounce)
            origins, dirs, throughput = state["origins"], state["dirs"], state["throughput"]
            if claim_any:
                o_new, d_new = generate_rays(cam, px, py, cfg.width, cfg.height, skeys)
                cl3 = claim[:, None]
                origins = torch.where(cl3, o_new, origins)
                dirs = torch.where(cl3, d_new, dirs)
                throughput = torch.where(cl3, 1.0, throughput)
                active = active | claim

            # Russian roulette (CUDAKernels.h:113-121), per-lane bounce.
            do_rr = bounce >= cfg.min_bounces
            survival = torch.clamp_max(torch.amax(throughput, dim=-1), cfg.rr_max_prob)
            u_rr = rngu.as_sampler(kb).rr_uniform()
            rr_kill = active & do_rr & (u_rr > survival)
            survived_rr = active & ~rr_kill
            rr_scale = torch.where(survived_rr & do_rr, 1.0 / torch.clamp_min(survival, 1e-12),
                                   1.0)
            throughput = throughput * rr_scale[:, None]

            # One bounce for the whole buffer. Lanes that roulette killed or
            # that hold no sample trace with the limit -1 (dead rays in K4).
            if use_fused:
                fh = isect.trace_frame_fused(scene, origins, dirs, cfg.t_min,
                                             sort=cfg.sort_rays, active=survived_rr)
                ray_hit, point = fh.hit, fh.point
                sc = mat_ops.scatter_params(kb, dirs, fh.normal, fh.front_face, fh.params)
            else:
                ids = isect.intersect_scene(scene, origins, dirs, cfg.t_min)
                attrs = isect.shade_hit(scene, origins, dirs, ids)
                ray_hit, point = ids.hit, attrs.point
                sc = mat_ops.scatter(kb, dirs, attrs.normal, attrs.front_face, attrs.mat_id,
                                     scene.materials)

            hit = ray_hit & survived_rr
            light_hit = hit & sc.is_light
            miss = survived_rr & ~ray_hit
            cont = hit & sc.scattered & (bounce + 1 < cfg.max_bounces)

            emitted = sc.emission if cfg.reference_emission_quirk else throughput * sc.emission
            contrib = torch.where(light_hit[:, None], emitted, 0.0)
            contrib = torch.where(miss[:, None], throughput * tonemap.sky_color(dirs), contrib)
            # Terminations (roulette, absorption, the bounce cap) add black.
            terminated = active & ~cont
            acc = state["acc"] + torch.where(terminated[:, None], contrib, 0.0)
            sample = torch.where(terminated, sample + 1, sample)

            c3 = cont[:, None]
            return {
                "origins": torch.where(c3, point, origins),
                "dirs": torch.where(c3, sc.direction, dirs),
                "throughput": torch.where(c3, throughput * sc.attenuation, throughput),
                "bounce": torch.where(cont, bounce + 1, bounce),
                "sample": sample,
                "active": cont,
                "acc": acc,
            }

        return body

    return make_body


def _drain(body, state, spp: int, limit: int, stats: dict | None):
    """Run `body` until at most `limit` lanes are pending (active, or
    holding a sample to start). One device-to-host read per iteration
    fetches the pending count and the count of lanes that may claim."""
    iters = 0
    while True:
        budget = state["sample"] < spp
        pend = state["active"] | budget
        claim = budget & ~state["active"]
        n_pend, n_claim = torch.stack([pend.sum(), claim.sum()]).tolist()
        if stats is not None:
            stats["host_reads"] += 1
        if n_pend <= limit:
            break
        state = body(state, n_claim > 0)
        iters += 1
    if stats is not None:
        stats["stage_iterations"].append(iters)
    return state


def cascade_caps(n: int, drain_cascade) -> list:
    """The stages' pending-lane thresholds for n lanes: n // div (at
    least 1) for each divisor, kept when smaller than n and the previous
    cap."""
    caps = []
    for div in drain_cascade:
        c = max(n // int(div), 1)
        if c < n and (not caps or c < caps[-1]):
            caps.append(c)
    return caps


def new_stats() -> dict:
    """A record for render_pixels_wavefront(stats=): iterations per
    cascade stage (the full buffer first) and device-to-host reads."""
    return {"stage_iterations": [], "host_reads": 0}


@torch.no_grad()
def render_pixels_wavefront(scene, cam, px, py, cfg, key, spp: int | None = None,
                            sample_offset: int = 0, stats: dict | None = None) -> torch.Tensor:
    """Mean linear radiance f32[N,3] over spp samples of the pixels
    (px, py) (i32[N], py = 0 the bottom row), on their device.
    `sample_offset` shifts the global sample indices, so spp-batched
    calls draw the same numbers as one pass. `stats` (new_stats())
    gathers the iterations per stage and the host reads."""
    spp = cfg.spp if spp is None else int(spp)
    sample_offset = int(sample_offset)
    n, dev = px.shape[0], px.device
    pkeys = _lane_pkeys(cfg, key, px, py)
    use_fused = isect.fused_trace_available(scene)
    make_body = _wavefront_body_maker(scene, cam, cfg, spp, sample_offset, use_fused)

    f32 = dict(dtype=torch.float32, device=dev)
    state = {
        "origins": torch.zeros((n, 3), **f32),
        "dirs": torch.ones((n, 3), **f32),
        "throughput": torch.ones((n, 3), **f32),
        "bounce": torch.zeros((n,), dtype=torch.int32, device=dev),
        "sample": torch.zeros((n,), dtype=torch.int32, device=dev),
        "active": torch.zeros((n,), dtype=torch.bool, device=dev),
        "acc": torch.zeros((n, 3), **f32),
    }
    caps = cascade_caps(n, cfg.drain_cascade)
    state = _drain(make_body(px, py, pkeys), state, spp, caps[0] if caps else 0, stats)
    for i in range(len(caps)):
        nxt = caps[i + 1] if i + 1 < len(caps) else 0
        # At most caps[i] lanes are pending here; nonzero's indices are
        # unique, so the scatter back writes each lane once.
        idx = torch.nonzero(state["active"] | (state["sample"] < spp)).squeeze(1)
        if stats is not None:
            stats["host_reads"] += 1   # nonzero reads its count
        cstate = {k: v[idx] for k, v in state.items()}
        cbody = make_body(px[idx], py[idx], _take(pkeys, idx))
        cstate = _drain(cbody, cstate, spp, nxt, stats)
        for k in state:
            state[k][idx] = cstate[k]
    return state["acc"] / float(spp)


@torch.no_grad()
def render_image_wavefront(scene, cam, cfg, key, spp: int | None = None,
                           stats: dict | None = None) -> torch.Tensor:
    """Full-image wavefront render → linear f32[H,W,3] on the scene's
    device, lanes in 8x128 screen tiles. spp above cfg.spp_per_pass is
    split into passes keyed by sample offset, each weighted s / spp."""
    dev = scene.materials.type.device
    px, py, inv = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    spp = cfg.spp if spp is None else int(spp)
    step = max(1, min(spp, cfg.spp_per_pass))
    if step >= spp:
        rgb = render_pixels_wavefront(scene, cam, px, py, cfg, key, spp=spp, stats=stats)
    else:
        rgb = None
        done = 0
        while done < spp:
            s = min(step, spp - done)
            part = render_pixels_wavefront(scene, cam, px, py, cfg, key, spp=s,
                                           sample_offset=done, stats=stats) * (s / spp)
            rgb = part if rgb is None else rgb + part
            done += s
    return rgb[inv].reshape(cfg.height, cfg.width, 3)
