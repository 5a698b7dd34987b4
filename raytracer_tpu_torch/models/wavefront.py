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
selects would leave the state as it is). While a profiler records, the
spans `rt.wavefront.stage`, `.read` and `.iteration` mark each drain
stage, each such read and each iteration; the counters `host_reads` and
`wavefront.iterations` count the reads and the iterations
(utils/profiling).

The drain cascade (cfg.drain_cascade) packs the pending lanes into
smaller buffers once per stage (torch.nonzero and a gather) and
scatters them back when the stage ends. The result is bit for bit the
uncompacted one: a lane's draws depend on (pixel, sample, bounce) only,
its accumulator rides along as a running total, and K4 and every
elementwise operation work per lane. A stage's cap is only a threshold
on the pending count (nonzero gathers exactly the pending lanes), so it
is n // div with no rounding and no floor: the JAX module's 1024-lane
packets and PACKET_MIN_RAYS were the TPU kernel's shape.

`render_pixels_wavefront_rebalanced` is the sharded form with the
cross-shard drain rebalance: each shard drains its own lanes to a fixed
number pending, the pending lanes of every shard are pooled, each shard
drains a stripe of the pool to the end, and the finished accumulators go
back to their owners. Its three stages are functions here; the two
gathers between them are the caller's (parallel/sharding.py: host
concatenation in one process, torch.distributed across processes).

Forward-only; runs under torch.no_grad().
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.camera import generate_rays
from raytracer_tpu_torch.ops import intersect as isect
from raytracer_tpu_torch.ops import materials as mat_ops
from raytracer_tpu_torch.ops import tonemap
from raytracer_tpu_torch.render import as_key, mean_over_passes
from raytracer_tpu_torch.schedule import _tiled_pixel_grid
from raytracer_tpu_torch.utils import ktf, profiling
from raytracer_tpu_torch.utils import rng as rngu
from raytracer_tpu_torch.utils.cudalib import device_scope
from raytracer_tpu_torch.utils.profiling import span


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


def _drain(body, state, spp: int, limit: int):
    """Run `body` until at most `limit` lanes are pending (active, or
    holding a sample to start). One device-to-host read per iteration
    fetches the pending count and the count of lanes that may claim.
    Returns (state, the iterations run)."""
    iters = 0
    while True:
        budget = state["sample"] < spp
        pend = state["active"] | budget
        claim = budget & ~state["active"]
        with span("rt.wavefront.read"):
            n_pend, n_claim = torch.stack([pend.sum(), claim.sum()]).tolist()
            profiling.count("host_reads")
        if n_pend <= limit:
            break
        with span("rt.wavefront.iteration"):
            state = body(state, n_claim > 0)
        profiling.count("wavefront.iterations")
        iters += 1
    return state, iters


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


def _new_state(n: int, dev) -> dict:
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "origins": torch.zeros((n, 3), **f32),
        "dirs": torch.ones((n, 3), **f32),
        "throughput": torch.ones((n, 3), **f32),
        "bounce": torch.zeros((n,), dtype=torch.int32, device=dev),
        "sample": torch.zeros((n,), dtype=torch.int32, device=dev),
        "active": torch.zeros((n,), dtype=torch.bool, device=dev),
        "acc": torch.zeros((n, 3), **f32),
    }


def _pending(state, spp: int) -> torch.Tensor:
    return state["active"] | (state["sample"] < spp)


def _pending_lanes(state, spp: int) -> torch.Tensor:
    """Indices of the pending lanes (nonzero reads its count: a host read)."""
    idx = torch.nonzero(_pending(state, spp)).squeeze(1)
    profiling.count("host_reads")
    return idx


def _cascade(make_body, state, px, py, pkeys, spp: int, caps: list, last: int):
    """Drain `state` (the lanes px, py) through the cascade stages `caps`
    (pending-lane thresholds, decreasing), then down to `last` pending.
    Each stage is a span `rt.wavefront.stage`."""
    with span("rt.wavefront.stage"):
        state, _ = _drain(make_body(px, py, pkeys), state, spp, caps[0] if caps else last)
    for i in range(len(caps)):
        nxt = caps[i + 1] if i + 1 < len(caps) else last
        with span("rt.wavefront.stage"):
            # At most caps[i] lanes are pending here; nonzero's indices are
            # unique, so the scatter back writes each lane once.
            idx = _pending_lanes(state, spp)
            cstate = {k: v[idx] for k, v in state.items()}
            cbody = make_body(px[idx], py[idx], _take(pkeys, idx))
            cstate, _ = _drain(cbody, cstate, spp, nxt)
            for k in state:
                state[k][idx] = cstate[k]
    return state


@torch.no_grad()
def render_pixels_wavefront(scene, cam, px, py, cfg, key, spp: int | None = None,
                            sample_offset: int = 0) -> torch.Tensor:
    """Mean linear radiance f32[N,3] over spp samples of the pixels
    (px, py) (i32[N], py = 0 the bottom row), on their device.
    `sample_offset` shifts the global sample indices, so spp-batched
    calls draw the same numbers as one pass."""
    spp = cfg.spp if spp is None else int(spp)
    n = px.shape[0]
    make_body = _wavefront_body_maker(scene, cam, cfg, spp, int(sample_offset),
                                      isect.fused_trace_available(scene))
    state = _cascade(make_body, _new_state(n, px.device), px, py, _lane_pkeys(cfg, key, px, py),
                     spp, cascade_caps(n, cfg.drain_cascade), 0)
    return state["acc"] / float(spp)


# A lane in a rebalance bundle: int32 columns, the float fields as their
# bits. Fill rows (a bundle holds fewer pending lanes than its cap) have
# origin -1 and sample = spp, so the drain leaves them as they are.
_F32_FIELDS = (("origins", 3), ("dirs", 3), ("throughput", 3), ("acc", 3))
_I32_FIELDS = ("bounce", "sample", "active", "px", "py", "origin")
BUNDLE_COLS = 3 * len(_F32_FIELDS) + len(_I32_FIELDS)


def rebalance_cap(n: int, rebalance_div: int) -> int:
    """Pending lanes of n that a shard hands to the pool, and the size
    of its bundle: n // rebalance_div, at least 1 and at most n. Like a
    cascade cap it is a threshold on the pending count and is not
    rounded to packets; the JAX module rounds it up to 1024 (or 8)
    lanes with a floor of PACKET_MIN_RAYS, which changes when the pool
    forms and so the per-shard iteration counts, never the image."""
    return min(max(n // int(rebalance_div), 1), n)


def _pack(state, px, py, origin) -> torch.Tensor:
    cols = [state[k].view(torch.int32) for k, _ in _F32_FIELDS]
    cols += [state["bounce"][:, None], state["sample"][:, None],
             state["active"].to(torch.int32)[:, None], px[:, None], py[:, None], origin[:, None]]
    return torch.cat(cols, dim=1)


def _unpack(rows):
    state, c = {}, 0
    for k, w in _F32_FIELDS:
        state[k] = rows[:, c:c + w].contiguous().view(torch.float32)
        c += w
    i32 = {k: rows[:, c + j].contiguous() for j, k in enumerate(_I32_FIELDS)}
    state.update(bounce=i32["bounce"], sample=i32["sample"], active=i32["active"] != 0)
    return state, i32["px"], i32["py"], i32["origin"]


def rebalance_local(scene, cam, px, py, cfg, key, spp: int, sample_offset: int, cap: int,
                    shard: int):
    """Stage 1 of the rebalance on one shard's n lanes (px, py): the
    wavefront down to `cap` pending lanes, through the cascade stages
    above `cap`. Returns (state, bundle): bundle is int32[cap,
    BUNDLE_COLS], the pending lanes first (origin = shard·n + lane),
    then fill rows."""
    n, dev = px.shape[0], px.device
    make_body = _wavefront_body_maker(scene, cam, cfg, spp, sample_offset,
                                      isect.fused_trace_available(scene))
    caps = [c for c in cascade_caps(n, cfg.drain_cascade) if c > cap]
    state = _cascade(make_body, _new_state(n, dev), px, py, _lane_pkeys(cfg, key, px, py), spp,
                     caps, cap)
    idx = _pending_lanes(state, spp)
    fill = _new_state(cap, dev)
    fill["sample"].fill_(spp)
    zeros = torch.zeros((cap,), dtype=torch.int32, device=dev)
    bundle = _pack(fill, zeros, zeros, torch.full((cap,), -1, dtype=torch.int32, device=dev))
    k = idx.shape[0]
    bundle[:k] = _pack({f: v[idx] for f, v in state.items()}, px[idx], py[idx],
                       (shard * n + idx).to(torch.int32))
    return state, bundle


def rebalance_stripe(scene, cam, pooled, shard: int, n_shards: int, cfg, key, spp: int,
                     sample_offset: int):
    """Stage 2 on one shard: from the pool (every shard's bundle in shard
    order, int32[S·cap, BUNDLE_COLS]) take the stripe shard + S·i and
    drain it to the end, the draws rebuilt from each lane's pixel.
    Returns (int32[cap, 4]: origin and the accumulator's bits, the
    drain's iterations)."""
    cap = pooled.shape[0] // n_shards
    take = shard + n_shards * torch.arange(cap, device=pooled.device)
    state, spx, spy, origin = _unpack(pooled[take])
    make_body = _wavefront_body_maker(scene, cam, cfg, spp, sample_offset,
                                      isect.fused_trace_available(scene))
    with span("rt.wavefront.stage"):
        state, iters = _drain(make_body(spx, spy, _lane_pkeys(cfg, key, spx, spy)), state, spp,
                              0)
    return torch.cat([origin[:, None], state["acc"].view(torch.int32)], dim=1), iters


def rebalance_return(state, results, shard: int, spp: int) -> torch.Tensor:
    """Stage 3 on one shard: the finished accumulators of every stripe
    (int32[S·cap, 4] in shard order) written back to this shard's lanes
    (origin in [shard·n, (shard+1)·n); the others and the fill rows are
    masked out). Returns the shard's mean radiance f32[n,3]."""
    n = state["acc"].shape[0]
    origin = results[:, 0]
    mine = (origin >= shard * n) & (origin < (shard + 1) * n)
    acc = results[:, 1:].contiguous().view(torch.float32)
    state["acc"][(origin[mine] - shard * n).long()] = acc[mine]
    return state["acc"] / float(spp)


@torch.no_grad()
def render_pixels_wavefront_rebalanced(lanes: dict, cfg, key, all_gather, n_shards: int,
                                       spp: int | None = None, sample_offset: int = 0,
                                       rebalance_div: int = 8):
    """The wavefront over S = n_shards shards of n lanes each with the
    cross-shard drain rebalance (JAX models/wavefront.py:260). `lanes`
    maps each shard this process renders to (scene, cam, px, py) on its
    device: every shard of an in-process mesh, one rank's own under a
    process group. `all_gather({shard: int32[m, c]})` returns {shard:
    int32[S·m, c]}, every shard's rows in shard order on that shard's
    device (each stage runs with that card current). Once a shard's
    pending count falls to rebalance_cap(n,
    rebalance_div), the pending lanes are pooled and each shard drains
    the stripe shard + S·i, so the shards finish together. Draws depend
    only on (pixel, sample, bounce) and the accumulator migrates as a
    running total, so every lane is bit for bit the unsharded one.
    Returns ({shard: f32[n,3]}, {shard: post-rebalance iterations})."""
    spp = cfg.spp if spp is None else int(spp)
    n = next(iter(lanes.values()))[2].shape[0]
    cap = rebalance_cap(n, rebalance_div)
    local, bundles = {}, {}
    for s, (scene, cam, px, py) in lanes.items():
        with device_scope(px.device):
            local[s], bundles[s] = rebalance_local(scene, cam, px, py, cfg, key, spp,
                                                   sample_offset, cap, s)
    pooled = all_gather(bundles)
    results, iters = {}, {}
    for s, (scene, cam, px, _) in lanes.items():
        with device_scope(px.device):
            results[s], iters[s] = rebalance_stripe(scene, cam, pooled[s], s, n_shards, cfg, key,
                                                    spp, sample_offset)
    back = all_gather(results)
    return {s: rebalance_return(local[s], back[s], s, spp) for s in lanes}, iters


@torch.no_grad()
def render_image_wavefront(scene, cam, cfg, key, spp: int | None = None) -> torch.Tensor:
    """Full-image wavefront render → linear f32[H,W,3] on the scene's
    device, lanes in 8x128 screen tiles. spp above cfg.spp_per_pass is
    split into passes keyed by sample offset, each weighted s / spp.
    One request: the root span `rt.wavefront.render`."""
    with span("rt.wavefront.render", root=True):
        dev = scene.materials.type.device
        with span("rt.wavefront.grid"):
            px, py, inv = (t.to(dev) for t in _tiled_pixel_grid(cfg))
        spp = cfg.spp if spp is None else int(spp)
        rgb = mean_over_passes(cfg, spp, lambda s, done: render_pixels_wavefront(
            scene, cam, px, py, cfg, key, spp=s, sample_offset=done))
        return rgb[inv].reshape(cfg.height, cfg.width, 3)
