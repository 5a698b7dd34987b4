"""The differentiable path tracer (port of raytracer_tpu/models/megakernel.py).

The whole wavefront advances one bounce per step with per-lane alive
masks, as the reference's per-thread `rayColor` loop does per pixel
(CUDAKernels.h:102-145). Each bounce: Russian roulette, the detached
closest-hit search (ops/intersect.intersect_scene: kernel K4 through its
coherence sort on the card), differentiable shading
(ops/intersect.shade_hit), scatter (ops/materials.scatter). Gradients
are torch autograd over those plain tensor ops; no kernel is
differentiated.

Reference semantics (SURVEY.md §6.2): Russian roulette from bounce 3 with
survival min(max RGB of the throughput, 0.95); emitters return emission
unattenuated when cfg.reference_emission_quirk; paths that exhaust
max_bounces contribute black; a miss adds throughput × sky.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from raytracer_tpu_torch.ops import intersect as isect
from raytracer_tpu_torch.ops import materials as mat_ops
from raytracer_tpu_torch.ops import tonemap
from raytracer_tpu_torch.utils import vecmath as vm

CHECKPOINT_ABOVE_BOUNCES = 8  # recompute each bounce in backward above this depth


def _edge_light_term(scene, cfg, origins, dirs, throughput, t_detached, alive):
    """Smoothed-boundary light-visibility gradient term (the BASELINE
    north star's edge-aware visibility).

    The detached traversal makes the light-hit indicator a step function
    of the ray direction, so parameters that only move directions (metal
    roughness, dielectric IOR, camera) get no gradient from light paths.
    This term is (soft - soft.detach()) * (throughput * E_light).detach(),
    with `soft` a sigmoid-smoothed indicator of the fitted light
    rectangle: EXACTLY 0.0 in the forward pass, with the derivative of
    the smoothed boundary, gated (detached) to live, non-grazing lanes
    whose nearest hit is not in front of the light plane."""
    rect = scene.light_rect
    center, n_pl = rect[0:3], rect[3:6]
    u_ax, v_ax = rect[6:9], rect[9:12]
    hu, hv = rect[12], rect[13]

    denom = vm.dot(dirs, n_pl, keepdims=False)
    bad = torch.abs(denom) < 1e-6
    denom_safe = torch.where(bad, torch.ones_like(denom), denom)
    t_pl = vm.dot(center - origins, n_pl, keepdims=False) / denom_safe
    p = origins + t_pl[:, None] * dirs
    du = vm.dot(p - center, u_ax, keepdims=False)
    dv = vm.dot(p - center, v_ax, keepdims=False)
    bw = cfg.edge_bandwidth * torch.minimum(hu, hv)
    soft = torch.sigmoid((hu - torch.abs(du)) / bw) * torch.sigmoid((hv - torch.abs(dv)) / bw)
    # Gate (a bool mask, so detached): live lane, non-grazing, plane in
    # front, and nothing strictly nearer than the plane (the tolerance
    # covers the light's own hit: t_hit == t_pl there).
    gate = alive & ~bad & (t_pl > cfg.t_min) & (t_pl <= t_detached * 1.02)
    soft = torch.where(gate, soft, torch.zeros_like(soft))
    # A one-element index: a 0-d one would read the row number back to the host.
    emission = scene.materials.emission[rect[14:15].long()][0].detach()
    weight = throughput.detach() * emission[None, :]
    return (soft - soft.detach())[:, None] * weight


def initial_state(origins, dirs) -> tuple:
    """(origins, dirs, throughput, radiance, alive, edge_acc) before bounce 0."""
    n, dev = origins.shape[0], origins.device
    return (
        origins,
        dirs,
        torch.ones((n, 3), dtype=torch.float32, device=dev),
        torch.zeros((n, 3), dtype=torch.float32, device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev),
        torch.zeros((n, 3), dtype=torch.float32, device=dev),  # edge-term accumulator (≡ 0.0)
    )


def bounce_step(scene, cfg, bounce: int, smp, state) -> tuple:
    """Advance every lane of `state` (initial_state's layout) by one
    bounce, with the draws of sampler `smp`."""
    origins, dirs, throughput, radiance, alive, edge_acc = state

    # Russian roulette (CUDAKernels.h:113-121). amax splits the gradient
    # between tied channels, as JAX's max does.
    if bounce >= cfg.min_bounces:
        survival = torch.clamp_max(torch.amax(throughput, dim=-1), cfg.rr_max_prob)
        alive = alive & ~(smp.rr_uniform() > survival)
        rr_scale = torch.where(alive, 1.0 / torch.clamp_min(survival, 1e-12),
                               torch.ones_like(survival))
        throughput = throughput * rr_scale[:, None]

    ids = isect.intersect_scene(scene, origins, dirs, cfg.t_min)
    if cfg.edge_aware_lights and scene.light_rect is not None:
        # Value-zero smoothed-visibility gradient term for this segment
        # (post-RR throughput — what a light hit would see).
        edge_acc = edge_acc + _edge_light_term(scene, cfg, origins, dirs, throughput,
                                               ids.t, alive)
    attrs = isect.shade_hit(scene, origins, dirs, ids)
    sc = mat_ops.scatter(smp, dirs, attrs.normal, attrs.front_face, attrs.mat_id,
                         scene.materials)

    hit = ids.hit & alive
    light_hit = hit & sc.is_light
    emitted = sc.emission if cfg.reference_emission_quirk else throughput * sc.emission
    radiance = torch.where(light_hit[:, None], emitted, radiance)

    miss = alive & ~ids.hit
    radiance = torch.where(miss[:, None], throughput * tonemap.sky_color(dirs), radiance)

    cont = (hit & sc.scattered)[:, None]
    throughput = torch.where(cont, throughput * sc.attenuation, throughput)
    origins = torch.where(cont, attrs.point, origins)
    dirs = torch.where(cont, sc.direction, dirs)
    return origins, dirs, throughput, radiance, cont[:, 0], edge_acc


def trace_paths(scene, origins, dirs, draws, cfg):
    """Path-traced radiance f32[N,3] for one sample per ray. `draws` are
    the trace's draws (utils/rng.TraceDraws or utils/ktf.TraceDraws):
    each bounce takes its site `draws.bounce(b, rr)`, one draw kernel on
    the card. Above CHECKPOINT_ABOVE_BOUNCES bounces, each bounce is
    recomputed in the backward pass instead of kept (JAX's
    jax.checkpoint), its draws included."""

    def body(bounce, *state):
        return bounce_step(scene, cfg, bounce, draws.bounce(bounce, bounce >= cfg.min_bounces),
                           state)

    state = initial_state(origins, dirs)
    remat = cfg.max_bounces > CHECKPOINT_ABOVE_BOUNCES and torch.is_grad_enabled()
    for bounce in range(cfg.max_bounces):
        if remat:
            state = checkpoint(body, bounce, *state, use_reentrant=False)
        else:
            state = body(bounce, *state)
    radiance, edge_acc = state[3], state[5]
    # edge_acc is exactly 0.0 in the forward pass; adding it routes the
    # smoothed-boundary gradients into the pixel value without changing
    # the image (x + 0.0 == x).
    if cfg.edge_aware_lights and scene.light_rect is not None:
        return radiance + edge_acc
    return radiance
