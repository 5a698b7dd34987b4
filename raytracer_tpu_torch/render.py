"""Top-level render API of the differentiable path (port of
raytracer_tpu/render.py).

A render is `(scene, camera, key) → image` through models/megakernel.py:
the mean radiance over samples of the pixels' paths. Image convention:
[H, W, 3] with row 0 at the TOP (the pixel ids are pre-flipped; the
reference renders bottom-up and flips at present time).

A key is an integer seed or jax.random key words (k0, k1) as int32
tensors, 0-d or one per lane (utils/rng.py). Every random number is a
pure function of (key, pixel, sample, bounce, purpose), so how samples
and pixels are batched does not change the image: render_pixels runs
up to cfg.max_rays_per_pass (pixel, sample) lanes per trace, and
accumulates the samples in index order, as the JAX package's sample
loop does.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.camera import generate_rays
from raytracer_tpu_torch.models import megakernel
from raytracer_tpu_torch.ops import tonemap
from raytracer_tpu_torch.utils import ktf
from raytracer_tpu_torch.utils import rng as rngu


def as_key(key, device):
    """Integer seed or (k0, k1) → key words on `device`."""
    if isinstance(key, tuple):
        return key[0].to(device), key[1].to(device)
    return rngu.key(key, device)


def render_pixels(scene, cam, px, py, cfg, key, spp: int | None = None,
                  sample_offset: int = 0) -> torch.Tensor:
    """Mean linear radiance f32[N,3] over `spp` samples of the pixels
    (px, py) (i32[N], py = 0 the bottom row). `sample_offset` shifts the
    global sample indices, so spp-batched accumulation draws the same
    numbers as one pass (render_image_chunked). Key words may be one
    per lane ([N]), for several (key, target) pairs in one render."""
    spp = cfg.spp if spp is None else int(spp)
    n = px.shape[0]
    dev = px.device
    k0, k1 = as_key(key, dev)
    pixel_ids = py * cfg.width + px
    per_pass = samples_per_trace(cfg, n, spp)

    if cfg.rng_impl != "ktf":
        pkeys = rngu.lane_keys((k0, k1), pixel_ids)

    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for s0 in range(0, spp, per_pass):
        m = min(per_pass, spp - s0)
        # Lanes are sample-major: lane j*n + i is pixel i at sample s0+j.
        # Each trace's draws take one kernel per camera and per bounce on
        # the card (utils/ktf.TraceDraws, utils/rng.TraceDraws).
        if cfg.rng_impl == "ktf":
            draws = ktf.TraceDraws(k0, k1, pixel_ids.to(torch.int32), m, s0 + sample_offset)
        else:
            draws = rngu.TraceDraws(pkeys, m, s0 + sample_offset)
        origins, dirs = generate_rays(cam, px.repeat(m), py.repeat(m), cfg.width, cfg.height,
                                      draws.camera())
        rad = megakernel.trace_paths(scene, origins, dirs, draws, cfg)
        rad = rad.reshape(m, n, 3)
        for j in range(m):
            acc = acc + rad[j]
    return acc / float(spp)


def samples_per_trace(cfg, n_pixels: int, spp: int) -> int:
    """Samples that render_pixels traces together for n_pixels pixels: as
    many as fit in cfg.max_rays_per_pass lanes (at least one). Each trace
    launches K4 once per bounce."""
    return max(1, min(spp, cfg.max_rays_per_pass // max(n_pixels, 1)))


def spp_passes(cfg, spp: int):
    """(s, offset, weight) of each pass of `spp` samples: passes of
    cfg.spp_per_pass samples, each weighted s / spp (None for a single
    pass, which is taken as it is)."""
    step = max(1, min(spp, cfg.spp_per_pass))
    for done in range(0, spp, step):
        s = min(step, spp - done)
        yield s, done, (None if s == spp else s / spp)


def mean_over_passes(cfg, spp: int, render_pass):
    """The mean over `spp` samples from render_pass(s, offset), the mean
    over samples [offset, offset + s), summed over spp_passes. Draws are
    keyed by the absolute sample, so the passes give the samples one
    pass would."""
    acc = None
    for s, done, w in spp_passes(cfg, spp):
        part = render_pass(s, done)
        part = part if w is None else part * w
        acc = part if acc is None else acc + part
    return acc


def pixel_grid(cfg, device=None):
    """Pixel ids of a full image, row 0 = top (pre-flipped)."""
    xs = torch.arange(cfg.width, dtype=torch.int32, device=device)
    ys_top_down = torch.arange(cfg.height - 1, -1, -1, dtype=torch.int32, device=device)
    return xs.repeat(cfg.height), ys_top_down.repeat_interleave(cfg.width)


def render_image(scene, cam, cfg, key) -> torch.Tensor:
    """Single-pass full-image render → linear f32[H,W,3] on the scene's device."""
    px, py = pixel_grid(cfg, scene.materials.type.device)
    rgb = render_pixels(scene, cam, px, py, cfg, key)
    return rgb.reshape(cfg.height, cfg.width, 3)


def render_rows(scene, cam, cfg, row0: int, n_rows: int, spp: int, key,
                sample_offset: int = 0) -> torch.Tensor:
    """`n_rows` full-width rows from top-down row `row0` of the
    cfg-sized image → f32[n_rows, W, 3]."""
    dev = scene.materials.type.device
    xs = torch.arange(cfg.width, dtype=torch.int32, device=dev)
    ys = cfg.height - 1 - (row0 + torch.arange(n_rows, dtype=torch.int32, device=dev))
    px, py = xs.repeat(n_rows), ys.repeat_interleave(cfg.width)
    rgb = render_pixels(scene, cam, px, py, cfg, key, spp=spp, sample_offset=sample_offset)
    return rgb.reshape(n_rows, cfg.width, 3)


def iter_spp_accumulation(scene, cam, cfg, key, integrator: str = "wavefront",
                          spp_per_batch: int | None = None, start_done: int = 0):
    """spp-batched accumulation, shared by the chunked, progressive and
    resumable renders: yields (done_spp, batch_sum f32[H,W,3]) on the
    scene's device, where batch_sum is the SUM of that batch's samples
    (divide the running total by done_spp for the current mean). Draws
    are keyed by the absolute sample index, so the batches add up to the
    one-pass image. `integrator`: "wavefront" (models/wavefront.py),
    "fused" (the fused path loop, ktf draws, an integer seed) or
    "megakernel" (rows chunked so that a pass holds at most
    cfg.max_rays_per_pass pixels)."""
    spp_step = max(1, min(cfg.spp, spp_per_batch or cfg.spp_per_pass))
    h, w = cfg.height, cfg.width
    dev = scene.materials.type.device
    done = start_done
    if integrator == "megakernel":
        rows_per_chunk = max(1, min(h, cfg.max_rays_per_pass // w))

        def batch(s, offset):
            return torch.cat([render_rows(scene, cam, cfg, row0, min(rows_per_chunk, h - row0),
                                          s, key, sample_offset=offset)
                              for row0 in range(0, h, rows_per_chunk)], dim=0)
    elif integrator == "fused":
        from raytracer_tpu_torch.ops.cuda_lane_grid import lane_grid
        from raytracer_tpu_torch.ops.cuda_megakernel import render_tiles_fused

        px, py, inv = lane_grid(cfg, dev)

        def batch(s, offset):
            mean = render_tiles_fused(scene, cam, cfg, key, px, py, spp=s, sample_offset=offset)
            return mean[inv].reshape(h, w, 3)
    elif integrator == "wavefront":
        from raytracer_tpu_torch.models.wavefront import render_pixels_wavefront
        from raytracer_tpu_torch.ops.cuda_lane_grid import tiled_lane_grid

        px, py, inv = tiled_lane_grid(cfg, dev)

        def batch(s, offset):
            mean = render_pixels_wavefront(scene, cam, px, py, cfg, key, spp=s,
                                           sample_offset=offset)
            return mean[inv].reshape(h, w, 3)
    else:
        raise ValueError(f"iter_spp_accumulation: unknown integrator {integrator!r}")
    while done < cfg.spp:
        s = min(spp_step, cfg.spp - done)
        mean = batch(s, done)
        done += s
        yield done, mean * s


def render_image_chunked(scene, cam, cfg, key) -> torch.Tensor:
    """Row-chunked, spp-batched megakernel render (bounded live wavefront
    memory): the image of render_image, drawn by sample offset."""
    acc = None
    for _, batch_sum in iter_spp_accumulation(scene, cam, cfg, key, integrator="megakernel"):
        acc = batch_sum if acc is None else acc + batch_sum
    return acc / cfg.spp


def tone_map_image(linear_rgb: torch.Tensor) -> torch.Tensor:
    """Linear f32[H,W,3] → display u8[H,W,4] (CRTUtility.cuh:21-32)."""
    return tonemap.to_rgba8(linear_rgb)
