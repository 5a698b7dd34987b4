"""K3-profile's plain version (ops/cuda_megakernel.render_tiles_fused
with profile=True on the CPU) and the step count of the plain traversal.

The radiance of a profiled render is the production render's bit for
bit. cost is a lane's path iterations plus its K1 steps; aux holds per
1024-lane packet the lockstep bill (row 0) and the outer path iterations
(row 1). Row 1 counts the same thing as the JAX kernel's row 1 (the
iterations until the packet's last lane is done), so it must equal the
JAX package's on every packet wherever the two trace the same paths;
row 0 is the card's warp bill, not the TPU's sub-warp one, and is held
to its defining inequality only."""

import jax
import numpy as np
import pytest
import torch
from torch_fused_ref import materials_scenes

from raytracer_tpu.camera import showcase_camera as jshowcase
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.models.wavefront import _tiled_pixel_grid as j_tiled_pixel_grid
from raytracer_tpu.ops.pallas_megakernel import render_tiles_fused as jrender_tiles_fused
from raytracer_tpu_torch.camera import showcase_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import cuda_megakernel
from raytracer_tpu_torch.ops.bvh4 import BIG, sort_by_key
from raytracer_tpu_torch.ops.cuda_traverse import NONE, _traverse_plain
from raytracer_tpu_torch.ops.triangle import moller_trumbore
from raytracer_tpu_torch.schedule import _tiled_pixel_grid
from raytracer_tpu_torch.scene.builder import cornell_materials_scene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return cornell_materials_scene()


def test_profile_output_sane(scene):
    """tests/test_schedule.py's checks, held to the port's plain version."""
    cfg = RenderConfig(width=128, height=16, spp=2, max_bounces=4)
    cam = showcase_camera(cfg)
    px, py, _ = _tiled_pixel_grid(cfg)
    rgb_p, cost, aux = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px, py, profile=True)
    rgb = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px, py)
    assert torch.equal(rgb_p, rgb)
    c = cost.numpy()
    assert np.isfinite(c).all() and (c > 0).all() and c.max() > c.min()
    a = aux.reshape(-1, 8, 128).numpy()
    cc = c.reshape(-1, 8, 128)
    lock, outer = a[:, 0, 0], a[:, 1, 0]
    assert (a[:, 0] == lock[:, None]).all() and (a[:, 1] == outer[:, None]).all()
    assert (lock + 1e-3 >= cc.max(axis=(1, 2)) - outer).all()
    assert (outer >= 1).all() and (outer <= cfg.spp * cfg.max_bounces + 2).all()
    assert (a[:, 2:] == 0).all()
    _, _, _, k1_steps, path_iters = cuda_megakernel.render_tiles_fused(
        scene, cam, cfg, 3, px, py, profile=True, lane_counts=True)
    assert torch.equal(cost, (k1_steps + path_iters).float())
    assert np.array_equal(outer, path_iters.reshape(-1, 1024).amax(dim=1).float().numpy())
    # Host chunks of whole packets give the same three outputs.
    chunked = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px, py, profile=True,
                                                 host_chunk_packets=1)
    assert all(torch.equal(x, y) for x, y in zip(chunked, (rgb_p, cost, aux)))


def test_profile_needs_whole_packets(scene):
    cfg = RenderConfig(width=32, height=8, spp=1, max_bounces=2)
    px, py, _ = _tiled_pixel_grid(cfg)
    with pytest.raises(ValueError, match="multiple of 1024"):
        cuda_megakernel.render_tiles_fused(scene, showcase_camera(cfg), cfg, 0, px[:1000],
                                           py[:1000], profile=True)


def test_aux_outer_row_matches_jax():
    """Key 5 at 128x16 spp2 mb4 (two packets): every pixel agrees with
    the JAX kernel to 2e-4 (no flip lane), and so does row 1."""
    js, ts = materials_scenes()
    jcfg = JRenderConfig(width=128, height=16, spp=2, max_bounces=4, rng_impl="ktf")
    cfg = RenderConfig(width=128, height=16, spp=2, max_bounces=4, rng_impl="ktf")
    jpx, jpy, _ = j_tiled_pixel_grid(jcfg)
    jrgb, _, jaux = jrender_tiles_fused(js, jshowcase(jcfg), jcfg, jax.random.key(5), jpx, jpy,
                                        interpret=True, profile=True)
    px, py, _ = _tiled_pixel_grid(cfg)
    rgb, _, aux = cuda_megakernel.render_tiles_fused(ts, showcase_camera(cfg), cfg, 5, px, py,
                                                     profile=True)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=2e-4, rtol=1e-4)
    row1 = aux.reshape(-1, 8, 128)[:, 1].numpy()
    np.testing.assert_array_equal(row1, np.asarray(jaux).reshape(-1, 8, 128)[:, 1])


def _scalar_walk(o, d, bvh, t_lim, t_min):
    """K1 for one ray as the kernel's loop takes it (csrc/traverse.cuh):
    (t_best, steps)."""
    t_best = torch.tensor(t_lim, dtype=torch.float32)
    if not float(t_best) > t_min:
        return float(t_best), 0

    def leaf(tri9):
        nonlocal t_best
        ok, t = moller_trumbore(o[None], d[None], tri9[:, 0:3], tri9[:, 3:6], tri9[:, 6:9])
        for k in range(tri9.shape[0]):
            if ok[k] and t[k] >= t_min and t[k] < t_best:
                t_best = t[k]

    if bvh.brute_tri is not None and bvh.brute_tri.shape[0]:
        leaf(bvh.brute_tri)
    inv = 1.0 / d
    stack, task, steps = [], 0, 0
    k_w = bvh.children.shape[1]
    while True:
        steps += 1
        nxt = NONE
        if task >= 0:
            b, ch = bvh.bounds[task], bvh.children[task]
            t0, t1 = (b[:, 0:3] - o) * inv, (b[:, 3:6] - o) * inv
            lo3, hi3 = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tmin = torch.maximum(torch.maximum(lo3[:, 0], lo3[:, 1]),
                                 torch.maximum(lo3[:, 2], torch.full_like(lo3[:, 2], t_min)))
            tmax = torch.minimum(torch.minimum(hi3[:, 0], hi3[:, 1]),
                                 torch.minimum(hi3[:, 2], t_best.expand(k_w)))
            valid = (tmax > tmin) & (ch != NONE)
            _, codes = sort_by_key(torch.where(valid, tmin, torch.full_like(tmin, BIG))[None],
                                   ch[None])
            nhit = int(valid.sum())
            if nhit:
                nxt = int(codes[0, 0])
            stack.extend(int(codes[0, k]) for k in range(nhit - 1, 0, -1))
        else:
            c = -task - 2
            leaf(bvh.tri[c // 8:c // 8 + c % 8 + 1])
        if nxt == NONE:
            if not stack:
                break
            nxt = stack.pop()
        task = nxt
    return float(t_best), steps


def test_traverse_plain_count_matches_scalar_walk(scene):
    rng = np.random.default_rng(11)
    o = torch.from_numpy(rng.uniform(-0.25, 0.25, (12, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(12, 3)).astype(np.float32))
    t_lim = torch.full((12,), BIG)
    t_lim[3] = -1.0   # a dead ray takes no step
    t_lim[7] = 0.05   # a short ray
    t_best, _, _, _, steps = _traverse_plain(o, d, scene.bvh4, t_lim, 1e-3, count=True)
    t_ref, steps_ref = zip(*(_scalar_walk(o[i], d[i], scene.bvh4, float(t_lim[i]), 1e-3)
                             for i in range(12)))
    assert steps.tolist() == list(steps_ref)
    assert t_best.tolist() == list(t_ref)
    assert steps[3] == 0 and min(steps_ref[:3]) > 1
    assert torch.equal(_traverse_plain(o, d, scene.bvh4, t_lim, 1e-3)[0], t_best)
