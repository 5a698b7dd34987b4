"""raytracer_tpu_torch kernels ≡ their plain versions, on the card.

Marked `cuda`: these skip without an NVIDIA card (a CUDA kernel has no
CPU mode). On the machine with the card:
    python -m pytest -m cuda tests/test_torch_cuda.py -q
chip_smoke.py runs these checks on the reference scene at larger sizes:
K2 on 2^20 counters, its draw kernels on the training path's 1,048,576
lanes, K4 on 131,072 rays, K3 on the preflight frame and
on 16,384 seeded pixels of the 2560x1440 spp 8 mb 20 main-path frame,
K4's sort route (key kernel, argsort, K4 through the permutation) on a
262,144-ray bounce wavefront and on the training path's two
1,048,576-ray wavefronts, the training step
at the INVERSE_r05 width, K5 against K3 and K3 against the plain version
on the whole 2K frame,
K3-profile against K3 and its plain version, the culled K3 against the
parent commit's kernels (phase 15, opt-in), the traversal-iteration
probes at the scripts' sizes (phase 13; P-morph also at 1,056 packets),
the kernels on the reference scene's 4-wide tree (phase 14), the
wavefront integrator at 2560x1440 (phase 16), and the sharded renders,
the mesh-sharded train step and two processes on the card (phase 17)."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.camera import showcase_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.fused import _fused_pixel_grid, fused_lanes, render_image_fused
from raytracer_tpu_torch.models.wavefront import render_image_wavefront
from raytracer_tpu_torch.ops import cuda_lane_grid, cuda_megakernel, cuda_traverse
from raytracer_tpu_torch.ops.bvh4 import BIG
from raytracer_tpu_torch.ops.packets import coherence_keys, coherence_keys32
from raytracer_tpu_torch.probes import (ablate_v8, base_probe, bitcast, common, feature,
                                        interleave_probe, ktf_probe, morph, mosaic, scalar_cost,
                                        v5_body, v6, vstack)
from raytracer_tpu_torch.schedule import _tiled_pixel_grid
from raytracer_tpu_torch.scene.builder import (cornell_materials_scene, reference_scene,
                                               tree_width)
from raytracer_tpu_torch.utils import cudalib, ktf, profiling

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bunny(dev):
    return reference_scene().to(dev)


def test_k2_threefry_bitwise(dev):
    rng = np.random.default_rng(0)
    c0 = torch.from_numpy(rng.integers(-2**31, 2**31, 1 << 16).astype(np.int32)).to(dev)
    c1 = torch.from_numpy(rng.integers(-2**31, 2**31, 1 << 16).astype(np.int32)).to(dev)
    for seed in (0, 7, 2**31 + 5):
        k0, k1 = ktf.key_words(seed)
        got = ktf.threefry2x32_kernel(k0, k1, c0, c1)
        want = ktf.threefry2x32(k0, k1, c0.cpu(), c1.cpu())
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_k4_trace_closest_matches_plain(dev, bunny):
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.uniform(-0.28, 0.28, (8192, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(8192, 3)).astype(np.float32)).to(dev)
    t_max = torch.from_numpy(rng.uniform(-1.0, 2.0, 8192).astype(np.float32)).to(dev)
    k = cuda_traverse.trace_closest(o, d, bunny.bvh4, t_max)
    p = cuda_traverse.trace_closest_plain(o.cpu(), d.cpu(), bunny.to("cpu").bvh4, t_max.cpu())
    for key in ("t", "tri_id", "mat_id", "hit", "normal"):
        assert torch.equal(k[key].cpu(), p[key]), key
    assert (k["t"] < BIG).float().mean().item() > 0.3


@pytest.mark.parametrize("chunk", [1, 96])
@pytest.mark.parametrize("block", [32, 128, 256])
def test_k3_matches_plain_and_launch_shape(dev, block, chunk):
    """Block size and the lanes a block takes from the lane list at a time
    are launch shapes: the image is the same bit for bit (chunk 1 refills
    after every lane)."""
    scene = cornell_materials_scene().to(dev)
    cfg = RenderConfig(width=128, height=32, spp=2, max_bounces=8)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    k = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px, py, block=block, chunk=chunk)
    ref = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px, py, block=128)
    assert torch.equal(k, ref)
    p = cuda_megakernel.render_tiles_fused_plain(scene, cam, cfg, 3, px, py)
    bad = (k - p).abs() > 5e-4 + 2e-4 * p.abs()
    assert bad.float().mean().item() < 0.005
    assert abs(k.mean().item() - p.mean().item()) < 1e-3


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_k3_lane_list_corners(dev, n):
    """The lane list's corners: fewer lanes than a block's threads, a lane
    count that is no multiple of the block, a chunk of 1 (a fetch after
    every lane) and chunks larger than the block (blocks whose first chunk
    lies past the list). Each lane's radiance is the whole list's bit for
    bit, over repeated launches."""
    scene = cornell_materials_scene().to(dev)
    cfg = RenderConfig(width=128, height=32, spp=2, max_bounces=8)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    whole = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px, py)
    pick = np.random.default_rng(n).choice(px.shape[0], n, replace=False)
    lanes = torch.from_numpy(pick).to(dev)
    for block, chunk in ((32, 1), (32, 96), (256, 1), (64, 5)):
        for _ in range(5):
            got = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px[lanes], py[lanes],
                                                     block=block, chunk=chunk)
            assert torch.equal(got, whole[lanes]), (block, chunk)


@pytest.mark.parametrize("block", [64, 128, 256])
def test_k5_equals_k3_bitwise(dev, bunny, block):
    """Two lanes per thread, traversals merged: each lane's radiance is
    K3's bit for bit, also at an odd lane count (the last thread holds
    one lane)."""
    cfg = RenderConfig(width=128, height=40, spp=2, max_bounces=12)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    k3 = cuda_megakernel.render_tiles_fused(bunny, cam, cfg, 0, px, py, interleave=1)
    before = cuda_megakernel.LAUNCHES["render_fused_g2"]
    k5 = cuda_megakernel.render_tiles_fused(bunny, cam, cfg, 0, px, py, interleave=2, block=block)
    odd = cuda_megakernel.render_tiles_fused(bunny, cam, cfg, 0, px[:1023], py[:1023],
                                             interleave=2, block=block)
    assert cuda_megakernel.LAUNCHES["render_fused_g2"] == before + 2
    assert torch.equal(k5, k3)
    assert torch.equal(odd, k3[:1023])


def test_k3_profile_equals_k3_and_plain(dev, bunny):
    """K3-profile's radiance is K3's bit for bit; its cost and aux equal
    the plain version's exactly (integer counts of the same paths)."""
    cfg = RenderConfig(width=128, height=40, spp=2, max_bounces=12)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    k3 = cuda_megakernel.render_tiles_fused(bunny, cam, cfg, 0, px, py)
    before = cuda_megakernel.LAUNCHES["render_fused_profile"]
    rgb, cost, aux = cuda_megakernel.render_tiles_fused(bunny, cam, cfg, 0, px, py, profile=True)
    assert cuda_megakernel.LAUNCHES["render_fused_profile"] == before + 1
    _, p_cost, p_aux, p_k1, p_it = cuda_megakernel.render_tiles_fused_plain(
        bunny, cam, cfg, 0, px, py, profile=True, lane_counts=True)
    _, _, _, k1, it = cuda_megakernel.render_tiles_fused(bunny, cam, cfg, 0, px, py, profile=True,
                                                         lane_counts=True)
    assert torch.equal(rgb, k3)
    assert torch.equal(cost, p_cost) and torch.equal(aux, p_aux)
    assert torch.equal(k1, p_k1) and torch.equal(it, p_it)
    regs = cuda_megakernel.kernel_resources()
    assert set(regs) == {"K3", "K3-profile", "K5", "K3/w4", "K3-profile/w4", "K5/w4"}
    assert all(r > 0 for r, _ in regs.values())


@pytest.mark.parametrize("chunk", [7, 64])
@pytest.mark.parametrize("block", [64, 256])
def test_k3_profile_launch_shape(dev, bunny, block, chunk):
    """K3-profile's rgb, cost and aux at other block and chunk sizes are
    the same bit for bit: which thread takes which lane changes nothing."""
    cfg = RenderConfig(width=128, height=40, spp=2, max_bounces=12)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    ref = cuda_megakernel.render_tiles_fused(bunny, cam, cfg, 0, px, py, profile=True)
    got = cuda_megakernel.render_tiles_fused(bunny, cam, cfg, 0, px, py, profile=True,
                                             block=block, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("width", [4, 8])
def test_k4_culled_prepass_matches_plain(dev, width):
    """K4 with K1's culled brute pre-pass ≡ the plain traversal's
    exhaustive one bit for bit, on rays aimed at the brute triangles
    (walls, boxes, light) from inside the box and at grazing angles, at
    both tree widths; a brute set beyond the kernels' stage raises."""
    from raytracer_tpu_torch.ops.bvh4 import Bvh4
    from raytracer_tpu_torch.utils import cudalib

    with tree_width(width):
        scene = reference_scene()
    bvh = scene.bvh4
    rng = np.random.default_rng(30 + width)
    n = 32768
    tri = bvh.brute_tri.numpy().astype(np.float64)
    j = rng.integers(0, tri.shape[0], n)
    a, b = rng.uniform(size=n), rng.uniform(size=n)
    flip = a + b > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    target = tri[j, 0:3] + a[:, None] * tri[j, 3:6] + b[:, None] * tri[j, 6:9]
    o = rng.uniform(-0.29, 0.29, (n, 3))
    d = target - o
    nrm = np.cross(tri[j, 3:6], tri[j, 6:9])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    graze = rng.uniform(size=n) < 0.25     # directions a hair off the plane
    d[graze] -= (d[graze] * nrm[graze]).sum(1, keepdims=True) * nrm[graze]
    d[graze] += (10 ** rng.uniform(-8, -4, int(graze.sum())))[:, None] * nrm[graze]
    o_t = torch.from_numpy(o.astype(np.float32))
    d_t = torch.from_numpy(d.astype(np.float32))
    t_max = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    k = cuda_traverse.trace_closest(o_t.to(dev), d_t.to(dev), bvh.to(dev), t_max.to(dev),
                                    sort=False)
    p = cuda_traverse.trace_closest_plain(o_t, d_t, bvh, t_max)
    for key in ("t", "tri_id", "mat_id", "hit", "normal"):
        assert torch.equal(k[key].cpu(), p[key]), key
    assert p["hit"].float().mean().item() > 0.5
    big = Bvh4(**{f: getattr(bvh, f) for f in ("bounds", "children", "tri", "prim_index",
                                               "face_mat")},
               brute_tri=torch.zeros((cudalib.MAX_BRUTE + 8, 9)),
               brute_prim=torch.zeros((cudalib.MAX_BRUTE + 8,), dtype=torch.int32),
               brute_mat=torch.zeros((cudalib.MAX_BRUTE + 8,), dtype=torch.int32))
    with pytest.raises(ValueError, match="brute triangles exceed"):
        cuda_traverse.trace_closest(o_t.to(dev), d_t.to(dev), big.to(dev), t_max.to(dev))
    bare = dataclasses.replace(bvh, brute_box=None)   # the kernels never cull without the table
    with pytest.raises(ValueError, match="without its cull table"):
        cuda_traverse.trace_closest(o_t.to(dev), d_t.to(dev), bare.to(dev), t_max.to(dev))


def test_k3_preflight_known_answer(dev, bunny):
    cfg = RenderConfig(width=128, height=40, spp=2, max_bounces=12)
    img = render_image_fused(bunny, showcase_camera(cfg), cfg, 0)
    assert abs(img.mean().item() - 0.276287317276001) <= 0.02 * 0.276287317276001


LANE_GRID_SIZES = [(2560, 1440), (3840, 2160), (1920, 1088), (1920, 1080), (33, 64), (17, 9),
                   (1, 1), (24, 40), (100, 7)]


@pytest.mark.parametrize("layout", ["BLOCKED", "TILED"])
@pytest.mark.parametrize("w,h", LANE_GRID_SIZES)
def test_lane_grid_kernel_equals_plain(dev, w, h, layout):
    """The lane-grid kernel's (px, py, inv) is the plain closed form's bit
    for bit, dtypes included, run on the CPU (the CPU tests hold that to
    numpy and to the JAX package) and on the card, in one launch, at
    sizes that divide exactly, pad, or are narrower than a packet, up to
    3840x2160."""
    lay = getattr(cuda_lane_grid, layout)
    launches = cuda_lane_grid.LAUNCHES["lane_grid"]
    got = cuda_lane_grid.build(w, h, lay, dev)
    torch.cuda.synchronize()
    assert cuda_lane_grid.LAUNCHES["lane_grid"] == launches + 1
    on_card = cuda_lane_grid.build(w, h, lay, dev, plain=True)
    assert cuda_lane_grid.LAUNCHES["lane_grid"] == launches + 1
    for g, want, p in zip(got, cuda_lane_grid.lane_grid_plain(w, h, lay), on_card):
        assert g.is_cuda and g.dtype == want.dtype and torch.equal(g.cpu(), want)
        assert p.is_cuda and p.dtype == want.dtype and torch.equal(p, g)


def test_plain_fused_route_builds_its_grid_without_the_kernel(dev, bunny):
    """render_image_fused(plain=True) on the card takes the plain lane
    grid on the card, so the plain route that K3 and K5 are held to runs
    no hand-written kernel for its grid; its image is the kernel route's
    image through the plain path loop on the kernel's grid."""
    cfg = RenderConfig(width=64, height=40, spp=1, max_bounces=3, rng_impl="ktf")
    cam = showcase_camera(cfg)
    launches = cuda_lane_grid.LAUNCHES["lane_grid"]
    plain_calls = cuda_lane_grid.PLAIN_CALLS["lane_grid"]
    got = render_image_fused(bunny, cam, cfg, 5, plain=True)
    assert cuda_lane_grid.LAUNCHES["lane_grid"] == launches
    assert cuda_lane_grid.PLAIN_CALLS["lane_grid"] == plain_calls + 1
    px, py, inv = cuda_lane_grid.lane_grid(cfg, dev)
    want = fused_lanes(bunny, cam, cfg, 5, px, py, plain=True)[inv].reshape(cfg.height,
                                                                           cfg.width, 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("integrator", ["fused", "wavefront"])
def test_one_lane_grid_launch_a_render_and_no_copy_in_its_span(dev, bunny, integrator):
    """A profiled request launches the lane-grid kernel once, inside its
    grid span, and nothing in that span copies to the card."""
    from torch.profiler import ProfilerActivity, profile

    render = render_image_fused if integrator == "fused" else render_image_wavefront
    cfg = RenderConfig(width=256, height=128, spp=2, max_bounces=4, rng_impl="ktf")
    cam = showcase_camera(cfg)
    render(bunny, cam, cfg, 0)   # the kernel library loads
    launches = cuda_lane_grid.LAUNCHES["lane_grid"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(bunny, cam, cfg, 0)
        torch.cuda.synchronize()
    assert cuda_lane_grid.LAUNCHES["lane_grid"] == launches + 1
    (grid,) = [s for s in profiling.recorded() if s.name == f"rt.{integrator}.grid"]
    assert grid.counts == {"launch.lane_grid": 1}
    events = prof.profiler.kineto_results.events()
    assert [e.name() for e in events if "memcpy" in e.name().lower()
            and grid.start_ns <= e.start_ns() <= grid.end_ns] == []
    assert any("lane_grid" in e.name() and not str(e.device_type()).endswith("CPU")
               for e in events)


def test_fused_2k_image_equals_the_numpy_grid_route(dev, bunny):
    """A 2560x1440 4 spp image through the grid built on the card is the
    image through the numpy grid and its copy, bit for bit."""
    cfg = RenderConfig(width=2560, height=1440, spp=4)
    cam = showcase_camera(cfg)
    got = render_image_fused(bunny, cam, cfg, 11)
    px, py, inv = (t.to(dev) for t in _fused_pixel_grid(cfg))
    want = fused_lanes(bunny, cam, cfg, 11, px, py)[inv].reshape(cfg.height, cfg.width, 3)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all()) and got.mean().item() > 0.05


def test_k2_keyed_entry_bitwise(dev):
    """One key per element (the jax.random family's lane keys)."""
    rs = np.random.default_rng(2)
    k0, k1, c0, c1 = (torch.from_numpy(rs.integers(-2**31, 2**31, 1 << 14).astype(np.int32))
                      for _ in range(4))
    got = ktf.threefry2x32_kernel(k0.to(dev), k1.to(dev), c0.to(dev), c1.to(dev))
    want = ktf.threefry2x32(k0, k1, c0, c1)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_k4_sorted_equals_unsorted_and_plain(dev, bunny):
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-0.28, 0.28, (16384, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(16384, 3)).astype(np.float32)).to(dev)
    before = cuda_traverse.LAUNCHES["trace_closest_sorted"]
    s = cuda_traverse.trace_closest(o, d, bunny.bvh4, BIG, sort=True)
    assert cuda_traverse.LAUNCHES["trace_closest_sorted"] == before + 1
    u = cuda_traverse.trace_closest(o, d, bunny.bvh4, BIG, sort=False)
    p = cuda_traverse.trace_closest_plain(o.cpu(), d.cpu(), bunny.to("cpu").bvh4, BIG, sort=True)
    for key in s:
        assert torch.equal(s[key], u[key]), key
        assert torch.equal(s[key].cpu(), p[key]), key


def test_kernel_step_equals_plain_step(dev):
    """Loss and gradients of the training loss on the card (K4, K2) and
    on the CPU (their plain versions): loss to 1e-4 relative, gradients
    to 1% of each field's scale (transcendentals and reductions round
    differently on the card)."""
    from raytracer_tpu_torch.camera import make_camera
    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.render import pixel_grid, render_image
    from raytracer_tpu_torch.utils import rng

    cfg = RenderConfig(width=24, height=16, spp=2, max_bounces=3,
                       reference_emission_quirk=False, edge_aware_lights=True)
    scene = cornell_materials_scene()
    cam = make_camera(aspect_ratio=cfg.aspect_ratio, position=(0.0, 0.05, 0.29), pitch=-5.0)
    keys = rng.split(rng.key(40), 2)
    with torch.no_grad():
        tg = torch.stack([render_image(scene, cam, cfg, (keys[0][j], keys[1][j]))
                          for j in range(2)]).reshape(2, -1, 3)
    params = inverse.init_params(scene, key=rng.key(41), noise=0.15)
    px, py = pixel_grid(cfg)

    def run(device):
        sc, cm = scene.to(device), cam.to(device)
        ks, t = (keys[0].to(device), keys[1].to(device)), tg.to(device)
        p = {k: v.to(device) for k, v in params.items()}
        return inverse.value_and_grad(
            lambda q: inverse.pairs_loss(sc, cm, cfg, q, ks, t, px.to(device), py.to(device)), p)

    before = cuda_traverse.LAUNCHES["trace_closest"]
    loss_k, grads_k = run(dev)
    assert cuda_traverse.LAUNCHES["trace_closest"] > before
    loss_p, grads_p = run(torch.device("cpu"))
    assert abs(float(loss_k) - float(loss_p)) <= 1e-4 * abs(float(loss_p))
    for k, g in grads_p.items():
        assert (grads_k[k].cpu() - g).abs().max() <= 0.01 * g.abs().max() + 1e-12, k


def _bitwise(a, b):
    a, b = a.cpu(), b.cpu()
    both_nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | both_nan).all())


# Each chain width, and None: the one the entry point picks.
WIDTHS = (None, *common.CHAIN_WIDTHS)
V5_CASES = [(m, w) for m in v5_body.MODES for w in (None, *v5_body.ADMITTED_W[m])]


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("variant", ablate_v8.VARIANTS)
def test_probe_v8_equals_plain(dev, variant, w):
    """csrc/probe_v8.cu ≡ ablate_v8_plain bit for bit at every chain width
    (the script's inputs at 3 packets, 3 W blocks, 12 iterations), and the
    wrapper counts its launch."""
    node, tri, o, d = (torch.from_numpy(a) for a in ablate_v8.make_inputs(3))
    before = ablate_v8.LAUNCHES["probe_v8"]
    k = ablate_v8.ablate_v8(node.to(dev), tri.to(dev), o.to(dev), d.to(dev), variant, 12, w=w)
    assert ablate_v8.LAUNCHES["probe_v8"] == before + 1
    assert _bitwise(k, ablate_v8.ablate_v8_plain(node, tri, o, d, variant, 12))


@pytest.mark.parametrize("w", WIDTHS)
def test_probe_v8_nan_inputs_equal_plain(dev, w):
    """NaN bounds and zero direction components: the kernel's NaN-is-miss
    slab gives the plain version's (torch.minimum/maximum) results, NaN
    where those propagate it, in every variant at every chain width."""
    node, tri, o, d = (torch.from_numpy(a) for a in ablate_v8.make_inputs(2))
    node[::7, 0:48:5] = float("nan")
    node[::11, 3] = float("inf")
    d[:, 0, :, ::9] = 0.0
    for v in ablate_v8.VARIANTS:
        k = ablate_v8.ablate_v8(node.to(dev), tri.to(dev), o.to(dev), d.to(dev), v, 12, w=w)
        assert _bitwise(k, ablate_v8.ablate_v8_plain(node, tri, o, d, v, 12)), v


@pytest.fixture(scope="module")
def v5_inputs():
    node, tri, zero_row = v5_body.reference_tables()
    o, d, tlim = (torch.from_numpy(a) for a in v5_body.make_rays(2))
    return node, tri, o, d, tlim, zero_row


@pytest.mark.parametrize("mode, w", V5_CASES)
def test_probe_v5_equals_plain(dev, v5_inputs, mode, w):
    """csrc/probe_v5.cu ≡ v5_plain bit for bit in every mode of the four
    v5 probes at every chain width it admits (the reference scene's
    4-wide tree, 2 packets, 12 iterations; 3 packets at 20 iterations,
    seed 7), and the wrapper counts its launches."""
    node, tri, o, d, tlim, zero_row = v5_inputs
    o3, d3, tl3 = (torch.from_numpy(a) for a in v5_body.make_rays(3, seed=7))
    before = v5_body.LAUNCHES["probe_v5"]
    for rays, iters in (((o, d, tlim), 12), ((o3, d3, tl3), 20)):
        k = v5_body.v5(*(t.to(dev) for t in (node, tri, *rays)), zero_row, mode, iters, w=w)
        assert _bitwise(k, v5_body.v5_plain(node, tri, *rays, zero_row, mode, iters))
    assert v5_body.LAUNCHES["probe_v5"] == before + 2


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("mode", base_probe.MODES)
def test_probe_v5_base_modes_varied_limits(dev, v5_inputs, mode, w):
    """The base modes' rows are t_best + a task: at limits seeded in ±50
    the chains take different tasks, so noconcat's read of chain 0's task
    (after a block barrier) is exercised; kernel ≡ plain bit for bit at
    every chain width."""
    if w is not None and w not in v5_body.ADMITTED_W[mode]:
        with pytest.raises(ValueError):
            v5_body.v5(*(t.to(dev) for t in v5_inputs[:5]), v5_inputs[5], mode, 24, w=w)
        return
    node, tri, o, d, tlim, zero_row = v5_inputs
    tl = torch.from_numpy(np.random.default_rng(5).uniform(-50, 50, tuple(tlim.shape))
                          .astype(np.float32))
    k = v5_body.v5(*(t.to(dev) for t in (node, tri, o, d, tl)), zero_row, mode, 24, w=w)
    assert _bitwise(k, v5_body.v5_plain(node, tri, o, d, tl, zero_row, mode, 24))


def test_probe_chain_widths_spill_nothing_and_refuse_others(dev, v5_inputs):
    """Every instantiation of P-v8 and the v5 body has 0 bytes of local
    memory; a chain width not admitted raises in the wrapper and is refused
    by the C entry point (no other W taken); the entry points pick the W
    that common.pick_w gives for this card's SM count and each kernel's
    WARPS_PER_SM."""
    for w in ablate_v8.ADMITTED_W:
        assert all(local == 0 for _, local in ablate_v8.kernel_resources(w).values()), w
    for mode in v5_body.MODES:
        for w in v5_body.ADMITTED_W[mode]:
            assert v5_body.kernel_resources((mode,), w)[mode][1] == 0, (mode, w)
    node, tri, o, d = (t.to(dev) for t in (torch.from_numpy(a)
                                           for a in ablate_v8.make_inputs(1)))
    n5, t5, o5, d5, tl5 = (t.to(dev) for t in v5_inputs[:5])
    out = torch.zeros((1, 8, 128), device=dev)
    lib = cudalib.lib()
    for w in (0, 3, 8):
        with pytest.raises(ValueError):
            ablate_v8.ablate_v8(node, tri, o, d, "full", 4, w=w)
        with pytest.raises(ValueError):
            v5_body.v5(n5, t5, o5[:1], d5[:1], tl5[:1], v5_inputs[5], "full", 4, w=w)
        assert lib.rt_probe_v8_w(node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(),
                                 node.shape[0], tri.shape[0], 4, 1, 0, w, out.data_ptr(),
                                 cudalib.stream_handle()) != 0
        assert lib.rt_probe_v5_w(n5.data_ptr(), t5.data_ptr(), o5.data_ptr(), d5.data_ptr(),
                                 tl5.data_ptr(), v5_inputs[5], 4, 1, 0, w, out.data_ptr(),
                                 cudalib.stream_handle()) != 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for packets in (1, 64, 66, 67, 128, 132, 264, 265, 1056):
        for v in ablate_v8.VARIANTS:
            assert ablate_v8.chosen_w(packets, v) == common.pick_w(
                packets, sms, ablate_v8.ADMITTED_W, ablate_v8.WARPS_PER_SM)
        for mode in v5_body.MODES:
            assert v5_body.chosen_w(packets, mode) == common.pick_w(
                packets, sms, v5_body.ADMITTED_W[mode], v5_body.WARPS_PER_SM)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("G", interleave_probe.GS)
def test_probe_interleave_equals_v5_full(dev, v5_inputs, G, w):
    """csrc/probe_interleave.cu at every G and every chain width it admits
    (None: the one the wrapper picks) ≡ the v5 full body's plain
    version bit for bit (8 packets, 12 iterations); one launch counted. A W
    that G does not admit raises."""
    node, tri, _, _, _, zero_row = v5_inputs
    o, d, tlim = (torch.from_numpy(a) for a in v5_body.make_rays(8, seed=3))
    args = (*(t.to(dev) for t in (node, tri, o, d, tlim)), zero_row, G, 12)
    if w is not None and w not in interleave_probe.ADMITTED_W[G]:
        with pytest.raises(ValueError, match="chain width"):
            interleave_probe.interleave(*args, w=w)
        return
    before = interleave_probe.LAUNCHES["probe_interleave"]
    k = interleave_probe.interleave(*args, w=w)
    assert interleave_probe.LAUNCHES["probe_interleave"] == before + 1
    assert _bitwise(k, v5_body.v5_plain(node, tri, o, d, tlim, zero_row, "full", 12))


@pytest.mark.parametrize("w", (None, *scalar_cost.ADMITTED_W))
@pytest.mark.parametrize("mode", scalar_cost.MODES)
def test_probe_scalar_equals_plain(dev, mode, w):
    """csrc/probe_scalar.cu ≡ scalar_plain bit for bit at every W (None: the
    one the wrapper picks): acc, the witness sc and vsort's codes (5
    packets, 70 iterations: smem16's carried table matters past 64), also
    on inputs scaled into ±3,000 with a NaN, where extract8's values
    convert to non-zero ints and so cross the packet's warps; the wrapper
    counts its launch; a W not admitted raises."""
    x = torch.from_numpy(scalar_cost.make_input(5, seed=4))
    big = x * torch.from_numpy(np.random.default_rng(2).uniform(
        -3000, 3000, tuple(x.shape)).astype(np.float32))
    big[1, 2, 5] = float("nan")
    for inp in (x, big):
        before = scalar_cost.LAUNCHES["probe_scalar"]
        acc, sc, codes = scalar_cost.scalar_cost(inp.to(dev), mode, 70, w=w)
        assert scalar_cost.LAUNCHES["probe_scalar"] == before + 1
        acc_p, sc_p, codes_p = scalar_cost.scalar_plain(inp, mode, 70)
        assert _bitwise(acc, acc_p) and torch.equal(sc.cpu(), sc_p)
        assert (codes is None) == (codes_p is None)
        if codes is not None:
            assert torch.equal(codes.cpu(), codes_p)
    if w is None:
        for bad in (0, 3, 16):
            with pytest.raises(ValueError, match="chain width"):
                scalar_cost.scalar_cost(x.to(dev), mode, 4, w=bad)


@pytest.mark.parametrize("packets, iters", [(1, 1), (9, 150), (65, 5), (256, 403), (256, 806)])
def test_probe_scalar_tables_equal_chain(dev, packets, iters):
    """The pre-pass (every packet's chain at once, then the scan over
    packets) gives smem16_chain's starting tables at phase 13's sizes."""
    got = scalar_cost.smem16_tables(packets, iters, dev)
    assert torch.equal(got.cpu(), scalar_cost.smem16_tables(packets, iters, "cpu"))


@pytest.mark.parametrize("case", vstack.CASES)
def test_probe_vstack_equals_plain(dev, case):
    """csrc/probe_vstack.cu ≡ vstack_plain bit for bit: p1 / p3 at 64
    iterations, where they also equal the push/pop model, and at 150, where
    sp passes the row's 128 entries; p2_smem at 300 and at 2,000, at its
    92-entry clamp; the others at 300."""
    sizes = {"p1": (64, 150), "p3": (64, 150), "p2_smem": (300, 2000)}.get(case, (300,))
    for iters in sizes:
        k = vstack.vstack(case, iters, dev)
        p = vstack.vstack_plain(case, iters)
        if case in vstack.RECORD:
            assert torch.equal(k[0].cpu(), p[0]) and torch.equal(k[1].cpu(), p[1])
            if iters == 64:
                assert vstack.matches_model(case, k[0].cpu(), k[1].cpu(), 64) == (True, True)
        else:
            assert _bitwise(k, p)


def test_probe_resources(dev):
    """Registers of every probe kernel; 0 local bytes in every P-scalar
    kernel (each mode at every W, and the pre-pass) and every P-vstack
    case."""
    regs8, regs5 = ablate_v8.kernel_resources(), v5_body.kernel_resources()
    assert set(regs8) == set(ablate_v8.VARIANTS) and set(regs5) == set(v5_body.MODES)
    more = [*interleave_probe.kernel_resources().values(),
            *scalar_cost.kernel_resources().values(), *vstack.kernel_resources().values()]
    assert all(r > 0 for r, _ in list(regs8.values()) + list(regs5.values()) + more)
    new = [*vstack.kernel_resources().values(), scalar_cost.kernel_resources(("tables",))["tables"],
           *(r for w in scalar_cost.ADMITTED_W
             for r in scalar_cost.kernel_resources(scalar_cost.MODES, w).values())]
    assert len(new) == 5 + 1 + 20 and all(local == 0 for _, local in new), new


def _max_ulp(a, b):
    return int((a.contiguous().view(torch.int32).long()
                - b.contiguous().view(torch.int32).long()).abs().max())


@pytest.mark.parametrize("family", ["jax", "ktf"])
def test_draw_kernels_match_the_chain(dev, family):
    """The draw kernels ≡ the per-method chain on the card (kernel=False)
    on 2^20 lanes (131,072 pixels x 8 samples, key words per pixel):
    keys, bits and uniforms bit for bit; the unit vectors and disks,
    which go through log1pf or cos/sin, within the 3 ulp that
    tests/test_torch_rng.py states for the port's normals (on the card
    they have agreed bit for bit)."""
    rs = np.random.default_rng(10)
    n, m = 1 << 17, 8
    words = [torch.from_numpy(rs.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
             for _ in range(2)]
    pix = torch.from_numpy(rs.integers(0, 2560 * 1440, n).astype(np.int32)).to(dev)
    before = dict(ktf.LAUNCHES)
    if family == "jax":
        from raytracer_tpu_torch.utils import rng

        pkeys = rng.lane_keys(tuple(words), pix)
        cam, cam_p = rng.camera_draws(pkeys, m, 3), rng.camera_draws_plain(pkeys, m, 3)
        assert all(torch.equal(a, b) for a, b in zip(cam.pop("keys"), cam_p.pop("keys")))
        keys = rng.camera_draws_plain(pkeys, m, 3)["keys"]
        sites = [(cam, cam_p)] + [(rng.bounce_draws(keys, b, rr),
                                   rng.bounce_draws_plain(keys, b, rr))
                                  for b, rr in ((0, False), (5, True))]
    else:
        tr = ktf.TraceDraws(words[0], words[1], pix, m, 3)
        sites = [(ktf.camera_draws(tr), ktf.camera_draws_plain(tr))] + [
            (ktf.bounce_draws(tr, b, rr), ktf.bounce_draws_plain(tr, b, rr))
            for b, rr in ((0, False), (5, True))]
    assert ktf.LAUNCHES["camera_draws"] == before["camera_draws"] + 1
    assert ktf.LAUNCHES["bounce_draws"] == before["bounce_draws"] + 2
    for got, want in sites:
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k
            if k in ("scatter", "lens_x", "lens_y"):
                assert _max_ulp(got[k], want[k]) <= 3, k
            else:
                assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_k5_lane_list_corners(dev, width, n):
    """K5's lane list at the corners test_k3_lane_list_corners holds K3
    to: fewer lanes than a block's threads, an odd lane count, a chunk of
    1 and chunks larger than the block. Each lane's radiance is K3's bit
    for bit, over repeated launches, at tree widths 8 and 4."""
    with tree_width(width):
        scene = cornell_materials_scene().to(dev)
    assert scene.bvh4.children.shape[1] == width
    cfg = RenderConfig(width=128, height=32, spp=2, max_bounces=8)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    whole = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px, py, interleave=1)
    pick = np.random.default_rng(n).choice(px.shape[0], n, replace=False)
    lanes = torch.from_numpy(pick).to(dev)
    want = whole[lanes]
    for block, chunk in ((32, 1), (32, 96), (256, 1), (64, 5)):
        for _ in range(3):
            got = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px[lanes], py[lanes],
                                                     block=block, chunk=chunk, interleave=2)
            bad = torch.nonzero((got != want).any(dim=1)).squeeze(1)
            assert torch.equal(got, want), (block, chunk, bad.numel(), bad[:4].tolist(),
                                            got[bad[:2]].tolist(), want[bad[:2]].tolist())


@pytest.mark.parametrize("interleave", [1, 2])
@pytest.mark.parametrize("width", [8, 4])
def test_lane_list_corners_repeated(dev, width, interleave):
    """The lane-list corners of test_k3_lane_list_corners and
    test_k5_lane_list_corners, 200 times each at 1, 37 and 1,000 lanes,
    against K3's whole list, which is re-rendered and held to itself each
    time; then 1,000 lanes at chunk 1, 1,000 times per block size: the
    harness chip_smoke.py's phase 11 runs at both widths and interleaves.
    The wrapper fills the output with NaN before every launch, so a lost
    lane shows as NaN, a wrong walk as a wrong finite radiance. With the
    take through atomicAdd (the parent commit's csrc/megakernel.cuh) K5 at
    width 4 lost a lane in about 0.5% of the chunk-1 launches at 1,000
    lanes, or hung."""
    smoke = _chip_smoke()
    got = smoke.lane_list_repeats(dev, widths=(width,), interleaves=(interleave,))
    kernel = "K5" if interleave == 2 else "K3"
    assert got["launches"][kernel] >= 200 * 3 * len(smoke.LANE_CASES) + 2000


@pytest.mark.parametrize("rng_impl", ["ktf", "jax"])
def test_wavefront_on_the_card_equals_its_cpu_route(dev, bunny, rng_impl):
    """The wavefront through K4 and K2 on the card against the same frame
    through their plain versions on the CPU: the image tolerance (at most
    0.5% of elements beyond 5e-4 + 2e-4|x|, means within 1e-3)."""
    from raytracer_tpu_torch.ops import intersect

    cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=8, rng_impl=rng_impl)
    cam = showcase_camera(cfg)
    k4, k2 = cuda_traverse.LAUNCHES["trace_closest"], ktf.LAUNCHES["threefry2x32"]
    got = render_image_wavefront(bunny, cam, cfg, 0)
    assert intersect.fused_trace_available(bunny)
    assert cuda_traverse.LAUNCHES["trace_closest"] > k4 and ktf.LAUNCHES["threefry2x32"] > k2
    want = render_image_wavefront(bunny.to("cpu"), cam, cfg, 0)
    got = got.cpu()
    assert bool(torch.isfinite(got).all())
    bad = (got - want).abs() > 5e-4 + 2e-4 * want.abs()
    assert bad.float().mean().item() <= 0.005
    assert (got.mean(dim=(0, 1)) - want.mean(dim=(0, 1))).abs().max().item() <= 1e-3
    assert want.mean().item() > 0.05


@pytest.fixture(scope="module")
def bunny4(dev):
    with tree_width(4):
        scene = reference_scene()
    assert scene.bvh4.children.shape[1] == 4
    return scene.to(dev)


def test_k4_width4_matches_plain(dev, bunny4):
    """K4 on the 4-wide tree ≡ its plain version on every field."""
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.uniform(-0.28, 0.28, (8192, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(8192, 3)).astype(np.float32)).to(dev)
    t_max = torch.from_numpy(rng.uniform(-1.0, 2.0, 8192).astype(np.float32)).to(dev)
    before = cuda_traverse.LAUNCHES["trace_closest"]
    k = cuda_traverse.trace_closest(o, d, bunny4.bvh4, t_max, sort=False)
    assert cuda_traverse.LAUNCHES["trace_closest"] == before + 1
    p = cuda_traverse.trace_closest_plain(o.cpu(), d.cpu(), bunny4.to("cpu").bvh4, t_max.cpu())
    for key in ("t", "tri_id", "mat_id", "hit", "normal"):
        assert torch.equal(k[key].cpu(), p[key]), key
    regs = cuda_traverse.kernel_resources()
    assert set(regs) == {"K4", "K4/w4"} and all(r > 0 for r, _ in regs.values())


def _k4_rays(n, seed, dev):
    """Rays in the reference scene's box; per-ray limits with a quarter
    dead (t_max <= t_min), the rest capped or open."""
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-0.28, 0.28, (n, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    t_max = torch.from_numpy(np.where(rng.uniform(size=n) < 0.25, -1.0,
                                      rng.uniform(0.05, 3.0, n)).astype(np.float32)).to(dev)
    return o, d, t_max, rng


def _same_record(k, p, fields=cuda_traverse.RECORD):
    assert set(k) == set(fields)
    for key in fields:
        assert k[key].dtype == p[key].dtype, key
        assert torch.equal(k[key], p[key]), key


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("n", [1, 37, 1000, 131073])
def test_k4_through_perm_and_null_outputs(dev, bunny, bunny4, width, n):
    """K4 ≡ its plain version with and without a permutation (random and
    the coherence order), with a scalar and a per-ray limit, and with
    outputs left out (null pointers: those fields are not written)."""
    bvh = (bunny if width == 8 else bunny4).bvh4
    o, d, t_max, rng = _k4_rays(n, n + width, dev)
    perms = {"none": None, "random": torch.from_numpy(rng.permutation(n)).to(dev),
             "coherence": cuda_traverse.sort_perm(o, d, bvh)}
    for pname, perm in perms.items():
        for lim in (float(BIG), t_max):
            want = cuda_traverse.trace_closest_plain(o, d, bvh, lim, perm=perm)
            _same_record(cuda_traverse._trace_closest_cuda(o, d, bvh, lim, 1e-3, perm=perm), want)
            for fields in (("t", "tri_id"), ("hit",), ("mat_id", "normal")):
                got = cuda_traverse._trace_closest_cuda(o, d, bvh, lim, 1e-3, perm=perm,
                                                        fields=fields)
                _same_record(got, want, fields)


def test_key_kernel_matches_plain(dev, bunny):
    """The key kernel ≡ coherence_keys32 (rays with -0.0 components and
    origins outside the sort box and on its faces), and its stable argsort
    ≡ the int64 keys'."""
    bvh = bunny.bvh4
    rng = np.random.default_rng(5)
    box = bvh.sort_box.cpu()
    lo, hi = box[0:3].numpy(), box[0:3].numpy() + 1.0 / box[3:6].numpy()
    n = 65537
    o = rng.uniform(lo - 0.3, hi + 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[np.arange(4096), rng.integers(0, 3, 4096)] = -0.0
    o[4096:8192, 0] = lo[0]
    o[8192:12288, 2] = hi[2]
    od, dd = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    before = cuda_traverse.LAUNCHES["coherence_keys"]
    keys = cuda_traverse.coherence_keys_cuda(od, dd, bvh)
    assert cuda_traverse.LAUNCHES["coherence_keys"] == before + 1
    want = coherence_keys32(torch.from_numpy(o), torch.from_numpy(d), box[0:3], box[3:6])
    assert keys.dtype == torch.int32 and torch.equal(keys.cpu(), want)
    k64 = coherence_keys(torch.from_numpy(o), torch.from_numpy(d), box[0:3], box[3:6])
    assert torch.equal(torch.argsort(keys, stable=True).cpu(), torch.argsort(k64, stable=True))


def test_k4_view_cache(dev, bunny):
    """The tree's view is built once per tree; `.to()` makes a new tree and
    a new view, and a tensor replaced in place is seen through its
    data_ptr."""
    bvh = dataclasses.replace(bunny.bvh4, tri=bunny.bvh4.tri.clone())
    v1 = cuda_traverse._view(bvh)
    assert cuda_traverse._view(bvh) is v1
    assert cuda_traverse._view(bvh.to(dev)) is not v1
    o, d, t_max, _ = _k4_rays(4096, 11, dev)
    want = cuda_traverse.trace_closest_plain(o, d, bvh, t_max)
    bvh.tri.set_(bvh.tri.clone())
    v2 = cuda_traverse._view(bvh)
    assert v2 is not v1 and v2.tri == bvh.tri.data_ptr() != v1.tri
    _same_record(cuda_traverse.trace_closest(o, d, bvh, t_max, sort=False), want)


def test_k3_k5_profile_width4(dev, bunny4):
    """On the 4-wide tree: K3 within the image tolerance of its plain
    version and at the preflight known answer; K5 ≡ K3 and K3-profile's
    rgb ≡ K3 bit for bit; K3-profile's cost and aux ≡ the plain version's."""
    cfg = RenderConfig(width=128, height=40, spp=2, max_bounces=12)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    k3 = cuda_megakernel.render_tiles_fused(bunny4, cam, cfg, 0, px, py, interleave=1)
    k5 = cuda_megakernel.render_tiles_fused(bunny4, cam, cfg, 0, px, py, interleave=2)
    rgb, cost, aux = cuda_megakernel.render_tiles_fused(bunny4, cam, cfg, 0, px, py, profile=True)
    p, p_cost, p_aux = cuda_megakernel.render_tiles_fused_plain(bunny4, cam, cfg, 0, px, py,
                                                                profile=True)
    assert torch.equal(k5, k3) and torch.equal(rgb, k3)
    assert torch.equal(cost, p_cost) and torch.equal(aux, p_aux)
    bad = (k3 - p).abs() > 5e-4 + 2e-4 * p.abs()
    assert bad.float().mean().item() < 0.005
    assert abs(k3.mean().item() - 0.276287317276001) <= 0.02 * 0.276287317276001


@pytest.mark.parametrize("case", ktf_probe.CASES)
def test_probe_ktf_case(dev, case):
    """csrc/probe_ktf.cu: each case against the script's expectation by the
    script's rules, and through the wrapper's fast path against its plain
    version on the card bit for bit (the unit vectors too): one launch a
    call, one [n_out, 8, 128] output returned as its rows."""
    before = ktf_probe.LAUNCHES["probe_ktf"]
    assert ktf_probe.run_case(case, dev, out=lambda line: None)["ok"]
    assert ktf_probe.LAUNCHES["probe_ktf"] == before + 1 + 10
    ins = tuple(torch.from_numpy(x).to(dev) for x in ktf_probe.inputs(case))
    k, p = ktf_probe.probe_ktf(case, *ins), ktf_probe.ktf_plain(case, *ins)
    assert ktf_probe.LAUNCHES["probe_ktf"] == before + 12
    assert len(k) == len(p) == ktf_probe.N_OUT[case]
    assert all(a.dtype == b.dtype and a.shape == b.shape == ktf_probe.TILE and _bitwise(a, b)
               for a, b in zip(k, p))
    assert all(a.untyped_storage().data_ptr() == k[0].untyped_storage().data_ptr() for a in k)
    with pytest.raises(ValueError, match="expected torch.int32"):
        ktf_probe.probe_ktf(case, ins[0].float(), *ins[1:])
    with pytest.raises(ValueError, match="expected shape"):
        ktf_probe.probe_ktf(case, ins[0][:4].contiguous(), *ins[1:])


@pytest.mark.parametrize("w", (None, *v6.ADMITTED_W))
def test_probe_v6_equals_plain(dev, w):
    """csrc/probe_v6.cu at every chain width (None: the one the wrapper
    picks) ≡ v6_plain bit for bit on all six outputs and the chains'
    iteration counts: 2 packets of the reference scene's 4-wide tree, at 12
    iterations and at the script's bound, at limits in (0.05, 0.6), and at
    stack_cap 12, where the stall guard and the clamps change the walk; 0
    local bytes; the rule against K4 holds."""
    bvh, node, tri, n_brute, cap, o, d, tlim = v6.reference_inputs(2)
    args = [t.to(dev) for t in (node, tri, o, d, tlim)]
    tl = torch.from_numpy(np.random.default_rng(6).uniform(
        0.05, 0.6, tuple(tlim.shape)).astype(np.float32))
    for iters, lim, stack in ((12, tlim, cap), (None, tlim, cap), (None, tl, cap),
                              (None, tlim, 12)):
        before = v6.LAUNCHES["probe_v6"]
        k = v6.v6(*args[:4], lim.to(dev), n_brute, stack, max_iters=iters, count=True, w=w)
        assert v6.LAUNCHES["probe_v6"] == before + 1
        p = v6.v6_plain(node, tri, o, d, lim, n_brute, stack, max_iters=iters, count=True)
        assert all(_bitwise(a, b) if a.is_floating_point() else torch.equal(a.cpu(), b)
                   for a, b in zip(k, p)), (iters, stack)
    regs, local = v6.kernel_resources(w or v6.chosen_w(2))
    assert regs > 0 and local == 0
    r = v6.run(2, dev, inputs=(bvh, node, tri, n_brute, cap, o, d, tlim), out=lambda line: None,
               w=w)
    assert sum(r["mismatches"][key] for key in ("t", "tri", "mat", "hit")) == 0


def test_probe_v6_refuses_unbuilt_widths(dev):
    """A chain width not built raises in the wrapper and is refused by the C
    entry point; the wrapper's pick is this card's."""
    import ctypes

    _, node, tri, n_brute, cap, o, d, tlim = v6.reference_inputs(1)
    node, tri, o, d, tlim = (t.to(dev) for t in (node, tri, o, d, tlim))
    out = torch.zeros((1, 8, 128), device=dev)
    it = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    r, b = ctypes.c_int(), ctypes.c_int()
    lib = cudalib.lib()
    for w in (0, 1, 3, 8):
        with pytest.raises(ValueError, match="chain width"):
            v6.v6(node, tri, o, d, tlim, n_brute, cap, w=w)
        assert lib.rt_probe_v6_w(node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(),
                                 tlim.data_ptr(), tri.shape[0] - 1, n_brute, cap, 4, 1, w,
                                 out.data_ptr(), out.data_ptr(), out.data_ptr(), out.data_ptr(),
                                 out.data_ptr(), out.data_ptr(), it.data_ptr(),
                                 cudalib.stream_handle()) != 0
        assert lib.rt_probe_v6_attrs_w(w, ctypes.byref(r), ctypes.byref(b)) != 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for packets in (1, 2, 128, 1056):
        assert v6.chosen_w(packets) == v6.chosen_w(packets, sms)


@pytest.mark.parametrize("case", mosaic.CASES)
def test_probe_mosaic_case(dev, case):
    """csrc/probe_mosaic.cu: each case passes the script's check, and equals
    its plain version on the card bit for bit."""
    before = mosaic.LAUNCHES["probe_mosaic"]
    assert mosaic.run_case(case, dev, out=lambda line: None)["ok"]
    assert mosaic.LAUNCHES["probe_mosaic"] == before + 1 + 10
    ins = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in mosaic.inputs(case))
    assert _bitwise(mosaic.probe_mosaic(case, *ins), mosaic.mosaic_plain(case, *ins))


@pytest.mark.parametrize("case", feature.CASES)
def test_probe_feature_stage(dev, case):
    """csrc/probe_feature.cu: each stage passes the script's check, and
    equals its plain version on the card bit for bit."""
    before = feature.LAUNCHES["probe_feature"]
    assert feature.run_case(case, dev, out=lambda line: None)["ok"]
    assert feature.LAUNCHES["probe_feature"] == before + 1 + 10
    ins = tuple(torch.from_numpy(a).to(dev) for a in feature.inputs(case))
    k, p = feature.probe_feature(case, *ins), feature.feature_plain(case, *ins)
    assert len(k) == len(p) and all(_bitwise(a, b) for a, b in zip(k, p))


def _tile_calls(dev, probe):
    """(name, the kernel's call, the plain version's call) of every P-mosaic
    case, P-feature stage or P-bitcast case (on the reference scene's v5
    tables) on its script's inputs on the card; each call returns a tuple
    of tensors."""
    mod = {"mosaic": mosaic, "feature": feature, "bitcast": bitcast}[probe]
    calls = []
    tabs = bitcast.reference_tables() if probe == "bitcast" else None
    for case in mod.CASES:
        if probe == "bitcast":
            ins = bitcast.case_input(case, tabs, dev)
            calls.append((case, lambda c=case, i=ins: bitcast.probe_bitcast(c, *i),
                          lambda c=case, i=ins: bitcast.bitcast_plain(c, *i)))
            continue
        ins = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in mod.inputs(case))
        if probe == "mosaic":
            calls.append((case, lambda c=case, i=ins: (mosaic.probe_mosaic(c, *i),),
                          lambda c=case, i=ins: (mosaic.mosaic_plain(c, *i),)))
        else:
            calls.append((case, lambda c=case, i=ins: feature.probe_feature(c, *i),
                          lambda c=case, i=ins: feature.feature_plain(c, *i)))
    return calls, mod.LAUNCHES


def test_stream_handle_follows_the_current_stream(dev):
    """cudalib.stream_handle is the current stream's handle on every call:
    the default stream, a side stream inside torch.cuda.stream, the default
    again after it, and the current card's inside device_scope."""
    assert cudalib.stream_handle() == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert cudalib.stream_handle() == side.cuda_stream
        assert side.cuda_stream != torch.cuda.default_stream().cuda_stream
    assert cudalib.stream_handle() == torch.cuda.current_stream().cuda_stream
    with cudalib.device_scope(dev):
        assert cudalib.stream_handle() == torch.cuda.current_stream(dev).cuda_stream


@pytest.mark.parametrize("probe", ["mosaic", "feature", "bitcast"])
def test_probe_tiles_on_a_side_stream(dev, probe):
    """Every case launched on a side torch.cuda.Stream, one launch counted
    each, equals its plain version bit for bit."""
    calls, launches = _tile_calls(dev, probe)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for name, kernel, plain in calls:
        before = launches[f"probe_{probe}"]
        with torch.cuda.stream(side):
            got = kernel()
        assert launches[f"probe_{probe}"] == before + 1, name
        torch.cuda.current_stream().wait_stream(side)
        want = plain()
        assert len(got) == len(want) and all(_bitwise(a, b) for a, b in zip(got, want)), name


@pytest.mark.parametrize("probe", ["mosaic", "feature", "bitcast"])
def test_probe_tiles_in_a_cuda_graph(dev, probe):
    """Every case captured once in a CUDA graph (one launch counted each,
    at capture; none at replay), its outputs overwritten, then replayed:
    the outputs equal the plain versions bit for bit, so each launch went
    to the capturing stream."""
    calls, launches = _tile_calls(dev, probe)
    warm = torch.cuda.Stream()
    warm.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(warm):
        for _, kernel, _ in calls:
            kernel()
    torch.cuda.current_stream().wait_stream(warm)
    graph = torch.cuda.CUDAGraph()
    before = launches[f"probe_{probe}"]
    with torch.cuda.graph(graph):
        outs = [kernel() for _, kernel, _ in calls]
    assert launches[f"probe_{probe}"] == before + len(calls)
    for out in outs:
        for t in out:
            t.fill_(-7)
    graph.replay()
    torch.cuda.synchronize()
    assert launches[f"probe_{probe}"] == before + len(calls)
    for (name, _, plain), got in zip(calls, outs):
        want = plain()
        assert len(got) == len(want) and all(_bitwise(a, b) for a, b in zip(got, want)), name


def test_probe_feature_s7_launches_k4(dev):
    before = cuda_traverse.LAUNCHES["trace_closest"]
    r = feature.run_case("s7", dev, out=lambda line: None)
    assert cuda_traverse.LAUNCHES["trace_closest"] == before + 1
    assert r["hit"] == feature.run_case("s7", "cpu", out=lambda line: None)["hit"]


@pytest.mark.parametrize("case", bitcast.CASES)
def test_probe_bitcast_case(dev, case):
    """csrc/probe_bitcast.cu ≡ its plain version bit for bit on the
    reference scene's v5 tables, with the same verdict (BAD but for p2)."""
    tabs = bitcast.reference_tables()
    tab, r0 = bitcast.case_input(case, tabs, dev)
    k = bitcast.probe_bitcast(case, tab, r0)
    p = bitcast.bitcast_plain(case, tab.cpu(), r0)
    assert len(k) == len(p) and all(torch.equal(a.cpu(), b) for a, b in zip(k, p))
    ok = bitcast.verdict(case, [t.cpu().numpy() for t in k], tabs)[0]
    assert ok == bitcast.verdict(case, [t.numpy() for t in p], tabs)[0] == (case == "p2")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def bitcast_tables():
    return bitcast.reference_tables()


@pytest.mark.parametrize("case", ["p3", "p4"])
def test_probe_bitcast_equals_its_library_call(dev, bitcast_tables, case):
    """p3 and p4 ≡ the library calls chip_smoke.py times them against
    (bitcast_library: the views taken inside the call, and made
    beforehand) bit for bit on the card."""
    tab, r0 = bitcast.case_input(case, bitcast_tables, dev)
    k = bitcast.probe_bitcast(case, tab, r0)
    for call in _chip_smoke().bitcast_library(case, tab, r0):
        lib = call()
        assert len(lib) == len(k)
        assert all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
                   for a, b in zip(k, lib))


@pytest.mark.parametrize("case", bitcast.CASES)
def test_probe_bitcast_fast_and_slow_paths(dev, bitcast_tables, monkeypatch, case):
    """The fast path and the wrapper's rules (_takes, reached when the fast
    path's signatures are made to match nothing) launch once each with the
    same outputs (p4's two the rows of one buffer); a table or x that
    starts one float into its buffer (not 16-byte aligned) raises and
    launches nothing, on either path."""
    tab, r0 = bitcast.case_input(case, bitcast_tables, dev)
    before = bitcast.LAUNCHES["probe_bitcast"]
    fast = bitcast.probe_bitcast(case, tab, r0)
    assert all(t.shape == bitcast.TILE and t.dtype == torch.int32 for t in fast)
    assert {t.untyped_storage().data_ptr() for t in fast} == {fast[0].untyped_storage().data_ptr()}
    buf = torch.empty(tab.numel() + 1, device=dev)
    buf[1:].copy_(tab.reshape(-1))
    shifted = buf[1:].view(tab.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    for slow in (False, True):
        if slow:
            monkeypatch.setattr(bitcast, "_X", None)
            monkeypatch.setattr(bitcast, "_TAB", None)
            got = bitcast.probe_bitcast(case, tab, r0)
            assert len(got) == len(fast) and all(torch.equal(a, b) for a, b in zip(got, fast))
        with pytest.raises(ValueError, match="16-byte aligned"):
            bitcast.probe_bitcast(case, shifted, r0)
    assert bitcast.LAUNCHES["probe_bitcast"] == before + 2


def test_probe_bitcast_resources(dev):
    """Every P-bitcast kernel takes registers and 0 local bytes."""
    res = bitcast.kernel_resources()
    assert set(res) == set(bitcast.CASES)
    assert all(regs > 0 and local == 0 for regs, local in res.values()), res


@pytest.fixture(scope="module")
def morph_inputs():
    return morph.reference_inputs(morph.N_PACKETS)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("variant", list(morph.VARIANTS))
def test_probe_morph_equals_plain(dev, morph_inputs, variant, w):
    """csrc/probe_morph.cuh at every chain width it admits (None: the one
    the wrapper picks) ≡ morph_plain bit for bit, the packets' loop
    counts included, at the script's 8 packets with the tree's stack bound,
    and on three of them at limits seeded in (0.001, 0.05) (chains the root
    test leaves at NONE, walks that end unevenly). A W the variant does not
    admit raises."""
    node, tri, n_brute, cap, o, d, tlim = morph_inputs
    tl = torch.from_numpy(np.random.default_rng(11).uniform(
        0.001, 0.05, (3, *tlim.shape[1:])).astype(np.float32))
    if w is not None and w not in morph.ADMITTED_W[variant]:
        with pytest.raises(ValueError, match="chain width"):
            morph.morph(*(t.to(dev) for t in (node, tri, o, d, tlim)), n_brute, cap, variant,
                        w=w)
        return
    before = morph.LAUNCHES["probe_morph"]
    for rays in ((o, d, tlim), (o[:3], d[:3], tl)):
        k = morph.morph(*(t.to(dev) for t in (node, tri, *rays)), n_brute, cap, variant, w=w)
        p = morph.morph_plain(node, tri, *rays, n_brute, cap, variant)
        assert len(k) == len(p) == morph.VARIANTS[variant][1] + 1
        assert all(_bitwise(a, b) if a.is_floating_point() else torch.equal(a.cpu(), b)
                   for a, b in zip(k, p))
    assert morph.LAUNCHES["probe_morph"] == before + 2


def test_probe_tile_and_morph_resources(dev):
    """Registers of every tile and morph kernel; 0 local bytes in every
    P-morph kernel at every chain width and every P-interleave kernel at
    every G and W."""
    res = [*mosaic.kernel_resources().values(), *feature.kernel_resources().values(),
           *bitcast.kernel_resources().values(), *morph.kernel_resources().values()]
    assert len(res) == 7 + 6 + 4 + 13 and all(r > 0 for r, _ in res)
    for v in morph.VARIANTS:
        for w in morph.ADMITTED_W[v]:
            r, local = morph.kernel_resources((v,), w)[v]
            assert r > 0 and local == 0, (v, w, r, local)
    for G in interleave_probe.GS:
        for w in interleave_probe.ADMITTED_W[G]:
            r, local = interleave_probe.kernel_resources((G,), {G: w})[G]
            assert r > 0 and local == 0, (G, w, r, local)


def test_probe_morph_interleave_pick_w_and_refusals(dev, morph_inputs):
    """The wrappers pick W from this card's SM count (P-morph; P-interleave
    from G alone); the C library builds a kernel at exactly the widths
    ADMITTED_W lists; a W not built raises in the wrapper and is refused by
    the C entry point."""
    import ctypes

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert common.sm_count() == common.sm_count(dev) == sms
    for packets in (1, 8, 64, 66, 67, 128, 264, 528, 1056):
        for v in morph.VARIANTS:
            assert morph.chosen_w(packets, v) == morph.chosen_w(packets, v, sms)
    assert [interleave_probe.chosen_w(G) for G in interleave_probe.GS] == [2, 4, 4, 4]
    r, b = ctypes.c_int(), ctypes.c_int()
    for w in common.CHAIN_WIDTHS:
        for i, v in enumerate(morph.VARIANTS):
            built = cudalib.lib().rt_probe_morph_attrs_w(i, w, ctypes.byref(r), ctypes.byref(b))
            assert (built == 0) == (w in morph.ADMITTED_W[v]), (v, w)
        for gi, G in enumerate(interleave_probe.GS):
            built = cudalib.lib().rt_probe_interleave_attrs_w(gi, w, ctypes.byref(r),
                                                              ctypes.byref(b))
            assert (built == 0) == (w in interleave_probe.ADMITTED_W[G]), (G, w)
    node, tri, n_brute, cap, o, d, tlim = (t.to(dev) if torch.is_tensor(t) else t
                                           for t in morph_inputs)
    out = torch.zeros((8, 8, 128), device=dev)
    pk = torch.zeros((8,), dtype=torch.int32, device=dev)
    lib = cudalib.lib()
    for w in (0, 3, 8):
        with pytest.raises(ValueError, match="chain width"):
            morph.morph(node, tri, o, d, tlim, n_brute, cap, "v1_while", w=w)
        assert lib.rt_probe_morph_w(node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(),
                                    tlim.data_ptr(), tri.shape[0] - 1, n_brute, cap, 4, 100, 8,
                                    1, w, out.data_ptr(), None, None, None, None, None,
                                    pk.data_ptr(), cudalib.stream_handle()) != 0
        assert lib.rt_probe_interleave_w(node.data_ptr(), tri.data_ptr(), o.data_ptr(),
                                         d.data_ptr(), tlim.data_ptr(), tri.shape[0] - 1, 4, 8, 0,
                                         w, out.data_ptr(), cudalib.stream_handle()) != 0
    assert lib.rt_probe_interleave_w(node.data_ptr(), tri.data_ptr(), o.data_ptr(), d.data_ptr(),
                                     tlim.data_ptr(), tri.shape[0] - 1, 4, 8, 3, 1,
                                     out.data_ptr(), cudalib.stream_handle()) != 0


@pytest.mark.parametrize("kernel_interleave", [1, 2])
def test_fused_two_shards_on_one_card(dev, bunny, kernel_interleave):
    """render_image_fused_sharded over ["cuda:0"] * 2: one K3 (or K5)
    launch per shard, the frame bit for bit render_image_fused's."""
    from raytracer_tpu_torch.parallel.sharding import make_mesh, render_image_fused_sharded

    cfg = RenderConfig(width=256, height=128, spp=2, max_bounces=8, rng_impl="ktf")
    cam = showcase_camera(cfg)
    want = render_image_fused(bunny, cam, cfg, 3, interleave=kernel_interleave)
    key = "render_fused" if kernel_interleave == 1 else "render_fused_g2"
    before = cuda_megakernel.LAUNCHES[key]
    got = render_image_fused_sharded(bunny, cam, cfg, 3, mesh=make_mesh([dev] * 2),
                                     kernel_interleave=kernel_interleave)
    assert cuda_megakernel.LAUNCHES[key] - before == 2
    assert torch.equal(got, want)
    assert got.mean().item() > 0.05


def test_rebalanced_wavefront_two_shards_on_one_card(dev, bunny):
    from raytracer_tpu_torch.parallel.sharding import (make_mesh, render_image_wavefront_rebalanced,
                                                       render_image_wavefront_sharded)

    cfg = RenderConfig(width=256, height=128, spp=2, max_bounces=8, rng_impl="ktf")
    cam = showcase_camera(cfg)
    want = render_image_wavefront(bunny, cam, cfg, 0)
    mesh = make_mesh([dev] * 2)
    got, iters = render_image_wavefront_rebalanced(bunny, cam, cfg, 0, mesh=mesh,
                                                   report_iters=True)
    assert torch.equal(got, want)
    assert iters.shape == (2,) and bool((iters >= 1).all())
    assert torch.equal(render_image_wavefront_sharded(bunny, cam, cfg, 0, mesh=mesh), want)


# ---- the sphere tree (scene/builder.build_sphere_tree) in K3, K5, K3-profile


@pytest.fixture(scope="module")
def rtiow(dev):
    """The RTIOW configuration's scene as the benchmark builds it
    (benchmark/program.scene), with its sphere tree, on the card."""
    from benchmark import manifest, program
    from raytracer_tpu_torch.scene.builder import build_sphere_tree

    sc, _ = program.scene(manifest.config("rtiow_final_1200"), manifest.ROOT, "cpu")
    return sc.replace(sphere_tree=build_sphere_tree(sc.spheres)).to(dev)


def _rtiow_view(width, height, spp, bounces):
    """RenderConfig and camera of the committed RTIOW configuration at a
    small size, with no roulette."""
    from benchmark import manifest, program

    cfg = RenderConfig(width=width, height=height, spp=spp, max_bounces=bounces,
                       min_bounces=bounces, reference_emission_quirk=False, rng_impl="ktf")
    return cfg, program.camera(manifest.config("rtiow_final_1200"), cfg)


def test_k3_sphere_tree_equals_the_sweep(dev, rtiow, monkeypatch):
    """K3 through the sphere tree gives K3's sweep over all 487 spheres bit
    for bit (the sweep route taken test-side, past the 16-sphere budget),
    and agrees with the plain version as K3 does."""
    cfg, cam = _rtiow_view(128, 40, 2, 50)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    before = cuda_megakernel.LAUNCHES["render_fused_tree"]
    tree = cuda_megakernel.render_tiles_fused(rtiow, cam, cfg, 5, px, py)
    assert cuda_megakernel.LAUNCHES["render_fused_tree"] == before + 1
    with pytest.raises(ValueError, match="sphere tree"):
        cuda_megakernel.render_tiles_fused(rtiow.replace(sphere_tree=None), cam, cfg, 5, px, py)
    monkeypatch.setattr(cuda_megakernel, "MAX_SPHERES", 10**6)
    sweep = cuda_megakernel.render_tiles_fused(rtiow.replace(sphere_tree=None), cam, cfg, 5,
                                               px, py)
    assert torch.equal(tree, sweep)
    p = cuda_megakernel.render_tiles_fused_plain(rtiow, cam, cfg, 5, px, py)
    bad = (tree - p).abs() > 5e-4 + 2e-4 * p.abs()
    assert bad.float().mean().item() < 0.005
    assert abs(tree.mean().item() - p.mean().item()) < 1e-3


@pytest.mark.parametrize("block", [64, 128, 256])
def test_k5_with_the_sphere_tree_equals_k3(dev, rtiow, block):
    cfg, cam = _rtiow_view(128, 40, 2, 50)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    k3 = cuda_megakernel.render_tiles_fused(rtiow, cam, cfg, 9, px, py, interleave=1)
    before = cuda_megakernel.LAUNCHES["render_fused_g2_tree"]
    k5 = cuda_megakernel.render_tiles_fused(rtiow, cam, cfg, 9, px, py, interleave=2, block=block)
    odd = cuda_megakernel.render_tiles_fused(rtiow, cam, cfg, 9, px[:1023], py[:1023],
                                             interleave=2, block=block)
    assert cuda_megakernel.LAUNCHES["render_fused_g2_tree"] == before + 2
    assert torch.equal(k5, k3) and torch.equal(odd, k3[:1023])


def test_k3_profile_with_the_sphere_tree(dev, rtiow):
    """K3-profile through the tree: its radiance is K3's bit for bit; its
    lane counts (K1 steps, path iterations, sphere-tree steps and tests)
    are the plain version's on every lane whose radiance is the plain
    version's to the bit (the lanes whose paths the two libraries' cos /
    sin did not part)."""
    cfg, cam = _rtiow_view(64, 16, 2, 50)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    k3 = cuda_megakernel.render_tiles_fused(rtiow, cam, cfg, 4, px, py)
    before = cuda_megakernel.LAUNCHES["render_fused_profile_tree"]
    rgb, cost, aux, *counts = cuda_megakernel.render_tiles_fused(
        rtiow, cam, cfg, 4, px, py, profile=True, lane_counts=True)
    assert cuda_megakernel.LAUNCHES["render_fused_profile_tree"] == before + 1
    assert torch.equal(rgb, k3) and len(counts) == 4
    cpu = rtiow.to("cpu")
    p_rgb, _, _, *p_counts = cuda_megakernel.render_tiles_fused_plain(
        cpu, cam, cfg, 4, px.cpu(), py.cpu(), profile=True, lane_counts=True)
    same = (rgb.cpu() == p_rgb).all(dim=1)
    assert same.float().mean().item() > 0.9
    for k, p in zip(counts, p_counts):
        assert torch.equal(k.cpu()[same], p[same])
    assert (counts[2] > 0).all() and (counts[3] > 0).any()


def test_fused_image_with_the_sphere_tree_and_its_launch(dev, rtiow):
    """render_image_fused of the scene: one launch of the tree's K3 a
    pass, none of the sweep's, and a finite image."""
    cfg, cam = _rtiow_view(160, 90, 4, 50)
    for key in cuda_megakernel.LAUNCHES:
        cuda_megakernel.LAUNCHES[key] = 0
    img = render_image_fused(rtiow, cam, cfg, 11)
    assert cuda_megakernel.LAUNCHES["render_fused_tree"] == 1
    assert cuda_megakernel.LAUNCHES["render_fused"] == 0
    assert img.shape == (90, 160, 3) and torch.isfinite(img).all()


def _ptxas_spills(fragment):
    """(registers, spill stores, spill loads) of the kernels whose mangled
    name holds `fragment`, from the library's ptxas report."""
    cudalib.lib()
    with open(cudalib.BUILD_INFO["path"] + ".ptxas.txt") as f:
        lines = f.read().splitlines()
    out, cur = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1] if fragment in ln else None
        elif cur and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out.setdefault(cur, [0, 0, 0])[1:] = nums[1:3]
        elif cur and "Used" in ln and "registers" in ln:
            out.setdefault(cur, [0, 0, 0])[0] = int(ln.split("Used")[1].split()[0])
    return out


def test_k3_resources_with_and_without_the_sphere_tree(dev):
    """K3's instantiation without the tree (every scene of at most 16
    spheres) keeps its 64 registers; the tree's K3 fits the same launch
    bounds and spills no more than it."""
    plain = cuda_megakernel.kernel_resources()
    tree = cuda_megakernel.kernel_resources(sphere_tree=True)
    assert set(tree) == {"K3", "K3-profile", "K5"}
    assert plain["K3"][0] == 64 and tree["K3"][0] <= 64
    (without,) = _ptxas_spills("fused_path_kernelILi8ELb0ELb0E").values()
    (with_tree,) = _ptxas_spills("fused_path_kernelILi8ELb0ELb1E").values()
    assert without[0] == 64 and with_tree[1] <= without[1] and with_tree[2] <= without[2]


TRAIN_GRAPH = dict(width=32, height=32, spp=4, max_bounces=6, rng_impl="ktf")


def test_train_step_graph_route_equals_the_eager_route(dev, monkeypatch):
    """make_train_step_accum on the card (one ChunkGraph: the first step
    warms up and captures, every chunk replays) against the same step
    with the graph left out, from the same params and Adam state over 3
    steps at 32², 2 pairs in chunks of 1, 4 spp, 6 bounces, the edge term
    on: the losses bit for bit, the gradients and params within the eager
    route's own run-to-run gap; one capture, steps x chunks replays, and
    a replayed step's spans."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.diff import inverse

    smoke = _chip_smoke()
    scene, cfg, cam, keys, targets, params = smoke.inverse_setup(dev, TRAIN_GRAPH, 2)
    assert cfg.edge_aware_lights
    kw = dict(chunk=1, lr=0.03, lr_fn=inverse.cosine_lr(0.03, 500, 0.05),
              lr_scales={"cam_position": 0.3, "cam_yaw": 2.0, "cam_pitch": 2.0})
    with monkeypatch.context() as m:
        m.setattr(inverse, "ChunkGraph", lambda *a: None)
        eager = [smoke._train_run(inverse.make_train_step_accum(
            scene, cam, cfg, targets, keys, **kw), params, 3) for _ in range(2)]
    before = dict(inverse.GRAPHS)
    step = inverse.make_train_step_accum(scene, cam, cfg, targets, keys, **kw)
    graph = smoke._train_run(step, params, 3)
    assert inverse.GRAPHS["graph_captures"] - before["graph_captures"] == 1
    assert inverse.GRAPHS["graph_replays"] - before["graph_replays"] == 3 * 2
    assert all(torch.equal(a, b) for a, b in zip(graph["losses"], eager[0]["losses"]))
    assert all(torch.isfinite(x).all() for x in graph["losses"])
    for key in ("grads", "params"):
        assert (smoke._max_gap(graph[key], eager[0][key])
                <= smoke._max_gap(eager[1][key], eager[0][key])), key
    with profile(activities=[ProfilerActivity.CPU]):
        step(graph["params"][-1], inverse.adam_init(params))
    names = [r.name for r in profiling.recorded()]
    assert names.count("rt.train.step") == 1 and names.count("rt.train.replay") == 2
    assert "rt.train.forward" not in names and "rt.train.backward" not in names
