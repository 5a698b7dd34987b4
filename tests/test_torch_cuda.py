"""raytracer_tpu_torch kernels ≡ their plain versions, on the card.

Marked `cuda`: these skip without an NVIDIA card (a CUDA kernel has no
CPU mode). On the machine with the card:
    python -m pytest -m cuda tests/test_torch_cuda.py -q
chip_smoke.py runs these checks on the reference scene at larger sizes:
K2 on 2^20 counters, K4 on 131,072 rays, and K3 on the preflight frame
and on 16,384 seeded pixels of the 2560x1440 spp 8 mb 20 main-path
frame."""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.camera import showcase_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.fused import render_image_fused
from raytracer_tpu_torch.ops import cuda_megakernel, cuda_traverse
from raytracer_tpu_torch.ops.bvh4 import BIG
from raytracer_tpu_torch.schedule import _tiled_pixel_grid
from raytracer_tpu_torch.scene.builder import cornell_materials_scene, reference_scene
from raytracer_tpu_torch.utils import ktf

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("block", [32, 128, 256])
def test_k3_matches_plain_and_launch_shape(dev, block):
    scene = cornell_materials_scene().to(dev)
    cfg = RenderConfig(width=128, height=32, spp=2, max_bounces=8)
    cam = showcase_camera(cfg)
    px, py, _ = (t.to(dev) for t in _tiled_pixel_grid(cfg))
    k = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px, py, block=block)
    ref = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 3, px, py, block=128)
    assert torch.equal(k, ref)
    p = cuda_megakernel.render_tiles_fused_plain(scene, cam, cfg, 3, px, py)
    bad = (k - p).abs() > 5e-4 + 2e-4 * p.abs()
    assert bad.float().mean().item() < 0.005
    assert abs(k.mean().item() - p.mean().item()) < 1e-3


def test_k3_preflight_known_answer(dev, bunny):
    cfg = RenderConfig(width=128, height=40, spp=2, max_bounces=12)
    img = render_image_fused(bunny, showcase_camera(cfg), cfg, 0)
    assert abs(img.mean().item() - 0.276287317276001) <= 0.02 * 0.276287317276001
