"""The plain reference against the program's plain paths on the CPU at a
tiny size: the same paths with the same draws give the same pixels, and
the same loss, gradients and Adam steps. (This test may import both; the
reference imports nothing of the program.)"""

import numpy as np
import pytest
import torch

from benchmark import check, manifest, program
from benchmark.entries import train_accum
from benchmark.reference import forward, ktf, objload
from benchmark.reference.scene import Scene, camera_frame

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def bunny():
    cfg = manifest.config("cornell_bunny_2k")
    cfg["resolution"] = [48, 27]
    rcfg = program.render_config(cfg)
    sc, _ = program.scene(cfg, manifest.ROOT, "cpu")
    return cfg, rcfg, program.camera(cfg, rcfg), sc


def reference_image(cfg, spp, dtype=torch.float32):
    w, h = cfg["resolution"]
    flat = torch.arange(w * h)
    sc = Scene(cfg["scene"], manifest.ROOT).to("cpu", dtype)
    return forward.render_pixels(sc, camera_frame(cfg["camera"], w / h),
                                 check.reference_config(cfg), SEED, flat % w,
                                 h - 1 - flat // w, spp, dtype=dtype)


def test_loader_matches_the_programs():
    from raytracer_tpu_torch.scene.obj_io import load_scene_objs

    cfg = manifest.config("cornell_bunny_2k")
    paths = [f"{manifest.ROOT}/{p}" for p in cfg["scene"]["objs"]]
    v, f, m, mats = objload.load(paths)
    mesh, pm = load_scene_objs(paths)
    assert np.array_equal(v, mesh.vertices.numpy())
    assert np.array_equal(f, mesh.faces.numpy())
    assert np.array_equal(m, mesh.face_mat.numpy())
    assert [x[0] for x in mats] == pm.type.tolist()
    assert np.array_equal(np.asarray([x[1] for x in mats], np.float32), pm.albedo.numpy())


def test_threefry_matches_the_programs():
    from raytracer_tpu_torch.utils import ktf as pk

    c0 = torch.arange(-5000, 5000, 7, dtype=torch.int32)
    c1 = (c0 * 31) ^ 0x5A5A
    for k0, k1 in ((0, 12345), (-7, 2**31 - 1), (123456789, -987654321)):
        a0, a1 = pk.threefry2x32(k0, k1, c0, c1)
        b0, b1 = ktf.threefry(k0, k1, c0, c1)
        assert torch.equal(a0.long() & ktf.M32, b0) and torch.equal(a1.long() & ktf.M32, b1)


def test_fused_frame_equals_the_reference(bunny):
    cfg, rcfg, cam, sc = bunny
    from raytracer_tpu_torch.models import fused

    got = fused.render_image_fused(sc, cam, rcfg, SEED, spp=8).reshape(-1, 3)
    want = reference_image(cfg, 8)
    # The plain path loop and the reference round alike: equal to the bit.
    assert torch.equal(got, want)


def test_wavefront_frame_agrees_with_the_reference(bunny):
    cfg, rcfg, cam, sc = bunny
    from raytracer_tpu_torch.models import wavefront

    got = wavefront.render_image_wavefront(sc, cam, rcfg, SEED, spp=8).reshape(-1, 3)
    share = check.mismatch_share(got, reference_image(cfg, 8),
                                 dict(atol=1e-5, rtol=1e-3, limit=0.0))["value"]
    assert share <= 0.002


def test_bfloat16_reference_fails_the_comparison(bunny):
    cfg = bunny[0]
    spec = manifest.traffic("fused_hq")["check"]
    share = check.mismatch_share(reference_image(cfg, 8, torch.bfloat16), reference_image(cfg, 8),
                                 spec)
    assert share["value"] > share["limit"]


def test_training_steps_equal_the_reference():
    cfg = manifest.config("inverse_materials_256")
    cfg.update(resolution=[16, 16], spp=2, max_bounces=4)
    cfg["job"] = dict(cfg["job"], pairs=2, chunk=1)
    traffic = manifest.traffic("train_accum")
    runner = train_accum.Runner(cfg, traffic, 77, [torch.device("cpu")], manifest.ROOT)
    runner.setup()
    runner.warmup()
    ref = runner.reference()
    assert np.allclose(runner.losses, ref["losses"], rtol=1e-5, atol=0)
    for k in ref["grad1"]:
        assert runner.grad1[k] == pytest.approx(ref["grad1"][k], rel=1e-4, abs=1e-9), k
        assert runner.change[k] == pytest.approx(ref["change"][k], rel=1e-4, abs=1e-9), k


def test_bfloat16_training_reference_fails_the_comparison():
    cfg = manifest.config("inverse_materials_256")
    cfg.update(resolution=[16, 16], spp=2, max_bounces=4)
    cfg["job"] = dict(cfg["job"], pairs=2, chunk=1)
    traffic = manifest.traffic("train_accum")
    runner = train_accum.Runner(cfg, traffic, 78, [torch.device("cpu")], manifest.ROOT)
    checks = runner.control()
    assert any(c["value"] > c["limit"] for c in checks), checks
