"""raytracer_tpu_torch.milestones ≡ the JAX calls of scripts/milestones.py
at reduced configs, its records and files, and raytracer_tpu_torch.flagship
writing only under renders/.

Configs 1 and 2 against the script's render_image_wavefront calls (JAX
with drain_cascade=(), one while_loop; the cascade is bitwise in both
packages) under the image tolerance (at most 0.5% of elements beyond
5e-4 + 2e-4|x|, means within 1e-3); config 4's losses within 2e-3
relative of the script's (the repo's training rule)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.diff import inverse as jinverse
from raytracer_tpu.models.wavefront import render_image_wavefront as jrender_wavefront
from raytracer_tpu.render import render_image as jrender_image
from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu_torch import flagship, milestones
from raytracer_tpu_torch.config import RenderConfig

torch.set_num_threads(2)

SMALL = dict(width=16, height=8, spp=4, max_bounces=4)
RECORD_KEYS = ["config", "size", "spp", "seconds", "mrays_per_sec", "mean_rgb", "finite",
               "card"]   # the script's keys, then whether finite and the card


def _jcam(cfg, showcase):
    kw = dict(aspect_ratio=cfg.aspect_ratio, fov_degrees=cfg.fov_degrees, aperture=cfg.aperture)
    if showcase:
        kw.update(position=(0.0, 0.05, 0.29), pitch=-5.0)
    return jmake_camera(**kw)


def _within_image_tolerance(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and want.mean() > 0.01
    assert (np.abs(got - want) > 5e-4 + 2e-4 * np.abs(want)).mean() <= 0.005
    assert abs(got.mean() - want.mean()) <= 1e-3


def test_config1_matches_the_script():
    jcfg = JRenderConfig(**SMALL, drain_cascade=())
    want = jrender_wavefront(jbuilder.cornell_spheres_scene(), _jcam(jcfg, False), jcfg,
                             jax.random.key(1))
    rec = milestones.cornell_spheres(RenderConfig(**SMALL), 1, "cpu")
    _within_image_tolerance(rec["image"].numpy(), want)
    assert rec["config"] == "1_cornell_spheres" and rec["card"] == "cpu" and rec["finite"]


def test_config2_matches_the_script():
    jcfg = JRenderConfig(**SMALL, drain_cascade=())
    js = jbuilder.cornell_materials_scene()
    js = js.replace(bvh4=jbuilder.build_scene_bvh4(js.mesh))
    want = jrender_wavefront(js, _jcam(jcfg, True), jcfg, jax.random.key(2))
    rec = milestones.cornell_materials(RenderConfig(**SMALL), 2, "cpu")
    _within_image_tolerance(rec["image"].numpy(), want)
    assert rec["size"] == [16, 8] and rec["spp"] == 4


def test_config4_losses_match_the_script():
    kw = dict(width=16, height=8, spp=2, max_bounces=2)
    jcfg = JRenderConfig(**kw)
    scene = jbuilder.cornell_spheres_scene()
    cam = _jcam(jcfg, False)
    target = jrender_image(scene, cam, jcfg, jax.random.key(40))
    params = jinverse.init_params(scene, fields=("albedo", "emission"),
                                  key=jax.random.key(41), noise=0.15)
    state = jinverse.adam_init(params)
    step = jinverse.make_train_step(scene, cam, jcfg, target, lr=0.03)
    want = []
    for i in range(3):
        params, state, loss = step(params, state, jax.random.key(100 + i))
        want.append(float(loss))
    rec = milestones.inverse_render(RenderConfig(**kw), 40, "cpu", steps=3)
    np.testing.assert_allclose(rec["losses"], want, rtol=2e-3)
    assert rec["loss_first"] == rec["losses"][0] and rec["loss_last"] == rec["losses"][-1]


def test_runner_records_and_files(tmp_path, monkeypatch):
    """main maps PRESETS and --quick's cuts as the script does; here the
    presets are cut to a few pixels so that all five run on the CPU."""
    tiny = {k: v.replace(width=16, height=8, max_bounces=3, spp_per_pass=4)
            for k, v in milestones.PRESETS.items()}
    monkeypatch.setattr(milestones, "PRESETS", tiny)
    monkeypatch.setattr(milestones, "INVERSE_QUICK_STEPS", 2)
    out = tmp_path / "renders"
    results = milestones.main(["--out", str(out), "--quick", "--device", "cpu"])
    assert [r["config"] for r in results] == ["1_cornell_spheres", "2_cornell_materials",
                                              "3_bunny_1080p", "4_inverse_render",
                                              "5_reference_2k"]
    assert [r["spp"] for r in results if "spp" in r] == [4, 8, 8, 8]
    for r in results:
        if r["config"] != "4_inverse_render":
            assert list(milestones.json_record(r)) == RECORD_KEYS
            assert r["finite"] and r["image"].shape == (8, 16, 3)
    inv = results[3]
    assert list(milestones.json_record(inv)) == ["config", "steps", "seconds", "loss_first",
                                                 "loss_last", "card"]
    assert inv["steps"] == 2 and len(inv["losses"]) == 2
    assert sorted(os.listdir(out)) == sorted([
        "1_cornell_spheres.png", "2_cornell_materials.png", "3_bunny_1080p.png",
        "4_inverse_losses.json", "5_reference_2k.png", "5_reference_2k.ckpt.npz",
        "milestones.json"])
    with open(out / "milestones.json") as f:
        saved = json.load(f)
    assert [s["config"] for s in saved] == [r["config"] for r in results]
    assert all("image" not in s and s["card"] == "cpu" for s in saved)


def test_runner_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        milestones.main(["--out", str(tmp_path), "--only", "1"])
    with pytest.raises(SystemExit, match="no CUDA card"):
        flagship.main([])


def test_flagship_writes_only_under_renders(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    guarded = [os.path.join(repo, "assets", "showcase_2k.png"),
               os.path.join(repo, "FLAGSHIP_r05.json")]
    before = [os.stat(p).st_mtime_ns for p in guarded if os.path.exists(p)]
    monkeypatch.setattr(flagship, "WIDTH", 32)
    monkeypatch.setattr(flagship, "HEIGHT", 16)
    stats = flagship.main(["2", "--device", "cpu"])
    assert os.listdir(tmp_path) == ["renders"]
    assert sorted(os.listdir(tmp_path / "renders")) == ["flagship.json", "flagship_2k.png",
                                                        "flagship_ckpt.npz"]
    assert [os.stat(p).st_mtime_ns for p in guarded if os.path.exists(p)] == before
    assert stats["spp"] == 2 and stats["card"] == "cpu" and stats["finite"]
    assert "platform" not in stats and stats["mean_rgb"] > 0.0
    with open(tmp_path / "renders" / "flagship.json") as f:
        assert json.load(f)["artifact"] == os.path.join("renders", "flagship_2k.png")
