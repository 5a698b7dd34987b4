"""raytracer_tpu_torch/io/checkpoint.py and viewer.py: resumable renders
equal the direct ones for each integrator, a checkpoint is resumed only
under its own header (size, sample total, key, RNG stream), and the npz
files are the JAX package's: the seed hash is JAX's, a render that JAX
wrote half of resumes in the port to JAX's image (within the image
tolerance: atol 2e-4, rtol 1e-4, at most one pixel beyond), and train
state round-trips between the packages."""

import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.io import checkpoint as jckpt
from raytracer_tpu.scene.builder import cornell_spheres_scene as jcornell_spheres
from raytracer_tpu_torch import viewer
from raytracer_tpu_torch.camera import make_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.io.checkpoint import (_atomic_save, _key_hash, load_train_state,
                                               render_image_resumable, save_train_state)
from raytracer_tpu_torch.models.fused import render_image_fused
from raytracer_tpu_torch.models.wavefront import render_image_wavefront
from raytracer_tpu_torch.render import iter_spp_accumulation, render_image
from raytracer_tpu_torch.scene.builder import cornell_materials_scene, cornell_spheres_scene

torch.set_num_threads(2)

INSIDE = dict(position=(0.0, 0.05, 0.29), pitch=-5.0)  # the showcase pose
DIRECT = {"wavefront": render_image_wavefront, "fused": render_image_fused,
          "megakernel": render_image}


@pytest.fixture(scope="module")
def materials():
    return cornell_materials_scene()


def _cfg(**kw):
    base = dict(width=16, height=8, spp=4, max_bounces=4, spp_per_pass=2, rng_impl="ktf")
    return RenderConfig(**{**base, **kw})


def _cam(cfg):
    return make_camera(aspect_ratio=cfg.aspect_ratio, **INSIDE)


@pytest.mark.parametrize("integrator", ["wavefront", "fused", "megakernel"])
def test_resumable_equals_direct(materials, tmp_path, integrator):
    cfg = _cfg()
    ckpt = str(tmp_path / "ck.npz")
    a = render_image_resumable(materials, _cam(cfg), cfg, 3, ckpt, integrator=integrator)
    direct = DIRECT[integrator](materials, _cam(cfg), cfg, 3)
    torch.testing.assert_close(a, direct, atol=2e-5, rtol=1e-5)
    with np.load(ckpt) as z:
        assert int(z["spp_done"]) == 4 and int(z["spp_total"]) == 4
        assert str(z["rng_stream"]) == "ktf" and int(z["seed_hash"]) == 3
    # A finished checkpoint resumes to the same image without rendering.
    again = render_image_resumable(materials, _cam(cfg), cfg, 3, ckpt, integrator=integrator)
    assert torch.equal(again, a)


@pytest.mark.parametrize("mismatch", ["rng_stream", "spp_total", "seed", "no_stream"])
def test_checkpoint_of_another_render_is_not_resumed(materials, tmp_path, mismatch):
    """A checkpoint whose header differs (or has no stream) is ignored:
    the render starts afresh and overwrites it."""
    cfg = _cfg()
    ckpt = str(tmp_path / "other.npz")
    header = dict(acc=np.full((8, 16, 3), 100.0, np.float32), spp_done=np.int64(2),
                  spp_total=np.int64(4), seed_hash=np.int64(3), rng_stream=np.str_("ktf"))
    if mismatch == "rng_stream":
        header["rng_stream"] = np.str_("jax")
    elif mismatch == "spp_total":
        header["spp_total"] = np.int64(8)
    elif mismatch == "seed":
        header["seed_hash"] = np.int64(4)
    else:
        del header["rng_stream"]
    _atomic_save(ckpt, **header)
    got = render_image_resumable(materials, _cam(cfg), cfg, 3, ckpt)
    torch.testing.assert_close(got, render_image_wavefront(materials, _cam(cfg), cfg, 3),
                               atol=2e-5, rtol=1e-5)
    with np.load(ckpt) as z:
        assert str(z["rng_stream"]) == "ktf" and int(z["seed_hash"]) == 3


def test_render_resumes_from_a_partial_checkpoint(materials, tmp_path, monkeypatch):
    cfg = _cfg()
    ckpt = str(tmp_path / "partial.npz")
    done, first = next(iter_spp_accumulation(materials, _cam(cfg), cfg, 9, spp_per_batch=2))
    assert done == 2
    _atomic_save(ckpt, acc=first.numpy(), spp_done=np.int64(2), spp_total=np.int64(4),
                 seed_hash=np.int64(9), rng_stream=np.str_("ktf"))
    seen = []
    import raytracer_tpu_torch.render as render_mod

    real = render_mod.iter_spp_accumulation

    def spy(*a, **kw):
        seen.append(kw["start_done"])
        return real(*a, **kw)

    monkeypatch.setattr(render_mod, "iter_spp_accumulation", spy)
    resumed = render_image_resumable(materials, _cam(cfg), cfg, 9, ckpt)
    assert seen == [2]
    torch.testing.assert_close(resumed, render_image_wavefront(materials, _cam(cfg), cfg, 9),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_seed_hash_is_jax_key_hash(seed):
    assert _key_hash(seed) == jckpt._key_hash(jax.random.key(seed))


class _Interrupted(Exception):
    pass


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """JAX writes the first of two batches and is interrupted; the port
    finishes the render from JAX's file, and the image is JAX's
    uninterrupted one."""
    kw = dict(width=16, height=8, spp=4, max_bounces=4, spp_per_pass=2)
    js = jcornell_spheres()
    jcam = jmake_camera(aspect_ratio=2.0)
    jcfg = JRenderConfig(**kw, drain_cascade=())
    key = jax.random.key(5)
    ckpt = str(tmp_path / "jax.npz")
    real_save = jckpt._atomic_save

    def save_then_stop(path, **arrays):
        real_save(path, **arrays)
        raise _Interrupted

    monkeypatch.setattr(jckpt, "_atomic_save", save_then_stop)
    with pytest.raises(_Interrupted):
        jckpt.render_image_resumable(js, jcam, jcfg, key, ckpt)
    monkeypatch.setattr(jckpt, "_atomic_save", real_save)
    with np.load(ckpt) as z:
        assert int(z["spp_done"]) == 2
    want = np.asarray(jckpt.render_image_resumable(js, jcam, jcfg, key,
                                                   str(tmp_path / "whole.npz")))
    got = render_image_resumable(scene_from_numpy(to_numpy_tree(js)),
                                 camera_from_numpy(to_numpy_tree(jcam)), RenderConfig(**kw), 5,
                                 ckpt)
    close = np.isclose(got.numpy(), want, atol=2e-4, rtol=1e-4).all(axis=-1)
    assert (~close).sum() <= 1, np.argwhere(~close)
    with np.load(ckpt) as z:
        assert int(z["spp_done"]) == 4


def test_progressive_render_writes_previews(tmp_path):
    scene = cornell_spheres_scene()
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=3)
    cam = make_camera(aspect_ratio=1.0)
    out = str(tmp_path / "prev.png")
    updates = []
    img = viewer.progressive_render(scene, cam, cfg, 0, out_path=out, spp_per_update=2,
                                    on_update=lambda d, p: updates.append(d))
    assert updates == [2, 4]
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    torch.testing.assert_close(img, render_image(scene, cam, cfg, 0), atol=2e-5, rtol=1e-5)


def test_serve_serves_the_page_and_the_preview(tmp_path):
    (tmp_path / "preview.png").write_bytes(b"\x89PNG\r\n\x1a\nx")
    srv = viewer.serve(str(tmp_path), port=0)
    try:
        base = f"http://localhost:{srv.server_address[1]}"
        page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "preview.png" in page and "<img" in page
        assert urllib.request.urlopen(base + "/preview.png", timeout=10).read()[:4] == b"\x89PNG"
    finally:
        srv.shutdown()
        srv.server_close()


def test_train_state_round_trips_between_the_packages(materials, tmp_path):
    from raytracer_tpu.diff import inverse as jinverse
    from raytracer_tpu_torch.diff import inverse

    params = inverse.init_params(materials, key=(torch.tensor(0, dtype=torch.int32),
                                                 torch.tensor(3, dtype=torch.int32)),
                                 noise=0.1)
    st = inverse.adam_init(params)
    st = st._replace(step=5, mu={k: v + 0.5 for k, v in st.mu.items()})
    path = str(tmp_path / "train.npz")
    save_train_state(path, params, st, extra={"loss": 0.25})
    p2, st2, extra = load_train_state(path)
    assert set(p2) == set(params) and st2.step == 5 and float(extra["loss"]) == 0.25
    for k in params:
        assert torch.equal(p2[k], params[k]) and torch.equal(st2.mu[k], st.mu[k])
        assert torch.equal(st2.nu[k], st.nu[k])
    # JAX reads the port's file, and the port reads JAX's.
    jp, jst, _ = jckpt.load_train_state(path)
    assert int(jst.step) == 5
    jpath = str(tmp_path / "jax_train.npz")
    jckpt.save_train_state(jpath, jp, jinverse.adam_init(jp))
    p3, st3, _ = load_train_state(jpath)
    assert st3.step == 0
    for k in params:
        np.testing.assert_array_equal(p3[k].numpy(), params[k].numpy())


def test_cli_checkpoint_resumes_to_the_uninterrupted_image(tmp_path, monkeypatch):
    """The CLI's --checkpoint starts after the checkpoint's samples (the
    spy sees start_done 2) and ends at the uninterrupted image."""
    from raytracer_tpu_torch import cli

    args = ["--device", "cpu", "--scene", "cornell_spheres", "--width", "16", "--height", "8",
            "--spp", "4", "--max-bounces", "3"]
    whole, half = tmp_path / "whole.npy", tmp_path / "half.npy"
    cli.main(args + ["--out", str(tmp_path / "w.png"), "--npy", str(whole)])
    ckpt = str(tmp_path / "cli.npz")
    cfg = RenderConfig(width=16, height=8, spp=4, max_bounces=3)
    from raytracer_tpu_torch.camera import showcase_camera

    done, first = next(iter_spp_accumulation(cornell_spheres_scene(), showcase_camera(cfg), cfg,
                                             0, spp_per_batch=2))
    _atomic_save(ckpt, acc=first.numpy(), spp_done=np.int64(done), spp_total=np.int64(4),
                 seed_hash=np.int64(0), rng_stream=np.str_("jax"))
    seen = []
    import raytracer_tpu_torch.render as render_mod

    real = render_mod.iter_spp_accumulation

    def spy(*a, **kw):
        seen.append(kw["start_done"])
        return real(*a, **kw)

    monkeypatch.setattr(render_mod, "iter_spp_accumulation", spy)
    cli.main(args + ["--checkpoint", ckpt, "--out", str(tmp_path / "r.png"), "--npy", str(half)])
    assert seen == [2]
    with np.load(ckpt) as z:
        assert int(z["spp_done"]) == 4
    np.testing.assert_allclose(np.load(half), np.load(whole), atol=2e-5, rtol=1e-5)


def test_cli_serve_writes_the_preview(tmp_path, monkeypatch):
    from raytracer_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    cli.main(["--device", "cpu", "--scene", "cornell_spheres", "--width", "8", "--height", "8",
              "--spp", "2", "--max-bounces", "2", "--serve", "0", "--out", "s.png"])
    assert os.path.getsize(tmp_path / "preview" / "preview.png") > 8
    assert (tmp_path / "s.png").read_bytes()[:4] == b"\x89PNG"
