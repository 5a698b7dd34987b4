"""Autograd of the port's differentiable renderer ≡ central finite
differences, at tests/test_grad.py's settings (material :51-76, IOR
:151-171, camera :200-232): the same configs, keys, entries, steps and
tolerances. The hit decisions are detached, so with the same key a
small step keeps every path and autograd is the exact derivative of
the fixed-path estimator. Also: recomputing bounces in the backward
pass (more than 8 bounces) gives the gradients of keeping them."""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.camera import make_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models import megakernel
from raytracer_tpu_torch.render import render_image
from raytracer_tpu_torch.scene.builder import cornell_spheres_scene
from raytracer_tpu_torch.scene.types import Materials

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return cornell_spheres_scene()


def _material_loss(scene, cfg, cam, key, fields):
    def loss(*vals):
        kw = {f: getattr(scene.materials, f) for f in ("albedo", "emission", "roughness", "ior")}
        kw.update(zip(fields, vals))
        mats = Materials(type=scene.materials.type, **kw)
        return render_image(scene.replace(materials=mats), cam, cfg, key).mean()

    return loss


def _fd_check(loss, args, argi, idx, eps, rtol, atol=1e-5):
    leaves = [a.clone().requires_grad_(True) for a in args]
    (g,) = torch.autograd.grad(loss(*leaves), leaves[argi])
    g_ad = float(g[idx])
    with torch.no_grad():
        up = [a.clone() for a in args]
        up[argi][idx] += eps
        dn = [a.clone() for a in args]
        dn[argi][idx] -= eps
        g_fd = (float(loss(*up)) - float(loss(*dn))) / (2 * eps)
    assert np.isclose(g_ad, g_fd, rtol=rtol, atol=atol), (idx, g_ad, g_fd)
    return g_ad


@pytest.mark.parametrize("argi,idx", [(0, (0, 0)), (0, (2, 1)), (1, (5, 0))])
def test_material_grads_vs_finite_difference(scene, argi, idx):
    cfg = RenderConfig(width=12, height=12, spp=4, max_bounces=3)
    cam = make_camera(aspect_ratio=1.0, fov_degrees=cfg.fov_degrees, aperture=cfg.aperture)
    m = scene.materials
    loss = _material_loss(scene, cfg, cam, 17, ("albedo", "emission", "roughness"))
    _fd_check(loss, (m.albedo, m.emission, m.roughness), argi, idx, eps=1e-3, rtol=0.08)


def test_ior_grad_vs_finite_difference(scene):
    cfg = RenderConfig(width=12, height=12, spp=8, max_bounces=4)
    cam = make_camera(aspect_ratio=1.0, fov_degrees=cfg.fov_degrees, aperture=cfg.aperture,
                      position=(0.0, 0.5, 1.6), pitch=-14.0)
    loss = _material_loss(scene, cfg, cam, 11, ("ior",))
    g = _fd_check(loss, (scene.materials.ior,), 0, (4,), eps=2e-3, rtol=0.1)
    assert g != 0.0  # the glass sphere is visible: its IOR must matter


def test_camera_grads_vs_finite_difference(scene):
    """Straight down at the ground sphere: every pixel hits one smooth
    surface, so the camera gradient is the fixed-path one."""
    cfg = RenderConfig(width=12, height=12, spp=4, max_bounces=3)

    def loss(fov, position):
        cam = make_camera(aspect_ratio=1.0, fov_degrees=fov, aperture=cfg.aperture,
                          position=position, pitch=-85.0)
        return render_image(scene, cam, cfg, 29).mean()

    fov0 = torch.tensor(70.0)
    pos0 = torch.tensor([0.0, 1.0, 0.0])
    fov, pos = fov0.clone().requires_grad_(True), pos0.clone().requires_grad_(True)
    g_fov, g_pos = torch.autograd.grad(loss(fov, pos), [fov, pos])
    with torch.no_grad():
        eps = 5e-2
        fd_fov = (float(loss(fov0 + eps, pos0)) - float(loss(fov0 - eps, pos0))) / (2 * eps)
        assert np.isclose(float(g_fov), fd_fov, rtol=0.1, atol=1e-6), (float(g_fov), fd_fov)
        eps = 2e-3
        for axis in range(3):
            dp = torch.zeros(3)
            dp[axis] = eps
            fd = (float(loss(fov0, pos0 + dp)) - float(loss(fov0, pos0 - dp))) / (2 * eps)
            assert np.isclose(float(g_pos[axis]), fd, rtol=0.12, atol=2e-4), (
                axis, float(g_pos[axis]), fd)


def test_bounce_recompute_gives_the_same_gradients(scene, monkeypatch):
    cfg = RenderConfig(width=6, height=6, spp=2, max_bounces=9, reference_emission_quirk=False)
    cam = make_camera(aspect_ratio=1.0, position=(0.0, 0.5, 1.6), pitch=-14.0)
    loss = _material_loss(scene, cfg, cam, 3, ("albedo",))

    def grad():
        a = scene.materials.albedo.clone().requires_grad_(True)
        return torch.autograd.grad(loss(a), a)[0]

    remat = grad()  # 9 > 8 bounces: each bounce recomputed in the backward pass
    monkeypatch.setattr(megakernel, "CHECKPOINT_ABOVE_BOUNCES", 9)
    kept = grad()
    torch.testing.assert_close(remat, kept, rtol=1e-6, atol=1e-9)
    assert remat.abs().max() > 0
