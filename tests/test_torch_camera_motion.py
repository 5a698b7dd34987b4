"""raytracer_tpu_torch/camera_motion.py ≡ raytracer_tpu/camera_motion.py
on seeded poses and motions (atol 1e-6), and the reference's controls."""

import numpy as np
import pytest
import torch

from raytracer_tpu import camera_motion as jmotion
from raytracer_tpu.camera import camera_basis as jcamera_basis
from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu_torch import camera_motion as motion
from raytracer_tpu_torch.camera import camera_basis, make_camera

FIELDS = ("position", "yaw", "pitch", "world_up", "fov_degrees", "aperture", "focus_dist")


def _pose(seed):
    rs = np.random.default_rng(seed)
    kw = dict(aspect_ratio=float(rs.uniform(0.5, 2.0)),
              fov_degrees=float(rs.uniform(30, 100)),
              position=tuple(float(x) for x in rs.uniform(-3, 3, 3)),
              yaw=float(rs.uniform(-180, 180)), pitch=float(rs.uniform(-80, 80)),
              focus_dist=float(rs.uniform(0.5, 5.0)))
    return make_camera(**kw), jmake_camera(**kw), rs


def _same(cam, jcam):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    b, jb = camera_basis(cam), jcamera_basis(jcam)
    for k in b:
        np.testing.assert_allclose(b[k].numpy(), np.asarray(jb[k]), atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_motion_sequence_equals_jax(seed):
    cam, jcam, rs = _pose(seed)
    for step in range(12):
        keys = "".join(k for k in "wsadc " if rs.uniform() < 0.4)
        dt = float(rs.uniform(0.0, 0.2))
        cam, jcam = motion.move(cam, keys, dt), jmotion.move(jcam, keys, dt)
        dx, dy = (float(v) for v in rs.normal(scale=40.0, size=2))
        cam, jcam = motion.rotate(cam, dx, dy), jmotion.rotate(jcam, dx, dy)
        if step % 4 == 0:
            delta = float(rs.uniform(-1.0, 1.0))
            cam, jcam = motion.adjust_focus(cam, delta), jmotion.adjust_focus(jcam, delta)
        _same(cam, jcam)
    assert cam.yaw.dtype == cam.pitch.dtype == cam.focus_dist.dtype == torch.float32


def test_reference_controls():
    cam = make_camera(aspect_ratio=1.0)   # front (0, 0, 1), right (-1, 0, 0)
    np.testing.assert_allclose(motion.move(cam, "w", dt=2.0).position.numpy(), [0, 4, 2],
                               atol=1e-5)
    np.testing.assert_allclose(motion.move(cam, "d", dt=1.0).position.numpy(), [-1, 4, 4],
                               atol=1e-5)
    assert float(motion.rotate(cam, 10.0, 0.0).yaw) == pytest.approx(-92.0)
    assert float(motion.rotate(cam, 0.0, -1000.0).pitch) == 89.0
    assert float(motion.adjust_focus(cam, -100.0).focus_dist) == pytest.approx(0.1)


def test_mouse_smoother_equals_jax():
    rs = np.random.default_rng(4)
    sm, jsm = motion.MouseSmoother(), jmotion.MouseSmoother()
    for i, (x, y) in enumerate(rs.uniform(0, 500, (40, 2))):
        if i == 20:
            sm.release()
            jsm.release()
        assert sm.update(float(x), float(y)) == jsm.update(float(x), float(y))
    assert motion.MouseSmoother().update(3.0, 4.0) == (0.0, 0.0)
