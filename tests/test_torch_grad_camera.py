"""Camera gradients of the differentiable renderer ≡ jax.grad, and the
focus-distance repair they need.

make_camera once took the focus distance as a numpy norm of the
position, which raises on a position that requires grad (and on one on
the card). It now takes a torch norm there, as the JAX package falls
back to jnp.linalg.norm for a traced position, so d/d position flows
through the focus distance too. The setup is tests/test_grad.py's
test_camera_gradients_flow; d/d fov agrees to 1e-4 relative and
d/d position to 3e-3 relative (its three entries are ~5e-7, sums of
larger terms of both signs)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.render import render_image as jrender_image
from raytracer_tpu.scene.builder import cornell_spheres_scene
from raytracer_tpu_torch.camera import make_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.render import render_image

torch.set_num_threads(2)


def test_camera_gradients_flow_and_match_jax():
    js = cornell_spheres_scene()
    kw = dict(width=8, height=8, spp=2, max_bounces=3)

    def jloss(fov, position):
        cam = jmake_camera(aspect_ratio=1.0, fov_degrees=fov, aperture=1e-6, position=position)
        return jnp.mean(jrender_image(js, cam, JRenderConfig(**kw), jax.random.key(5)))

    jg_fov, jg_pos = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(80.0),
                                                     jnp.asarray([0.0, 4.0, 4.0]))

    fov = torch.tensor(80.0, requires_grad=True)
    pos = torch.tensor([0.0, 4.0, 4.0], requires_grad=True)
    cam = make_camera(aspect_ratio=1.0, fov_degrees=fov, aperture=1e-6, position=pos)
    assert cam.focus_dist.requires_grad  # the repaired path: a torch norm
    loss = render_image(scene_from_numpy(to_numpy_tree(js)), cam, RenderConfig(**kw), 5).mean()
    g_fov, g_pos = torch.autograd.grad(loss, [fov, pos])
    assert torch.isfinite(g_pos).all() and (g_pos.abs() > 0).any()
    np.testing.assert_allclose(float(g_fov), float(jg_fov), rtol=1e-4)
    np.testing.assert_allclose(g_pos.numpy(), np.asarray(jg_pos), rtol=3e-3)


def test_focus_distance_on_each_path():
    """A plain CPU position keeps the float32 numpy norm (bitwise the JAX
    package's host value); a position that requires grad takes the
    float32 torch norm, with its gradient (p - target) / |p - target|."""
    pos = (0.3, 4.0, 4.1)
    host = make_camera(aspect_ratio=1.0, position=pos, target=(0.1, 0.2, 0.0))
    want = float(np.linalg.norm(np.float32(pos) - np.float32([0.1, 0.2, 0.0])))
    assert float(host.focus_dist) == float(np.float32(want))
    assert not host.focus_dist.requires_grad
    p = torch.tensor(pos, requires_grad=True)
    cam = make_camera(aspect_ratio=1.0, position=p, target=(0.1, 0.2, 0.0))
    assert abs(float(cam.focus_dist.detach()) - want) <= 1e-6 * want
    (g,) = torch.autograd.grad(cam.focus_dist, p)
    d = np.float32(pos) - np.float32([0.1, 0.2, 0.0])
    np.testing.assert_allclose(g.numpy(), d / np.linalg.norm(d), rtol=1e-6)
