"""Gradients of the differentiable renderer ≡ jax.grad of the JAX package.

The same scene, camera, key and loss (mean of the image) go through
both packages; the port differentiates with torch autograd. Material
and IOR gradients agree to 5e-4 relative, with an absolute floor of
1e-5 of each field's largest entry (the renders agree to 2e-7; the
backward sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.render import render_image as jrender_image
from raytracer_tpu.scene.builder import cornell_spheres_scene
from raytracer_tpu.scene.types import Materials as JMaterials
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.render import render_image
from raytracer_tpu_torch.scene.types import Materials

torch.set_num_threads(2)

FIELDS = ("albedo", "emission", "roughness", "ior")


def test_material_and_ior_grads_match_jax():
    """test_grad.py's material setup, framed so the glass sphere (IOR)
    and the rough metal are in view."""
    js = cornell_spheres_scene()
    kw = dict(width=12, height=12, spp=4, max_bounces=4)
    jcam = jmake_camera(aspect_ratio=1.0, fov_degrees=80.0, aperture=1e-6,
                        position=(0.0, 0.5, 1.6), pitch=-14.0)
    key = jax.random.key(11)

    def jloss(albedo, emission, roughness, ior):
        mats = JMaterials(type=js.materials.type, albedo=albedo, emission=emission,
                          roughness=roughness, ior=ior)
        return jnp.mean(jrender_image(js.replace(materials=mats), jcam, JRenderConfig(**kw), key))

    m = js.materials
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(m.albedo, m.emission, m.roughness, m.ior)

    ts = scene_from_numpy(to_numpy_tree(js))
    leaves = [getattr(ts.materials, f).clone().requires_grad_(True) for f in FIELDS]
    mats = Materials(ts.materials.type, *leaves)
    loss = render_image(ts.replace(materials=mats), camera_from_numpy(to_numpy_tree(jcam)),
                        RenderConfig(**kw), 11).mean()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(FIELDS, got, want):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-4, atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=name)
    assert np.abs(np.asarray(want[3])[4]) > 0  # the glass sphere's IOR matters
    assert np.abs(np.asarray(want[0])).max() > 0.01
