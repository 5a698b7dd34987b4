"""The edge-aware light term (cfg.edge_aware_lights) in the port ≡ the
JAX package (tests/test_grad.py:234-274).

The forward image is bitwise the same with the term on or off. Metal
roughness, which only moves detached scatter directions, gets its
gradient from the smoothed light boundary: it is non-zero on exactly
the metals where JAX's is, and agrees with jax.grad to 2e-3 relative
(the sigmoid and the backward sums round differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytracer_tpu.camera import make_camera as jmake_camera
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.render import render_image as jrender_image
from raytracer_tpu.scene.builder import build_scene_bvh4, cornell_materials_scene
from raytracer_tpu.scene.types import Materials as JMaterials
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import camera_from_numpy, scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.render import render_image
from raytracer_tpu_torch.scene.types import Materials

torch.set_num_threads(2)


def test_edge_aware_roughness_grad_matches_jax():
    js = cornell_materials_scene()
    js = js.replace(bvh4=build_scene_bvh4(js.mesh))
    kw = dict(width=16, height=16, spp=4, max_bounces=4, reference_emission_quirk=False,
              edge_aware_lights=True)
    jcam = jmake_camera(aspect_ratio=1.0, fov_degrees=80.0, aperture=1e-6,
                        position=(0.0, 0.05, 0.29), pitch=-5.0)

    def jloss(rough):
        m = js.materials
        mats = JMaterials(type=m.type, albedo=m.albedo, emission=m.emission, roughness=rough,
                          ior=m.ior)
        return jnp.mean(jrender_image(js.replace(materials=mats), jcam, JRenderConfig(**kw),
                                      jax.random.key(11)))

    want = np.asarray(jax.grad(jloss)(js.materials.roughness))

    ts = scene_from_numpy(to_numpy_tree(js))
    assert ts.light_rect is not None
    cam = camera_from_numpy(to_numpy_tree(jcam))
    cfg = RenderConfig(**kw)
    rough = ts.materials.roughness.clone().requires_grad_(True)
    m = ts.materials
    mats = Materials(type=m.type, albedo=m.albedo, emission=m.emission, roughness=rough,
                     ior=m.ior)
    img_on = render_image(ts.replace(materials=mats), cam, cfg, 11)
    (got,) = torch.autograd.grad(img_on.mean(), rough)
    got = got.numpy()

    img_off = render_image(ts, cam, cfg.replace(edge_aware_lights=False), 11)
    assert torch.equal(img_on.detach(), img_off)
    metals = np.nonzero(m.type.numpy() == 1)[0]
    assert np.abs(want[metals]).max() > 1e-5
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-9)
