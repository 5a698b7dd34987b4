"""Shared set-up of the port-vs-JAX fused path-loop tests: one scene
(the JAX builder's cornell_materials with its native BVH8, as the JAX
CLI builds it) handed to both packages through convert.py, and one
frame rendered by each — the JAX fused Pallas kernel in interpret mode
and the port's plain path loop on the CPU."""

import jax
import numpy as np

from raytracer_tpu.camera import showcase_camera as jshowcase
from raytracer_tpu.config import RenderConfig as JRenderConfig
from raytracer_tpu.models.fused import render_image_fused as jrender_fused
from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu_torch.camera import showcase_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.convert import scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.models.fused import render_image_fused


def materials_scenes():
    js = jbuilder.cornell_materials_scene("assets/models")
    js = js.replace(bvh4=jbuilder.build_scene_bvh4(js.mesh))
    return js, scene_from_numpy(to_numpy_tree(js))


def render_pair(scenes, seed, **cfg_kw):
    """(port image, JAX image), both linear f32[H,W,3] numpy."""
    js, ts = scenes
    jcfg = JRenderConfig(rng_impl="ktf", **cfg_kw)
    cfg = RenderConfig(rng_impl="ktf", **cfg_kw)
    ref = np.asarray(jrender_fused(js, jshowcase(jcfg), jcfg, jax.random.key(seed),
                                   interpret=True))
    out = render_image_fused(ts, showcase_camera(cfg), cfg, seed).numpy()
    assert out.shape == ref.shape == (cfg.height, cfg.width, 3)
    assert np.isfinite(out).all()
    return out, ref
