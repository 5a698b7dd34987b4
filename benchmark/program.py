"""The system under test, raytracer_tpu_torch, set up from a
configuration file: its scene (its OBJ loader, its tree builder), its
camera and its render configuration. The entries drive it from here;
nothing in benchmark/reference imports this module or the program."""

from __future__ import annotations

import os
import time

import numpy as np
import torch


def render_config(cfg: dict):
    from raytracer_tpu_torch.config import RenderConfig

    w, h = cfg["resolution"]
    kw = dict(width=w, height=h, spp=cfg["spp"], spp_per_pass=cfg["spp_per_pass"],
              max_bounces=cfg["max_bounces"], min_bounces=cfg["min_bounces"],
              rr_max_prob=cfg["rr_max_prob"], t_min=cfg["t_min"],
              fov_degrees=cfg["camera"]["fov_degrees"], aperture=cfg["camera"]["aperture"],
              reference_emission_quirk=cfg["emission_quirk"], rng_impl=cfg["rng"],
              edge_aware_lights=cfg.get("edge_aware_lights", False),
              edge_bandwidth=cfg.get("edge_bandwidth", 0.15))
    return RenderConfig(**kw)


def camera(cfg: dict, rcfg):
    """The program's camera of the configuration, on the CPU."""
    from raytracer_tpu_torch.camera import make_camera

    c = cfg["camera"]
    return make_camera(aspect_ratio=rcfg.aspect_ratio, fov_degrees=c["fov_degrees"],
                       aperture=c["aperture"], position=tuple(c["position"]),
                       target=tuple(c.get("target", (0.0, 0.0, 0.0))),
                       world_up=tuple(c.get("world_up", (0.0, 1.0, 0.0))),
                       yaw=c["yaw"], pitch=c["pitch"])


def scene(cfg: dict, root: str, device):
    """(scene on `device`, seconds): the program's OBJ loader over the
    configuration's files, the appended materials and spheres, the
    emitter's rectangle and the tree, then `.to(device)`, synchronized."""
    from raytracer_tpu_torch.scene import builder
    from raytracer_tpu_torch.scene.obj_io import load_scene_objs
    from raytracer_tpu_torch.scene.types import Materials, Scene, Spheres

    t0 = time.perf_counter()
    spec = cfg["scene"]
    mesh, mats = load_scene_objs([os.path.join(root, p) for p in spec["objs"]])
    extra = spec["materials"]
    m = mats.count
    materials = Materials.from_lists(
        types=np.concatenate([mats.type.numpy(), [e["type"] for e in extra]]),
        albedos=np.concatenate([mats.albedo.numpy(),
                                np.asarray([e["albedo"] for e in extra], np.float32)]),
        emissions=np.concatenate([mats.emission.numpy(), np.asarray(
            [e.get("emission", (0.0, 0.0, 0.0)) for e in extra], np.float32)]),
        roughnesses=np.concatenate([mats.roughness.numpy(), np.asarray(
            [e.get("roughness", 0.0) for e in extra], np.float32)]),
        iors=np.concatenate([mats.ior.numpy(),
                             np.asarray([e.get("ior", 1.0) for e in extra], np.float32)]))
    sph = spec["spheres"]
    spheres = Spheres.from_lists(centers=[s["center"] for s in sph],
                                 radii=[s["radius"] for s in sph],
                                 mat_ids=[m + s["material"] for s in sph])
    with builder.tree_width(cfg["bvh_width"]):
        tree = builder.build_scene_bvh4(mesh)
    sc = Scene(materials=materials, spheres=spheres, mesh=mesh, bvh4=tree, name=cfg["name"],
               light_rect=builder.fit_light_rect(mesh, materials)).to(device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return sc, time.perf_counter() - t0


def kernel_library(device) -> float:
    """Seconds to load the program's kernel library (to build it, in a
    checkout that has none yet); 0 on the CPU, where no kernel runs."""
    if torch.device(device).type != "cuda":
        return 0.0
    from raytracer_tpu_torch.utils import cudalib

    t0 = time.perf_counter()
    cudalib.lib()
    return time.perf_counter() - t0

