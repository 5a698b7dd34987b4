"""Entry `models/fused.render_image_fused` on a scene of spheres alone with
its sphere tree: one whole frame through the fused path loop (kernel K3,
the spheres found through the tree) per request, at the traffic's spp.
Set-up builds the scene from the configuration through the program's
loader (benchmark/program.scene), then the sphere tree
(scene/builder.build_sphere_tree), timed on its own; the reference is
benchmark/reference/spheres.py, every sphere tested by every ray."""

import time

import torch

from benchmark import check, program
from benchmark.imaging import ImageRunner, request_seed

KERNELS = {"k3": "fused_path_kernel"}
FAULT_TARGET = ("raytracer_tpu_torch.models.fused", "render_image_fused")
FAULTS = ("half_samples", "answer_altered", "stale_answer")


class Runner(ImageRunner):
    def setup(self) -> dict:
        # A program without the sphere tree fails here, before any build.
        from raytracer_tpu_torch.scene.builder import build_sphere_tree

        lib_s = program.kernel_library(self.device)
        self.rcfg = program.render_config(self.cfg)
        self.cam = program.camera(self.cfg, self.rcfg)
        scene, scene_s = program.scene(self.cfg, self.root, self.device)
        t0 = time.perf_counter()
        self.scene = scene.replace(sphere_tree=build_sphere_tree(scene.spheres).to(self.device))
        self.sync()
        tree_s = time.perf_counter() - t0
        self.draw_picks()
        return dict(scene_build_s=scene_s, sphere_tree_build_s=tree_s, kernel_lib_load_s=lib_s)

    def render(self, seed: int):
        from raytracer_tpu_torch.models import fused

        return fused.render_image_fused(self.scene, self.cam, self.rcfg, seed, spp=self.spp)

    def reference(self, requests: list[int], dtype=torch.float32) -> torch.Tensor:
        from benchmark.reference import spheres
        from benchmark.reference.scene import camera_frame

        sc = spheres.SphereScene(self.cfg["scene"]).to(self.device, dtype)
        frame = camera_frame(self.cfg["camera"], self.w / self.h)
        ref_cfg = check.reference_config(self.cfg)
        out = []
        for i in requests:
            flat = self.pick[i].to(self.device)
            px, py = flat % self.w, self.h - 1 - flat // self.w
            out.append(spheres.render_pixels(sc, frame, ref_cfg, request_seed(self.seed, i),
                                             px, py, self.spp, dtype=dtype).cpu())
        return torch.cat(out)
