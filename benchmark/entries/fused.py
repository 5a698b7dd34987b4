"""Entry `models/fused.render_image_fused`: one whole frame through the
fused path loop (kernel K3) per request, at the traffic's spp."""

from benchmark.imaging import ImageRunner

KERNELS = {"k3": "fused_path_kernel"}
FAULT_TARGET = ("raytracer_tpu_torch.models.fused", "render_image_fused")
FAULTS = ("half_samples", "answer_altered", "stale_answer")


class Runner(ImageRunner):
    def render(self, seed: int):
        from raytracer_tpu_torch.models import fused

        return fused.render_image_fused(self.scene, self.cam, self.rcfg, seed, spp=self.spp)
