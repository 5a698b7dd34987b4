"""Entry `models/wavefront.render_image_wavefront`: one whole frame
through the wavefront integrator (kernel K4 once per iteration) per
request, at the traffic's spp."""

from benchmark.imaging import ImageRunner

KERNELS = {"k4": "trace_closest_kernel"}
FAULT_TARGET = ("raytracer_tpu_torch.models.wavefront", "render_image_wavefront")
FAULTS = ("half_samples", "answer_altered", "stale_answer")


class Runner(ImageRunner):
    def render(self, seed: int):
        from raytracer_tpu_torch.models import wavefront

        return wavefront.render_image_wavefront(self.scene, self.cam, self.rcfg, seed,
                                                spp=self.spp)
