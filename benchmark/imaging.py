"""What the image-rendering entries share: a closed loop of whole-frame
requests with one client, each request a new seed and synchronized; a
sample of each answer's pixels kept on the device, drawn from the run's
seed; after the window, the reference renders the sampled pixels of some
requests again and the share of values that differ decides `correct`.

An entry subclasses `ImageRunner` and gives `render(seed)`, the
program's call, returning linear f32[H, W, 3] (row 0 the top)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, program

MAX_REQUESTS = 4096   # sampled-pixel tables are drawn for this many requests


def request_seed(seed: int, i: int) -> int:
    """The render seed of request i: a base drawn from the run's seed, + i."""
    base = int(np.random.default_rng(seed).integers(0, 2**31 - 2 * MAX_REQUESTS))
    return base + i


class ImageRunner:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices: list, root: str):
        self.cfg, self.traffic, self.seed, self.root = cfg, traffic, seed, root
        self.device = devices[0]
        self.devices = devices
        self.w, self.h = cfg["resolution"]
        self.spp = traffic["spp_per_request"]
        self.answers: list = []

    # -- set-up -----------------------------------------------------------
    def setup(self) -> dict:
        lib_s = program.kernel_library(self.device)
        self.rcfg = program.render_config(self.cfg)
        self.cam = program.camera(self.cfg, self.rcfg)
        self.scene, scene_s = program.scene(self.cfg, self.root, self.device)
        self.draw_picks()
        return dict(scene_build_s=scene_s, kernel_lib_load_s=lib_s)

    def draw_picks(self) -> None:
        """Each request's sampled pixels (flat indices, row 0 the top),
        drawn from the run's seed."""
        p = self.traffic["check"]["pixels"]
        gen = np.random.default_rng([self.seed, 1])
        self.pick = torch.from_numpy(gen.integers(0, self.w * self.h, (MAX_REQUESTS, p))).to(
            self.device)

    def warmup(self) -> None:
        self.render(request_seed(self.seed, MAX_REQUESTS + 1))
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def render(self, seed: int) -> torch.Tensor:
        raise NotImplementedError

    # -- the window -------------------------------------------------------
    def request(self, i: int) -> int:
        """One request: a whole frame at the traffic's spp; its sampled
        pixels are kept. Returns the paths it traced."""
        if i >= MAX_REQUESTS:
            raise RuntimeError(f"more than {MAX_REQUESTS} requests in one window")
        img = self.render(request_seed(self.seed, i))
        self.answers.append(img.reshape(-1, 3)[self.pick[i]])
        self.sync()
        return self.w * self.h * self.spp

    # -- after the window -------------------------------------------------
    def free(self) -> None:
        self.answers = [a.cpu() for a in self.answers]
        self.scene = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked(self) -> list[int]:
        """The requests whose answers are compared, drawn from the seed."""
        n = len(self.answers)
        gen = np.random.default_rng([self.seed, 2])
        k = min(self.traffic["check"]["requests"], n)
        return sorted(gen.choice(n, size=k, replace=False).tolist())

    def reference(self, requests: list[int], dtype=torch.float32) -> torch.Tensor:
        """The reference's values of those requests' sampled pixels."""
        from benchmark.reference import forward
        from benchmark.reference.scene import Scene, camera_frame

        sc = Scene(self.cfg["scene"], self.root).to(self.device, dtype)
        frame = camera_frame(self.cfg["camera"], self.w / self.h)
        ref_cfg = check.reference_config(self.cfg)
        out = []
        for i in requests:
            flat = self.pick[i].to(self.device)
            px, py = flat % self.w, self.h - 1 - flat // self.w
            out.append(forward.render_pixels(sc, frame, ref_cfg, request_seed(self.seed, i),
                                             px, py, self.spp, dtype=dtype).cpu())
        return torch.cat(out)

    def check(self) -> list[dict]:
        chosen = self.checked()
        got = torch.cat([self.answers[i].cpu() for i in chosen])
        return [check.mismatch_share(got, self.reference(chosen), self.traffic["check"])]

    def control(self, dtype=torch.bfloat16) -> list[dict]:
        """The comparison with the reference computed in `dtype` in the
        program's place: a sound comparison has to fail it."""
        chosen = self.checked()
        return [check.mismatch_share(self.reference(chosen, dtype), self.reference(chosen),
                                     self.traffic["check"])]
