"""Entry `diff/inverse.make_train_step_accum`: a closed loop of Adam
steps of an inverse-rendering job, each read back through its loss.

Set-up builds the one training step (its scene, targets, keys and Adam
state) and drives it through the job's first `checked_steps` steps: the
warm-up, whose losses, first gradient (from Adam's first moment after
step 1) and change of the parameters are kept for the check. The window
goes on with the same step on the same state. After the window the
reference (benchmark/reference/diff) runs those first steps again from
the same inputs: the pair keys and the initial parameters, which the
benchmark draws from the seed and hands to both."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check, program

KERNELS = {"k4": "trace_closest_kernel"}
FAULT_TARGET = ("raytracer_tpu_torch.diff.inverse", "make_train_step_accum")
FAULTS = ("state_unchanged", "half_the_pairs", "loss_altered", "lr_scales_ignored")


def inputs(cfg: dict, seed: int, root: str):
    """(pair keys (k0, k1) as int32 arrays, initial parameters as float32
    arrays): the truth of the benchmark's own scene, noised and folded
    into each field's domain, and the camera perturbed."""
    from benchmark.reference.scene import Scene

    job = cfg["job"]
    gen = np.random.default_rng([seed, 3])
    keys = gen.integers(-2**31, 2**31, (2, job["pairs"])).astype(np.int32)
    sc = Scene(cfg["scene"], root)
    truth = dict(albedo=sc.np_albedo, roughness=sc.np_rough, emission=sc.np_emission,
                 ior=sc.np_ior)
    init = {}
    for k in sorted(truth):
        x = truth[k] + np.float32(job["init_noise"]) * gen.standard_normal(
            truth[k].shape).astype(np.float32)
        lo, hi = {"albedo": (0.0, 1.0), "roughness": (0.0, 1.0), "emission": (0.0, None),
                  "ior": (1.0, 3.0)}[k]
        x = np.float32(lo) + np.abs(x - np.float32(lo))
        init[k] = (x if hi is None else np.minimum(x, np.float32(hi))).astype(np.float32)
    cam, pert = cfg["camera"], job["cam_perturb"]
    init["cam_position"] = (np.asarray(cam["position"], np.float32)
                            + np.asarray(pert["cam_position"], np.float32))
    init["cam_yaw"] = np.asarray(np.float32(cam["yaw"]) + np.float32(pert["cam_yaw"]))
    init["cam_pitch"] = np.asarray(np.float32(cam["pitch"]) + np.float32(pert["cam_pitch"]))
    truth.update(cam_position=np.asarray(cam["position"], np.float32),
                 cam_yaw=np.asarray(np.float32(cam["yaw"])),
                 cam_pitch=np.asarray(np.float32(cam["pitch"])))
    return keys, init, truth


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


class Runner:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices: list, root: str):
        self.cfg, self.traffic, self.seed, self.root = cfg, traffic, seed, root
        self.device = devices[0]
        self.job = cfg["job"]

    def setup(self) -> dict:
        from raytracer_tpu_torch.diff import inverse
        from raytracer_tpu_torch.render import render_image

        lib_s = program.kernel_library(self.device)
        rcfg = program.render_config(self.cfg)
        cam = program.camera(self.cfg, rcfg)
        scene, scene_s = program.scene(self.cfg, self.root, self.device)
        keys, init, _ = inputs(self.cfg, self.seed, self.root)
        dev = self.device
        k0, k1 = (torch.from_numpy(keys[0]).to(dev), torch.from_numpy(keys[1]).to(dev))
        with torch.no_grad():
            cam_d = cam.to(dev)
            targets = torch.stack([render_image(scene, cam_d, rcfg, (k0[j], k1[j]))
                                   for j in range(keys.shape[1])])
        job = self.job
        self.step = inverse.make_train_step_accum(
            scene, cam, rcfg, targets, (k0, k1), chunk=job["chunk"], lr=job["lr"],
            lr_fn=inverse.cosine_lr(job["lr"], job["lr_schedule_steps"], job["lr_min_frac"]),
            lr_scales=job["lr_scales"])
        self.params = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in init.items()}
        self.state = inverse.adam_init(self.params)
        return dict(scene_build_s=scene_s, kernel_lib_load_s=lib_s)

    def _step(self) -> float:
        self.params, self.state, loss = self.step(self.params, self.state)
        return float(loss)

    def warmup(self) -> None:
        start = {k: v.clone() for k, v in self.params.items()}
        self.losses = []
        for n in range(self.traffic["checked_steps"]):
            self.losses.append(self._step())
            if n == 0:
                self.grad1 = norms({k: m / 0.1 for k, m in self.state.mu.items()})
        self.change = norms({k: self.params[k] - start[k] for k in start})

    def request(self, i: int) -> int:
        self._step()
        return 1

    def free(self) -> None:
        self.step = self.params = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32, trace_steps: bool = False) -> dict:
        """The reference's losses, first-gradient norms and change norms
        over the checked steps, from the same inputs; with `trace_steps`
        also each step's gradients and parameters."""
        from benchmark.reference import diff
        from benchmark.reference.scene import Scene

        keys, init, truth = inputs(self.cfg, self.seed, self.root)
        dev = self.device
        sc = Scene(self.cfg["scene"], self.root).to(dev, dtype)
        ref_cfg = check.reference_config(self.cfg)
        prob = diff.Problem(sc, self.cfg["camera"], ref_cfg, keys.tolist())

        def tens(d):
            return {k: torch.from_numpy(np.array(v)).to(dev, dtype) for k, v in d.items()}

        spp = self.cfg["spp"]
        t = tens(truth)
        targets = prob.images(t, keys.shape[1], spp)
        params = tens(init)
        start = {k: v.clone() for k, v in params.items()}
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        lr_fn = diff.cosine_lr(self.job["lr"], self.job["lr_schedule_steps"],
                               self.job["lr_min_frac"])
        losses, grad1, steps = [], None, dict(grads=[], params=[])
        for n in range(self.traffic["checked_steps"]):
            loss, grads = prob.loss_and_grad(params, targets, spp)
            losses.append(loss)
            if n == 0:
                grad1 = norms(grads)
            params, mu, nu = diff.adam(params, grads, mu, nu, n + 1, lr_fn(n),
                                       self.job["lr_scales"])
            if trace_steps:
                steps["grads"].append(grads)
                steps["params"].append(params)
        out = dict(losses=losses, grad1=grad1,
                   change=norms({k: params[k] - start[k] for k in start}))
        return {**out, **steps} if trace_steps else out

    def _compare(self, prog: dict, ref: dict) -> list[dict]:
        """The first step's loss (the later steps' losses part on some
        seeds: PERF.md), the first gradient by the worst leaf, and the
        change of the parameters over the checked steps by the worst leaf.
        Leaves are left out of the change by the reference's first
        gradient."""
        spec = self.traffic["check"]
        return [check.rel_gap(prog["losses"][0], ref["losses"][0], "loss_gap",
                              spec["loss_limit"]),
                check.leaf_gap(prog["grad1"], ref["grad1"], "grad_gap", spec["grad_limit"]),
                check.leaf_gap(prog["change"], ref["change"], "update_gap",
                               spec["update_limit"], weights=ref["grad1"])]

    def check(self) -> list[dict]:
        prog = dict(losses=self.losses, grad1=self.grad1, change=self.change)
        return self._compare(prog, self.reference())

    def control(self, dtype=torch.bfloat16) -> list[dict]:
        return self._compare(self.reference(dtype), self.reference())
