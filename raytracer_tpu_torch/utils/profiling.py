"""Tracing, timing and metrics (port of raytracer_tpu/utils/profiling.py).

  * `trace(log_dir, device)` records a torch.profiler trace of the block (CPU
    activity, plus the card's kernels and copies when the device is a
    card) and writes it with `tensorboard_trace_handler(log_dir)`: a
    TensorBoard-viewable trace, as the JAX package's `jax.profiler` trace
    is;
  * `Meter` measures wall-clock and the derived camera rays/s the same
    way the benchmark harness does (camera rays = W·H·spp);
  * `log_metrics` is the single structured-logging choke point: one JSON
    record per call, {"tag", "time", then the metrics}.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time


@contextlib.contextmanager
def trace(log_dir: str, device):
    """Profiler trace of the block, written into `log_dir` (TensorBoard).
    `device`: the device the block runs on; the card's activity is
    recorded when it is a CUDA device."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class Meter:
    def __init__(self, width: int, height: int, spp: int):
        self.width, self.height, self.spp = width, height, spp
        self.t0 = None
        self.elapsed = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False

    @property
    def camera_rays(self) -> int:
        return self.width * self.height * self.spp

    @property
    def rays_per_sec(self) -> float:
        return self.camera_rays / self.elapsed if self.elapsed else 0.0


def log_metrics(tag: str, stream=None, **metrics) -> None:
    rec = {"tag": tag, "time": time.time(), **metrics}
    print(json.dumps(rec), file=stream or sys.stderr)


def device_line(device) -> str:
    """What ran the work: for a card, its name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them; "cpu" otherwise. Raises when nvidia-smi cannot give them for a
    card."""
    import subprocess

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    if out.returncode != 0 or not line.rsplit(",", 1)[-1].strip().endswith(" W"):
        raise RuntimeError(f"nvidia-smi gave no name and power limit for card {index}: "
                           f"rc {out.returncode}, {out.stdout!r} {out.stderr!r}")
    return line
