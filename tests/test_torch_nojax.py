"""raytracer_tpu_torch never imports JAX: the machine with the card has
none. A subprocess in which `import jax` fails imports every module of
the port (the differentiable path's render, models/megakernel,
ops/intersect, ops/packets, utils/rng and diff/inverse, the wavefront,
the checkpoints, the viewer and camera motion, the probes, the LBVH and
its traversal, the procedural assets, the profiler, the milestone runner
and the flagship, among them) and chip_smoke.py."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None

sys.meta_path.insert(0, _NoJax())
import raytracer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(raytracer_tpu_torch.__path__,
                                               "raytracer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("raytracer_tpu_torch.render", "raytracer_tpu_torch.models.megakernel",
             "raytracer_tpu_torch.ops.intersect", "raytracer_tpu_torch.ops.packets",
             "raytracer_tpu_torch.utils.rng", "raytracer_tpu_torch.diff.inverse",
             "raytracer_tpu_torch.probes.ablate_v8", "raytracer_tpu_torch.probes.v5_body",
             "raytracer_tpu_torch.probes.v5_tables", "raytracer_tpu_torch.probes.ablate",
             "raytracer_tpu_torch.probes.load_probe", "raytracer_tpu_torch.probes.floor_probe",
             "raytracer_tpu_torch.probes.base_probe", "raytracer_tpu_torch.probes.interleave_probe",
             "raytracer_tpu_torch.probes.scalar_cost", "raytracer_tpu_torch.probes.vstack",
             "raytracer_tpu_torch.probes.ktf_probe", "raytracer_tpu_torch.probes.v6",
             "raytracer_tpu_torch.probes.v6_tables", "raytracer_tpu_torch.probes.morph",
             "raytracer_tpu_torch.probes.mosaic", "raytracer_tpu_torch.probes.bitcast",
             "raytracer_tpu_torch.probes.feature", "raytracer_tpu_torch.models.wavefront",
             "raytracer_tpu_torch.io.checkpoint", "raytracer_tpu_torch.viewer",
             "raytracer_tpu_torch.camera_motion", "raytracer_tpu_torch.cli",
             "raytracer_tpu_torch.parallel.sharding", "raytracer_tpu_torch.parallel.multihost",
             "raytracer_tpu_torch.parallel.multihost_demo", "raytracer_tpu_torch.ops.bvh",
             "raytracer_tpu_torch.ops.traverse", "raytracer_tpu_torch.scene.assets",
             "raytracer_tpu_torch.utils.profiling", "raytracer_tpu_torch.milestones",
             "raytracer_tpu_torch.flagship"):
    assert name in names, name
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "jaxlib", "raytracer_tpu") for m in sys.modules)
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 40


def test_chip_smoke_refuses_without_a_card():
    """On a machine without CUDA the smoke run exits non-zero and prints no result."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; this checks the refusal without one")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
