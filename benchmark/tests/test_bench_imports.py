"""What runs on the card loads neither JAX nor the JAX package, and the
reference loads none of the program either. Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import manifest
from benchmark.run import FORBIDDEN

REFERENCE = os.path.join(manifest.HERE, "reference")


def top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(*dirs):
    for d in dirs:
        for f in sorted(os.listdir(d)):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def harness_sources():
    top = [os.path.join(manifest.HERE, f) for f in os.listdir(manifest.HERE)
           if f.endswith(".py")]
    return sorted(top) + list(sources(*(os.path.join(manifest.HERE, k)
                                        for k in ("entries", "metrics", "reference", "tools"))))


@pytest.mark.parametrize("path", harness_sources(), ids=os.path.basename)
def test_no_harness_source_imports_jax_or_the_jax_package(path):
    assert not set(top_imports(path)) & set(FORBIDDEN), path


@pytest.mark.parametrize("path", list(sources(REFERENCE)), ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(top_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "raytracer_tpu", "raytracer_tpu_torch"}
    local = {n for n in names if n == "benchmark"}
    if local:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), node.module


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=manifest.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_no_jax_module():
    """A whole run of a cell, on the CPU at a tiny size, in a process of
    its own: afterwards no top-level module is jax, jaxlib, flax or
    raytracer_tpu, while raytracer_tpu_torch is loaded."""
    code = ("from benchmark import run\n"
            "assert run.main(['--workload', 'bunny2k_fused_hq', '--seed', '5', '--seconds', "
            "'0', '--trace', '0'], device='cpu', config_over={'resolution': [32, 18]}, "
            "traffic_over={'spp_per_request': 1, 'check': {'requests': 1, 'pixels': 8, "
            "'atol': 1e-5, 'rtol': 1e-3, 'limit': 0.05}}) == 0")
    loaded = _modules_after(code)
    assert "raytracer_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = "\n".join(f"import benchmark.reference.{os.path.basename(p)[:-3]}"
                     for p in sources(REFERENCE) if not p.endswith("__init__.py"))
    loaded = _modules_after(code)
    assert not loaded & {"jax", "jaxlib", "flax", "raytracer_tpu", "raytracer_tpu_torch"}


def test_the_run_refuses_a_forbidden_module(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "raytracer_tpu.fake", object())
    assert run.loaded_forbidden() == ["raytracer_tpu.fake"]
    monkeypatch.delitem(sys.modules, "raytracer_tpu.fake")
    monkeypatch.setitem(sys.modules, "raytracer_tpu_torch_x", object())
    assert run.loaded_forbidden() == []
