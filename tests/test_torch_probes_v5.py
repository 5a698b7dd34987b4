"""raytracer_tpu_torch.probes' v5 body ≡ the v5 probe scripts
(scripts/kernel_ablate.py, kernel_load_probe.py, kernel_floor_probe.py).

For each script, one test whose cases are its variants: the port's plain
version (the twin of csrc/probe_v5.cu) and the script's own `make_kernel`
in `pl.pallas_call(..., interpret=True)`, with the script's in/out specs,
on the same v5 tables and seeded rays: a small 4-wide tree (400 random
triangles and 4 large ones, which the builder splits off as brute rows),
2 packets, 6 iterations. The v5 scripts read their module global
N_PACKETS while tracing: it is set on the imported module. The node table
is padded with zero rows to 251, the rows no_scalar's task walks through
(0..1000 // 4). Tolerance: tests/probe_scripts.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from probe_scripts import ITERS, PACKETS, agree, load_script

from raytracer_tpu_torch.probes import ablate, floor_probe, load_probe, v5_body
from raytracer_tpu_torch.probes.v5_tables import pack_tables
from raytracer_tpu_torch.scene.builder import build_scene_bvh4
from raytracer_tpu_torch.scene.types import TriMesh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(11)
    n_small = 400
    c = rng.uniform(-0.3, 0.3, (n_small, 1, 3))
    small = c + rng.normal(scale=0.06, size=(n_small, 3, 3))
    big = np.array([[[-1, -1, -0.5], [1, -1, -0.5], [0, 1, -0.5]],
                    [[-1, -1, 0.5], [0, 1, 0.5], [1, -1, 0.5]],
                    [[-1, -0.4, -1], [1, -0.4, -1], [0, -0.4, 1]],
                    [[-0.5, -1, -1], [-0.5, 1, -1], [-0.5, 0, 1]]])
    verts = np.concatenate([small, big]).reshape(-1, 3).astype(np.float32)
    n = verts.shape[0] // 3
    mesh = TriMesh(vertices=torch.from_numpy(verts),
                   faces=torch.arange(3 * n, dtype=torch.int32).reshape(n, 3),
                   face_mat=torch.from_numpy((np.arange(n) % 3).astype(np.int32)))
    import os

    old = os.environ.get("RAYTRACER_TPU_BVH_WIDTH")
    os.environ["RAYTRACER_TPU_BVH_WIDTH"] = "4"
    try:
        bvh = build_scene_bvh4(mesh)
    finally:
        if old is None:
            del os.environ["RAYTRACER_TPU_BVH_WIDTH"]
        else:
            os.environ["RAYTRACER_TPU_BVH_WIDTH"] = old
    assert bvh.children.shape[1] == 4 and bvh.brute_tri is not None
    node, tri, _, n_brute = pack_tables(bvh, bvh.face_mat)
    assert n_brute == 1 and bvh.stack_depth + 4 <= v5_body.STACK_CAP
    node = np.concatenate([node.numpy(), np.zeros((251 - node.shape[0], 128), np.float32)])
    o, d, tlim = v5_body.make_rays(PACKETS, seed=2)
    return node, tri.numpy(), o, d, tlim, tri.shape[0] - 1


def _check(monkeypatch, name, mode, tables):
    mod = load_script(monkeypatch, name, [ITERS])
    monkeypatch.setattr(mod, "N_PACKETS", PACKETS)
    node, tri, o, d, tlim, zero_row = tables
    want = pl.pallas_call(
        mod.make_kernel(mode, zero_row),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 5,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((PACKETS, 8, 128), jnp.float32),
        interpret=True)(node, tri, o, d, tlim)
    got = v5_body.v5(*(torch.from_numpy(a) for a in (node, tri, o, d, tlim)), zero_row, mode,
                     ITERS)
    agree(got.numpy(), want)
    return np.asarray(want)


@pytest.mark.parametrize("variant", ablate.VARIANTS)
def test_ablate_matches_script(monkeypatch, tables, variant):
    want = _check(monkeypatch, "kernel_ablate.py", variant, tables)
    if variant in ("full", "no_fetch"):
        assert (want < 1e30).mean() > 0.01  # the walks reach leaves and hit


@pytest.mark.parametrize("mode", load_probe.MODES)
def test_load_probe_matches_script(monkeypatch, tables, mode):
    _check(monkeypatch, "kernel_load_probe.py", mode, tables)


@pytest.mark.parametrize("mode", floor_probe.MODES)
def test_floor_probe_matches_script(monkeypatch, tables, mode):
    _check(monkeypatch, "kernel_floor_probe.py", mode, tables)
