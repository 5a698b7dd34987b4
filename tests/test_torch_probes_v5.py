"""raytracer_tpu_torch.probes' v5 body ≡ the v5 probe scripts
(scripts/kernel_ablate.py, kernel_load_probe.py, kernel_floor_probe.py).

For each script, one test whose cases are its variants: the port's plain
version (the twin of csrc/probe_v5.cu) and the script's own `make_kernel`
in `pl.pallas_call(..., interpret=True)`, with the script's in/out specs,
on the same v5 tables and seeded rays (`probe_scripts.v5_tables`: a small
4-wide tree, 2 packets), 6 iterations. The v5 scripts read their module
global N_PACKETS while tracing: it is set on the imported module.
Tolerance: tests/probe_scripts.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from probe_scripts import ITERS, PACKETS, agree, load_script, v5_tables

from raytracer_tpu_torch.probes import ablate, floor_probe, load_probe, v5_body

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    return v5_tables()


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
