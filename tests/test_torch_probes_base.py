"""raytracer_tpu_torch.probes.base_probe ≡ scripts/kernel_base_probe.py.

One test whose cases are the script's four modes: the port's plain
version (v5_body.v5_plain, the twin of csrc/probe_v5.cu) and the script's
own `make_kernel(mode)` in `pl.pallas_call(..., interpret=True)` with the
script's in/out specs, on the v5 tables and seeded rays of
`probe_scripts.v5_tables`, 2 packets, 6 iterations. The modes make their
rows from t_best: with the script's tlim (3e38 everywhere) every row is
3e38 and every mode returns tlim, so the limits here are seeded in
±50, where rows differ per lane and chains take different tasks.
Tolerance: tests/probe_scripts.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from probe_scripts import ITERS, PACKETS, agree, load_script, v5_tables

from raytracer_tpu_torch.probes import base_probe, v5_body

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    node, tri, o, d, tlim, zero_row = v5_tables()
    tlim = np.random.default_rng(5).uniform(-50, 50, tlim.shape).astype(np.float32)
    return node, tri, o, d, tlim, zero_row


def _port(tables, mode, iters=ITERS):
    node, tri, o, d, tlim, zero_row = tables
    return v5_body.v5(*(torch.from_numpy(a) for a in (node, tri, o, d, tlim)), zero_row, mode,
                      iters)


@pytest.mark.parametrize("mode", base_probe.MODES)
def test_base_probe_matches_script(monkeypatch, tables, mode):
    mod = load_script(monkeypatch, "kernel_base_probe.py", [ITERS])
    monkeypatch.setattr(mod, "N_PACKETS", PACKETS)
    node, tri, o, d, tlim, _ = tables
    want = pl.pallas_call(
        mod.make_kernel(mode),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 5,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((PACKETS, 8, 128), jnp.float32),
        interpret=True)(node, tri, o, d, tlim)
    agree(_port(tables, mode).numpy(), want)


def test_base_modes_differ_where_the_script_does(tables):
    """The task a row adds is the chain's own in base and chain 0's in
    noconcat, and noc_nosc steps it without push/pop; on these inputs the
    three outputs differ, and differ from tlim, so the test above tells
    them apart. minimal is smem8's body: the same output bit for bit."""
    base, noconcat, nosc = (_port(tables, m) for m in ("base", "noconcat", "noc_nosc"))
    tlim = torch.from_numpy(tables[4])
    assert (base != noconcat).float().mean() > 0.05 and not torch.equal(noconcat, nosc)
    assert (base != tlim).float().mean() > 0.05
    assert torch.equal(_port(tables, "minimal"), _port(tables, "smem8"))
    assert v5_body.flags("minimal")["loop_only"] and not v5_body.flags("base")["row0"]


def test_base_mode_work():
    """The bound counts 8 MT records, 4 slabs and the add that makes the row
    in every mode with a body, one add per iteration in minimal, and no
    table bytes: the modes never read the tables."""
    full = v5_body.lane_ops("full")
    assert [v5_body.lane_ops(m) for m in base_probe.MODES] == [full + 1] * 3 + [1]
    node, tri, o = torch.zeros(9, 128), torch.zeros(7, 128), torch.zeros(2, 3, 8, 128)
    w = v5_body.work(node, tri, o, "base", 5)
    assert w["bytes"] == 4 * (2 * o.numel() + 2 * 2 * 1024)
    assert w["ops"] == (full + 1) * 2 * 1024 * 5
