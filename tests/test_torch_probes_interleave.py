"""raytracer_tpu_torch.probes.interleave_probe ≡
scripts/kernel_interleave_probe.py.

The port's plain version (the twin of csrc/probe_interleave.cu) and the
script's own `make_kernel(G, zero_row)` in `pl.pallas_call(...,
interpret=True)` with the script's in/out specs, on the v5 tables of
`probe_scripts.v5_tables` and max(G, 2) packets of seeded rays (the
script's module global N_PACKETS, read while tracing, is set to that
multiple of G), 6 iterations. Tracing G packets per iteration grows with
G: G = 4 and 8 take 10-30 s and run in the slow tier. Tolerance:
tests/probe_scripts.py."""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from probe_scripts import ITERS, agree, load_script, v5_tables

from raytracer_tpu_torch.probes import interleave_probe, v5_body

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    node, tri, _, _, _, zero_row = v5_tables()
    return node, tri, zero_row


def _check(monkeypatch, tables, G):
    packets = max(G, 2)
    mod = load_script(monkeypatch, "kernel_interleave_probe.py", [ITERS])
    monkeypatch.setattr(mod, "N_PACKETS", packets)
    node, tri, zero_row = tables
    o, d, tlim = v5_body.make_rays(packets, seed=2)
    want = pl.pallas_call(
        mod.make_kernel(G, zero_row),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 5,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((packets, 8, 128), jnp.float32),
        interpret=True)(node, tri, o, d, tlim)
    got = interleave_probe.interleave(*(torch.from_numpy(a) for a in (node, tri, o, d, tlim)),
                                      zero_row, G, ITERS)
    agree(got.numpy(), want)
    assert (got < 1e30).float().mean() > 0.01  # the walks reach leaves and hit


@pytest.mark.parametrize("G", (1, 2), ids=lambda g: f"G{g}")
def test_interleave_matches_script(monkeypatch, tables, G):
    _check(monkeypatch, tables, G)


@pytest.mark.parametrize("G", (4, 8), ids=lambda g: f"G{g}")
def test_interleave_wide_matches_script(monkeypatch, tables, G):
    _check(monkeypatch, tables, G)


@pytest.mark.parametrize("G", interleave_probe.GS, ids=lambda g: f"G{g}")
def test_interleave_plain_is_v5_full(tables, G):
    """A packet's output does not depend on G: every G's plain version is
    the v5 full body's bit for bit (on the card every G's kernel is held to
    it), and a packet count that G does not divide is refused."""
    node, tri, zero_row = tables
    o, d, tlim = (torch.from_numpy(a) for a in v5_body.make_rays(8, seed=3))
    node, tri = torch.from_numpy(node), torch.from_numpy(tri)
    got = interleave_probe.interleave(node, tri, o, d, tlim, zero_row, G, 5)
    assert torch.equal(got, v5_body.v5(node, tri, o, d, tlim, zero_row, "full", 5))
    if G > 1:
        with pytest.raises(ValueError, match="multiple"):
            interleave_probe.interleave(node, tri, o[:G - 1], d[:G - 1], tlim[:G - 1],
                                        zero_row, G, 5)
