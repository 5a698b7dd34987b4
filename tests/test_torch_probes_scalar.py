"""raytracer_tpu_torch.probes.scalar_cost ≡ scripts/scalar_cost_probe.py.

For each kernel mode, the port's plain version (the twin of
csrc/probe_scalar.cu) and the script's own `make_kernel(mode, iters)` in
`pl.pallas_call(..., interpret=True)` with the script's in/out specs, on
3 seeded packets and 70 iterations (the script's module global N_PACKETS,
read while tracing, is set to 3). The script's output acc is held to the
tolerance of tests/probe_scripts.py. acc does not show the scalar work
(every mode's acc grows by 1e-7 per iteration whatever sc is), so the
port's witness is checked against NumPy models of the script's scalar
chains: sc after the last iteration and vsort's sorted codes. smem16's
table carries from packet to packet; 70 iterations are past the 64 after
which a carried table and one reset per packet part ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from probe_scripts import agree, load_script

from raytracer_tpu_torch.probes import scalar_cost

torch.set_num_threads(2)

PACKETS, ITERS = 3, 70


def _smem16_model(packets, iters, start):
    """The script's smem16 chain in NumPy, sc after each packet's last
    iteration: (one 64-entry table scoped around the packet loop, starting
    as `start`; the table reset to `start` for every packet)."""
    def chain(reset):
        tab = np.array(start, np.int64)
        out = []
        for p in range(packets):
            if reset:
                tab = np.array(start, np.int64)
            sc = p
            for it in range(iters):
                for k in range(16):
                    tab[(sc + k) & 63] = sc + k
                sc = int(tab[it & 63])
            out.append(sc)
        return np.array(out)
    return chain(False), chain(True)


def _witness_model(mode, want):
    p = np.arange(PACKETS)
    if mode == "alu32":
        sc = p.copy()
        for _ in range(ITERS * 32):
            sc = (sc * 3 + 1) & 0xFFFF
        return sc
    if mode == "smem16":
        return _smem16_model(PACKETS, ITERS, np.zeros(64))[0]
    if mode == "extract8":
        assert (want < 1).all()  # every extracted value converts to 0
        return p & 0xFFFF
    return p


@pytest.mark.parametrize("mode", scalar_cost.MODES)
def test_scalar_cost_matches_script(monkeypatch, mode):
    mod = load_script(monkeypatch, "scalar_cost_probe.py", [ITERS])
    monkeypatch.setattr(mod, "N_PACKETS", PACKETS)
    x = scalar_cost.make_input(PACKETS, seed=4)
    want = np.asarray(pl.pallas_call(
        mod.make_kernel(mode, ITERS),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((PACKETS, 8, 128), jnp.float32),
        interpret=True)(x))
    acc, sc, codes = scalar_cost.scalar_cost(torch.from_numpy(x), mode, ITERS)
    agree(acc.numpy(), want)
    assert np.array_equal(sc.numpy(), _witness_model(mode, want))
    if mode == "vsort":
        # The last iteration's codes, ordered by their rows' first 8 values.
        order = np.argsort(want[:, :, 0:8], axis=-1, kind="stable")
        expect = np.take_along_axis((want[:, :, 8:16] * 1000).astype(np.int32), order, -1)
        assert np.array_equal(codes.numpy(), expect)
    else:
        assert codes is None


def test_smem16_witness_needs_the_carried_table():
    """The port's smem16 witness equals the model with one table carried
    across packets, whatever the table held before packet 0, and not the
    model with a table reset for every packet: the check above has teeth.
    The starting tables the pre-pass kernel takes over on the card are the
    carried model's."""
    x = torch.from_numpy(scalar_cost.make_input(PACKETS, seed=4))
    _, sc, _ = scalar_cost.scalar_cost(x, "smem16", ITERS)
    carried, reset = _smem16_model(PACKETS, ITERS, np.zeros(64))
    garbage, _ = _smem16_model(PACKETS, ITERS, np.random.default_rng(1).integers(-99, 99, 64))
    assert np.array_equal(sc.numpy(), carried) and np.array_equal(garbage, carried)
    assert not np.array_equal(sc.numpy(), reset)
    tables = scalar_cost.smem16_tables(PACKETS, ITERS, "cpu").numpy()
    assert (tables[0] == 0).all() and not (tables[1] == 0).all()
    assert scalar_cost.variant("baseline2x") == ("baseline", 2 * scalar_cost.ITERS)
