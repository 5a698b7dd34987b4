"""The P-scalar smem16 tables pre-pass as the card runs it
(csrc/probe_scalar.cu probe_scalar_tables_kernel): every packet's chain at
once from a zero offset for the carried entry 0, then a scan over the
packets. Its NumPy twin, tables_twin here, equals the in-order chain
smem16_chain on a grid of packets and iterations, and the premise the
formulation rests on (a packet reads the table it was handed only at
iteration 0, entry 0, and every stored value is = its entry mod 64) holds
on the same grid. Also held here: the wrapper's W choice and refusals, the
work and dependence counts phase 13 turns into bounds, phase 13's check
that no reading goes over 100% of a bound, and the loop its issue bound
counts. The kernels run only on the card
(tests/test_torch_cuda.py, marker `cuda`)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.probes import scalar_cost

PACKETS = (1, 2, 9, 65, 256)
ITERS = (1, 5, 48, 63, 64, 65, 150, 403)


def tables_twin(packets: int, iters: int) -> np.ndarray:
    """smem16's starting tables int32[packets, 64] as the pre-pass kernel
    computes them (csrc/probe_scalar.cu probe_scalar_tables_kernel, whose
    notes prove its premise: a packet reads the table it was handed only at
    iteration 0, entry 0): every packet's chain at once from a zero offset
    for that carried entry C_p, each stored value marked relative (C_p +
    the value) when it derives from C_p, then the scan over packets,
    C_{p+1} = packet p's last entry 0 and table_{p+1}[e] = packet p's last
    entry e (offset by C_p when relative), else table_p[e]."""
    e = np.arange(scalar_cost.TABLE)[None, :]
    val = np.zeros((packets, scalar_cost.TABLE), np.int64)
    written = np.zeros((packets, scalar_cost.TABLE), bool)
    rel = np.zeros((packets, scalar_cost.TABLE), bool)
    sc = np.arange(packets, dtype=np.int64)
    sc_rel = np.zeros(packets, bool)
    for it in range(iters):
        k = (e - sc[:, None]) & (scalar_cost.TABLE - 1)
        hit = k < 16
        val = np.where(hit, sc[:, None] + k, val)
        written |= hit
        rel = np.where(hit, sc_rel[:, None], rel)
        r = it & (scalar_cost.TABLE - 1)
        sc, sc_rel = val[:, r], np.where(written[:, r], rel[:, r], True)
    tables = np.zeros((packets, scalar_cost.TABLE), np.int64)
    for p in range(packets - 1):
        tables[p + 1] = np.where(written[p], val[p] + np.where(rel[p], tables[p, 0], 0),
                                 tables[p])
    if tables.max(initial=0) >= 2**31:
        raise ValueError("smem16's chain leaves int32")
    return tables.astype(np.int32)


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("packets", PACKETS)
def test_tables_twin_equals_chain(packets, iters):
    assert np.array_equal(tables_twin(packets, iters),
                          scalar_cost.smem16_chain(packets, iters)[0])


def _reads(packets: int, iters: int):
    """smem16_chain's loop, recording each read of an entry the reading
    packet has not stored itself, as (packet, iteration, entry), and whether
    every stored value is = its entry mod 64."""
    tab = [0] * scalar_cost.TABLE
    foreign, congruent = [], True
    for p in range(packets):
        mine, sc = set(), p
        for it in range(iters):
            for k in range(16):
                e = (sc + k) & (scalar_cost.TABLE - 1)
                tab[e] = sc + k
                congruent &= (sc + k - e) % scalar_cost.TABLE == 0
                mine.add(e)
            e = it & (scalar_cost.TABLE - 1)
            if e not in mine:
                foreign.append((p, it, e))
            sc = tab[e]
    return foreign, congruent


@pytest.mark.parametrize("packets", PACKETS)
def test_premise_carried_table_read_only_at_iteration_0_entry_0(packets):
    """The kernel's premise on the grid (its notes prove it for every
    count): a packet reads an entry it has not stored itself at most once,
    at iteration 0, entry 0; every stored value is = its entry mod 64. Some
    packets do read the carried entry, so the scan's offsets matter."""
    for iters in ITERS:
        foreign, congruent = _reads(packets, iters)
        assert congruent, iters
        assert all(it == 0 and e == 0 for _, it, e in foreign), (iters, foreign[:4])
        assert len({p for p, _, _ in foreign}) == len(foreign) <= packets
        if packets >= 2:
            assert foreign, iters


def test_tables_twin_needs_the_offsets():
    """Without the carried offsets (every relative value taken as if C_p
    were 0) the twin's tables differ from the chain's: the scan has
    teeth."""
    want = scalar_cost.smem16_chain(9, 150)[0]
    assert np.array_equal(tables_twin(9, 150), want)
    assert (want[1:, 0] != 0).any()


def test_scalar_chain_width_choice_and_refusals():
    """Every mode's chosen W is admitted; a W that no kernel is built for
    raises before any launch, also on the CPU; on the CPU every W gives the
    plain version's result."""
    assert set(scalar_cost.CHOSEN_W) == set(scalar_cost.MODES)
    assert all(scalar_cost.chosen_w(m) in scalar_cost.ADMITTED_W for m in scalar_cost.MODES)
    x = torch.from_numpy(scalar_cost.make_input(2, seed=4))
    want = scalar_cost.scalar_cost(x, "extract8", 5)
    for w in scalar_cost.ADMITTED_W:
        got = scalar_cost.scalar_cost(x, "extract8", 5, w=w)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for w in (0, 3, 16):
        with pytest.raises(ValueError, match="chain width"):
            scalar_cost.scalar_cost(x, "baseline", 5, w=w)


def test_tables_work_counts():
    """The pre-pass's roofline work is smem16's (16 x (add, and) per packet
    and iteration), its dependence chain a packet's iterations (2 integer
    operations each) and the C_p scan's rounds of 32 packets (6 shuffles
    and 6 integer operations each)."""
    w = scalar_cost.tables_work(256, 403)
    assert w["bytes"] == 4 * 256 * 64 and w["int32_ops"] == 32 * 256 * 403
    assert (w["dep_alu"], w["dep_shfl"]) == (2 * 403 + 6 * 8, 6 * 8)
    assert scalar_cost.tables_work(1, 403)["dep_shfl"] == 0
    assert scalar_cost.tables_work(33, 1)["dep_shfl"] == 6


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_for_bounds", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase13_names_every_reading_over_a_bound():
    """chip_smoke.over_bounds finds a time under any of its bounds, at any
    depth, the pre-pass's own pair included, and passes times above them."""
    over_bounds = _chip_smoke().over_bounds
    ok = {"P-x": {"a": {"ms": 1.0, "bound_ms": 0.5, "issue_bound_ms": 0.9},
                  "widths": {4: {"ms": 2.0, "dep_bound_ms": 1.5}}},
          "P-scalar": {"tables_ms": 0.05, "tables_graph_ms": 0.04, "tables_bound_ms": 1e-4,
                       "tables_dep_bound_ms": 0.01, "variants": [{"ms": 0.1, "bound_ms": 0.02}]}}
    assert over_bounds(ok) == []
    bad = {"P-x": {"widths": {4: {"ms": 2.0, "dep_bound_ms": 2.5, "graph_ms": 1.0,
                                  "bound_ms": 1.2}}},
           "P-scalar": {"tables_ms": 0.05, "tables_graph_ms": 0.004, "tables_dep_bound_ms": 0.01},
           "rows": [{"ms": 0.1, "rank_bound_ms": 0.2}]}
    got = over_bounds(bad)
    assert len(got) == 5
    assert "P-x/widths/4: ms 2.000000 ms under dep_bound_ms 2.500000 ms" in got
    assert any(g.startswith("P-scalar: tables_graph_ms") for g in got)
    assert any(g.startswith("rows[0]: ms") for g in got)


def test_phase13_issue_bound_takes_the_iteration_loop():
    """chip_smoke.iter_insns takes the shortest path through a kernel's one
    loop over iterations, gives no count where nvcc unrolled that loop, and
    raises on any other number of outermost loops than expected, so that a
    set-up loop's trip is never taken for an iteration."""
    iter_insns = _chip_smoke().iter_insns
    assert iter_insns({"loops": [300], "loop_min": [250]}, "v8 full") == 250
    assert iter_insns({"loops": [3000], "loop_min": [2700]}, "interleave") == 2700
    assert iter_insns({"loops": [67, 19, 7], "loop_min": [67, 19, 7]}, "v5 empty") is None
    with pytest.raises(AssertionError, match="2 outermost loops"):
        iter_insns({"loops": [300, 12], "loop_min": [250, 12]}, "v8 full")
    with pytest.raises(AssertionError, match="expected 2"):
        iter_insns({"loops": [39], "loop_min": [39]}, "v5 smem8")
