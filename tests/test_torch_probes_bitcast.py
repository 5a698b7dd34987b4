"""raytracer_tpu_torch.probes.bitcast ≡ scripts/bitcast_probe.py.

Each of p1-p4 runs as the script's own function, unchanged, with
`jax.experimental.pallas.pallas_call` wrapped to run in interpret mode and
to record the kernel's inputs and outputs (`jax.jit` is left alone), and
`raytracer_tpu.scene.builder.reference_scene` returning the small 4-wide
tree of tests/probe_scripts.py as the scene's bvh4. The port's tables
equal the recorded inputs, its plain version (the twin of
csrc/probe_bitcast.cu; tests/test_torch_cuda.py holds the kernel to it on
the card) equals the recorded outputs bit for bit, and its verdict line is
the script's, character for character: BAD for p1, p3 and p4, whose bits
are those of float-encoded ids, OK for p2. The library calls chip_smoke.py
times p3 and p4 against equal the plain version bit for bit, and the
wrapper's rules off its fast path raise their errors here as on the card."""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from probe_scripts import jax_tree, load_script, record_pallas, small_tree

from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu_torch.probes import bitcast

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    bvh = small_tree()
    return jax_tree(bvh), bitcast.tables_of(bvh)


@pytest.mark.parametrize("case", bitcast.CASES)
def test_bitcast_probe_matches_script(monkeypatch, tree, case):
    jbvh, tabs = tree
    mod = load_script(monkeypatch, "bitcast_probe.py", [])
    monkeypatch.setattr(jbuilder, "reference_scene",
                        lambda *a, **k: types.SimpleNamespace(bvh4=jbvh))
    calls = record_pallas(monkeypatch)
    line = getattr(mod, case)()
    assert len(calls) == 1
    (arg,), want = calls[0]
    tab, r0 = bitcast.case_input(case, tabs, "cpu")
    np.testing.assert_array_equal(tab.numpy().view(np.int32), arg.view(np.int32))
    got = bitcast.probe_bitcast(case, tab, r0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    ok, port_line = bitcast.verdict(case, [g.numpy() for g in got], tabs)
    assert port_line == line
    assert line.startswith("OK" if case == "p2" else "BAD") and ok == (case == "p2")
    if case != "p2":   # the ids come back as their float bit patterns
        at, ident = {"p1": ((0, 1), tabs.brute_mat[0]), "p3": ((0, 0), tabs.children[0, 0]),
                     "p4": ((0, 0), tabs.brute_prim[0])}[case]
        assert int(got[0].numpy()[at]) == int(np.float32(ident).view(np.int32))


def test_bitcast_entry_point(capsys):
    """The entry point's in-process probe on the CPU prints the script's
    line; an unknown probe raises."""
    assert bitcast.main(["p2", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("OK diffs=0")
    with pytest.raises(ValueError, match="unknown probe"):
        bitcast.case_input("p5", None, "cpu")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_for_bitcast", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", bitcast.CASES)
def test_bitcast_library_calls_equal_plain(tree, case):
    """chip_smoke.bitcast_library's calls for p3 (a pad of the child codes'
    int32 view) and p4 (a repeat of the ids' int32 view, unbound into best
    and mat), with the views taken inside the call and made beforehand,
    equal bitcast_plain bit for bit on the small tree; p1 and p2 have
    none."""
    _, tabs = tree
    tab, r0 = bitcast.case_input(case, tabs, "cpu")
    calls = _chip_smoke().bitcast_library(case, tab, r0)
    if case in ("p1", "p2"):
        assert calls == (None, None)
        return
    want = bitcast.bitcast_plain(case, tab, r0)
    for call in calls:
        got = call()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.shape == bitcast.TILE
            assert torch.equal(g, w)


def _short(case, t, r0):
    """A table one row short of what the case reads (r0 + 1 rows; p3: 2)."""
    return t[:1] if case == "p3" else t[:r0]


DEFECTS = {  # defect: (the input made wrong, the error it raises)
    "device": (lambda case, t, r0: (t.to("meta"), r0), "unsupported device meta"),
    "dtype": (lambda case, t, r0: (t.double(), r0), "expected torch.float32, got torch.float64"),
    "shape": (lambda case, t, r0: (t[:, :64].contiguous(), r0),
              "expected shape|reads rows up to"),
    "contiguity": (lambda case, t, r0: (t.t().contiguous().t(), r0),
                   "expected a contiguous tensor"),
    "rows": (lambda case, t, r0: (_short(case, t, r0), r0), "reads rows up to"),
    "negative r0": (lambda case, t, r0: (t, -1), "reads rows up to"),
}


@pytest.mark.parametrize("case, defect", [
    (case, defect) for case in bitcast.CASES for defect in DEFECTS
    if case != "p2" or defect not in ("rows", "negative r0")])   # p2 reads no table row
def test_bitcast_wrapper_guards(tree, case, defect):
    """The wrapper's rules off its fast path (the same on the CPU and the
    card) raise on an input on the wrong device or of the wrong dtype,
    shape or contiguity, on a table too short for the rows the case reads
    and on a negative row; the valid inputs pass them and take the plain
    version here."""
    _, tabs = tree
    tab, r0 = bitcast.case_input(case, tabs, "cpu")
    assert bitcast._takes(case, tab, r0) is False
    spoil, match = DEFECTS[defect]
    with pytest.raises(ValueError, match=match):
        bitcast.probe_bitcast(case, *spoil(case, tab, r0))


def test_bitcast_unknown_case_and_work():
    """An unknown case raises before any input is looked at; p2, which
    reads no table row, takes any r0; work() counts the bytes each case
    must move (the ids or codes it reads, the tiles it writes) and p2's
    compares and selects."""
    x = torch.from_numpy(bitcast.p2_input())
    with pytest.raises(ValueError, match="unknown probe 'p5'"):
        bitcast.probe_bitcast("p5", x, 0)
    with pytest.raises(ValueError, match="unknown probe"):
        bitcast._takes("p5", x, 0)
    assert bitcast._takes("p2", x, -1) is False
    n = 8 * 128
    assert [bitcast.work(c)["bytes"] for c in bitcast.CASES] == [
        64 + 4 * n, 8 * n, 128 + 4 * n, 64 + 8 * n]
    assert bitcast.work("p2")["fp32_ops"] == bitcast.work("p2")["int32_ops"] == 4 * n
    assert all(bitcast.work(c)["fp32_ops"] == bitcast.work(c)["int32_ops"] == 0
               for c in ("p1", "p3", "p4"))
