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
are those of float-encoded ids, OK for p2."""

import types

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
