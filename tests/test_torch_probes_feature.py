"""raytracer_tpu_torch.probes.feature ≡ scripts/kernel_feature_probe.py.

Stages s1-s6 run as the script's own functions, unchanged, with
`jax.experimental.pallas.pallas_call` wrapped to run in interpret mode and
to record each call's inputs and outputs (`jax.jit` is left alone); the
script's own checks pass. The port's inputs equal the recorded ones, its
plain version (the twin of csrc/probe_feature.cu; tests/test_torch_cuda.py
holds the kernel to it on the card) equals the recorded outputs within the
tolerance of tests/probe_scripts.py (they are whole numbers, equal in
fact), and its line is the script's. s7: the port's trace_closest on its
box-only reference scene hits as many of the script's 1,024 rays as the
JAX package's trace_closest_pallas in interpret mode on its own."""

import numpy as np
import pytest
import torch
from probe_scripts import agree, load_script, record_pallas

from raytracer_tpu.ops import pallas_traverse
from raytracer_tpu_torch.probes import feature

torch.set_num_threads(2)


@pytest.mark.parametrize("case", feature.CASES)
def test_feature_stage_matches_script(monkeypatch, case):
    mod = load_script(monkeypatch, "kernel_feature_probe.py", [])
    calls = record_pallas(monkeypatch)
    line = getattr(mod, case)()                  # the script's own check passes
    assert len(calls) == 1
    args, want = calls[0]
    ins = feature.inputs(case)
    assert len(ins) == len(args)
    for a, b in zip(ins, args):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = feature.probe_feature(case, *(torch.from_numpy(a) for a in ins))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        agree(g.numpy(), w)
    ok, port_line = feature.check(case, [g.numpy() for g in got], ins)
    assert ok and port_line == line
    if case in ("s4", "s5"):
        assert float(got[0][0, 0]) == {"s4": 10.0, "s5": 776.0}[case]


def test_feature_s7_hits_match_jax(monkeypatch, capsys):
    """s7: the script's stage with trace_closest_pallas in interpret mode,
    against the port's stage on the CPU (the plain traversal)."""
    mod = load_script(monkeypatch, "kernel_feature_probe.py", [])
    real = pallas_traverse.trace_closest_pallas

    def interpreted(*args, **kw):
        return real(*args, **dict(kw, interpret=True))

    monkeypatch.setattr(pallas_traverse, "trace_closest_pallas", interpreted)
    line = mod.s7()
    r = feature.run_case("s7", "cpu")
    assert capsys.readouterr().out.strip() == line
    assert 0 < r["hit"] < feature.S7_RAYS


def test_feature_entry_point_and_guards(capsys):
    """The entry point's in-process stage on the CPU; an unknown stage
    raises; a stage whose output misses the script's check fails it."""
    assert feature.main(["s6", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("dynamic fetch + select chain in while ok")
    with pytest.raises(ValueError, match="unknown kernel stage"):
        feature.inputs("s8")
    ins = feature.inputs("s3")
    (out,) = feature.feature_plain("s3", *(torch.from_numpy(a) for a in ins))
    assert feature.check("s3", [out.numpy() + 1.0], ins)[0] is False
    assert feature.check("s5", [np.full((8, 128), np.nan, np.float32)], ins)[0] is False


DEFECTS = {  # defect: (the first input made wrong, the error it raises)
    "device": (lambda t: t.to("meta"), "unsupported device meta"),
    "dtype": (lambda t: t.double(), "expected torch.float32, got torch.float64"),
    "shape": (lambda t: t[..., :64].contiguous(), "expected shape|takes x f32|takes a table"),
    "contiguity": (lambda t: t.transpose(-1, -2).contiguous().transpose(-1, -2),
                   "expected a contiguous tensor"),
}


@pytest.mark.parametrize("defect", DEFECTS)
@pytest.mark.parametrize("case", ["s2", "s3", "s6"])
def test_feature_wrapper_guards(case, defect):
    """The wrapper's guards (the same on the CPU and the card) raise on an
    input on the wrong device or of the wrong dtype, shape or contiguity;
    the script's inputs pass them and take the plain version here."""
    ins = [torch.from_numpy(a) for a in feature.inputs(case)]
    assert feature._takes(case, tuple(ins)) is False
    spoil, match = DEFECTS[defect]
    with pytest.raises(ValueError, match=match):
        feature.probe_feature(case, spoil(ins[0]), *ins[1:])
    if case == "s3" and defect != "contiguity":   # an int32[1] is always contiguous
        n_bad = {"device": ins[1].to("meta"), "dtype": ins[1].long(),
                 "shape": ins[1].repeat(2)}[defect]
        with pytest.raises(ValueError, match="n: expected"):
            feature.probe_feature(case, ins[0], n_bad)
    with pytest.raises(ValueError, match="takes"):
        feature.probe_feature(case, *ins, ins[0])
