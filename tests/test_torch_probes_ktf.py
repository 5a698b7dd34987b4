"""raytracer_tpu_torch.probes.ktf_probe ≡ scripts/ktf_kernel_probe.py.

The script's run_case(case) runs as it is, with
`jax.experimental.pallas.pallas_call` wrapped to run in interpret mode and
to record each call's inputs and outputs; the script's own in-kernel checks
pass. The port's inputs equal the recorded inputs, and its plain version
(the twin of csrc/probe_ktf.cu; tests/test_torch_cuda.py holds the kernel
to it on the card) equals the recorded outputs by the script's rules:
bitwise for the integer words, u01 and rr_uniform, atol 1e-5 (x, y) and
1e-6 (z) for the unit vectors, whose cos and sin are XLA's there and
PyTorch's here."""

import numpy as np
import pytest
import torch
from probe_scripts import load_script, record_pallas

from raytracer_tpu_torch.probes import ktf_probe

torch.set_num_threads(2)


@pytest.fixture
def script(monkeypatch):
    """(the script module, the list of (inputs, outputs) of its pallas calls)."""
    mod = load_script(monkeypatch, "ktf_kernel_probe.py", [])
    return mod, record_pallas(monkeypatch)


@pytest.mark.parametrize("case", ktf_probe.CASES)
def test_ktf_case_matches_script(script, case):
    mod, calls = script
    mod.run_case(case)                        # the script's in-kernel check passes
    assert len(calls) == 1
    args, want = calls[0]
    ins = ktf_probe.inputs(case)
    if case == "unitvec":
        assert np.array_equal(np.stack(ins), args[0])
    else:
        for a, b in zip(ins, args):
            assert np.array_equal(a, b)
    got = ktf_probe.probe_ktf(case, *(torch.from_numpy(x) for x in ins))
    ok, err = ktf_probe.agrees(case, [g.numpy() for g in got], want)
    assert ok, err
    # ... and the script's host expectation, as its check holds the kernel.
    assert ktf_probe.agrees(case, [g.numpy() for g in got], ktf_probe.expected(case, *ins))[0]


def test_ktf_entry_point_and_teeth():
    """The entry point's in-process case on the CPU; a word off by one bit,
    or a unit vector off by 2e-5, fails its rule."""
    assert ktf_probe.main(["sampler_tile", "--device", "cpu"]) == 0
    ins = ktf_probe.inputs("threefry")
    got = [g.numpy().copy() for g in ktf_probe.ktf_plain(
        "threefry", *(torch.from_numpy(x) for x in ins))]
    want = ktf_probe.expected("threefry", *ins)
    got[1][3, 7] ^= 1
    assert ktf_probe.agrees("threefry", got, want)[0] is False
    ins = ktf_probe.inputs("unitvec")
    got = [g.numpy().copy() for g in ktf_probe.ktf_plain(
        "unitvec", *(torch.from_numpy(x) for x in ins))]
    got[0][0, 0] += 2e-5
    assert ktf_probe.agrees("unitvec", got, ktf_probe.expected("unitvec", *ins))[0] is False
    with pytest.raises(ValueError, match="unknown case"):
        ktf_probe.inputs("disk")
