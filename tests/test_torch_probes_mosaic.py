"""raytracer_tpu_torch.probes.mosaic ≡ scripts/mosaic_probe.py.

The script's main() runs once, unchanged, with
`jax.experimental.pallas.pallas_call` wrapped to run in interpret mode and
to record each call's inputs and outputs; every case prints OK. For each
of the 7 cases the port's inputs equal the recorded ones bit for bit, and
its plain version (the twin of csrc/probe_mosaic.cu;
tests/test_torch_cuda.py holds the kernel to it on the card) equals the
recorded output: integers exactly, floats within the tolerance of
tests/probe_scripts.py (the lane sum adds in the kernel's order, XLA in
its own); and it passes the script's own check."""

import contextlib
import io

import numpy as np
import pytest
import torch
from probe_scripts import agree, load_script, record_pallas

from raytracer_tpu_torch.probes import mosaic
from raytracer_tpu_torch.utils import cudalib

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def script():
    """(the recorded (inputs, outputs) of the script's 7 calls, its lines)."""
    with pytest.MonkeyPatch.context() as mp:
        mod = load_script(mp, "mosaic_probe.py", [])
        calls = record_pallas(mp)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
    return calls, buf.getvalue().splitlines()


@pytest.mark.parametrize("case", mosaic.CASES)
def test_mosaic_case_matches_script(script, case):
    calls, lines = script
    assert len(calls) == len(mosaic.CASES)
    args, (want,) = calls[mosaic.CASES.index(case)]
    assert f"{mosaic.NAMES[case]:28s}: OK" in lines
    ins = mosaic.inputs(case)
    assert len(ins) == len(args)
    for a, b in zip(ins, args):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32))
    got = mosaic.probe_mosaic(case, *(torch.from_numpy(np.ascontiguousarray(a)) for a in ins))
    if got.dtype == torch.int32:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        agree(got.numpy(), want)
    assert mosaic.check(case, got.numpy())[0]
    assert mosaic.run_case(case, "cpu", out=lambda line: None)["ok"]


def test_mosaic_teeth_and_entry_point(capsys):
    """A lane-sum off by 1e-3 and a bitcast off by 1,000 fail the script's
    rule; the entry point runs every case on the CPU and prints its lines."""
    x = torch.from_numpy(mosaic.inputs("lanesum")[0])
    got = mosaic.mosaic_plain("lanesum", x).numpy().copy()
    got[2, 3] += 1e-3
    assert mosaic.check("lanesum", got)[0] is False
    got = mosaic.mosaic_plain("bitcast", torch.from_numpy(mosaic.inputs("bitcast")[0]))
    assert mosaic.check("bitcast", got.numpy())[0]
    bad = got.numpy().copy()
    bad[0, 0] += 1000
    assert mosaic.check("bitcast", bad)[0] is False
    assert mosaic.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.count(": OK") == len(mosaic.CASES)
    with pytest.raises(ValueError, match="unknown case"):
        mosaic.inputs("transpose")


DEFECTS = {  # defect: (the first input made wrong, the error it raises)
    "device": (lambda t: t.to("meta"), "unsupported device meta"),
    "dtype": (lambda t: t.double(), "expected torch.float32, got torch.float64"),
    "shape": (lambda t: t[:, :64].contiguous(), "expected shape|must be f32"),
    "contiguity": (lambda t: t.t().contiguous().t(), "expected a contiguous tensor"),
}


@pytest.mark.parametrize("defect", DEFECTS)
@pytest.mark.parametrize("case", ["colbcast", "dynload"])
def test_mosaic_wrapper_guards(case, defect):
    """The wrapper's guards (the same on the CPU and the card) raise on an
    input on the wrong device or of the wrong dtype, shape or contiguity;
    the script's inputs pass them and take the plain version here."""
    ins = [torch.from_numpy(np.ascontiguousarray(a)) for a in mosaic.inputs(case)]
    assert mosaic._takes(case, tuple(ins)) is False
    spoil, match = DEFECTS[defect]
    bad = [spoil(ins[0]), *ins[1:]]
    assert tuple(bad[0].shape) == tuple(ins[0].shape) or defect == "shape"
    with pytest.raises(ValueError, match=match):
        mosaic.probe_mosaic(case, *bad)
    if case == "dynload":
        with pytest.raises(ValueError, match="idx: expected"):
            mosaic.probe_mosaic(case, ins[0], spoil(ins[1]) if defect != "dtype"
                                else ins[1].long())
    with pytest.raises(ValueError, match="takes"):
        mosaic.probe_mosaic(case, *ins, ins[0])


def test_stream_handle_and_signature_on_the_cpu():
    """stream_handle raises a clear error where PyTorch has no CUDA, and
    no fallback hands out a handle; the fast path's signature of a CPU
    tensor never equals one it takes on the card; a misaligned pointer
    raises."""
    if torch.version.cuda is None:
        with pytest.raises(RuntimeError, match="built without CUDA"):
            cudalib.stream_handle()
    x = torch.from_numpy(mosaic.inputs("colbcast")[0])
    assert cudalib.signature(x) == (False, torch.float32, (8, 128), True)
    assert cudalib.signature(x) != mosaic._X and cudalib.signature(x.numpy()) is None
    assert cudalib.signature(x.t()) == (False, torch.float32, (128, 8), False)
    cudalib.require_aligned("x", 0x7F0000000100)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cudalib.require_aligned("x", 0x7F0000000104)
