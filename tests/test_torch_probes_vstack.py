"""raytracer_tpu_torch.probes.vstack ≡ scripts/vstack_probe.py.

The script's p1(), p2() and p3() run as they are, with
`jax.experimental.pallas.pallas_call` wrapped to run in interpret mode and
to record each call's outputs, and `jax.jit` made the identity so that the
recorded outputs are concrete. The port's plain version (the twin of
csrc/probe_vstack.cu) equals them exactly at the script's own iteration
counts (64; 20,000), and its p1 and p3 equal the port's copy of the NumPy
push/pop model, as the script's check does."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from probe_scripts import load_script

from raytracer_tpu_torch.probes import vstack

torch.set_num_threads(2)


@pytest.fixture
def script(monkeypatch):
    """(the script module, the list its pallas calls' outputs go to)."""
    mod = load_script(monkeypatch, "vstack_probe.py", [])
    calls = []
    real = pl.pallas_call

    def recording(kernel, **kw):
        fn = real(kernel, interpret=True, **kw)

        def run(*args):
            out = fn(*args)
            calls.append([np.asarray(x) for x in (out if isinstance(out, (list, tuple))
                                                  else [out])])
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", recording)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    return mod, calls


@pytest.mark.parametrize("case", ("p1", "p3"))
def test_vstack_stack_matches_script_and_model(script, case):
    mod, calls = script
    assert getattr(mod, case)() == 0          # the script's own check passes
    pops, stack = vstack.vstack(case, vstack.CHECK_ITERS, "cpu")
    want_pops, want_stack = calls[0]
    assert np.array_equal(pops.numpy(), want_pops) and np.array_equal(stack.numpy(), want_stack)
    assert vstack.matches_model(case, pops, stack, vstack.CHECK_ITERS) == (True, True)
    if case == "p3":   # then the timing kernel, 20,000 iterations (4 calls)
        assert len(calls) == 5
        got = vstack.vstack("p3_timing", vstack.TIMING_ITERS, "cpu")
        assert np.array_equal(got.numpy(), calls[1][0])


@pytest.mark.parametrize("kind", ("vreg", "smem"))
def test_vstack_p2_matches_script(script, kind):
    mod, calls = script
    assert mod.p2() == 0
    assert len(calls) == 8                     # vreg x 4, then smem x 4
    want = calls[0 if kind == "vreg" else 4][0]
    got = vstack.vstack(f"p2_{kind}", vstack.TIMING_ITERS, "cpu")
    assert np.array_equal(got.numpy(), want) and want.dtype == np.float32


def test_vstack_model_teeth():
    """A stack that drops the pushes of one iteration, or the pointer
    stack's rows read top first, fail the model check."""
    pops, stack = vstack.vstack("p1", vstack.CHECK_ITERS, "cpu")
    bad = stack.clone()
    bad[1, :2] = bad[1, 2:4].clone()
    assert vstack.matches_model("p1", pops, bad, vstack.CHECK_ITERS)[1] is False
    p3_pops, p3_stack = vstack.vstack("p3", vstack.CHECK_ITERS, "cpu")
    assert vstack.matches_model("p1", p3_pops, p3_stack, vstack.CHECK_ITERS)[1] is False
    assert vstack.matches_model("p3", pops * 0, p3_stack, vstack.CHECK_ITERS)[0] is False
    with pytest.raises(ValueError, match="unknown case"):
        vstack.vstack("p4", 1, "cpu")


def test_vstack_work_and_dependence_steps():
    """The function's work per chain and iteration: a shift register's
    128-entry row move; the pointer stack's pushed values (the model's
    count) and one read; p2_smem's 3 stores and one load; 20 chain-uniform
    operations each. The dependence steps: a shuffle and a select an
    iteration for a shift register, two integer operations for the
    others."""
    _, stacks = vstack.model(70)
    assert vstack.pushes(70) == sum(len(s) for s in stacks) + int((vstack.model(70)[0] != 0).sum())
    n = 8 * 70
    assert vstack.work("p1", 70) == dict(bytes=2 * 4 * 1024, int32_ops=148 * n)
    assert vstack.work("p2_smem", 70)["int32_ops"] == 24 * n
    assert vstack.work("p3_timing", 70)["int32_ops"] == vstack.pushes(70) + 21 * n
    assert vstack.dependence_steps("p2_vreg", 70) == dict(alu=70, shfl=70)
    assert vstack.dependence_steps("p3", 70) == dict(alu=140, shfl=0)
