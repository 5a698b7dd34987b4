"""Helpers of tests/test_torch_probes*.py: the probe scripts of scripts/
imported as they are, and the tolerance their outputs are held to.

The scripts read sys.argv at import (ITERS, and the packet count of
kernel_ablate_v8.py), so argv is patched first; kernel_ablate_v8.py calls
jaxcache.enable() at import, which is stubbed.

Tolerance: the port's plain version and the script's kernel in interpret
mode agree except where XLA's CPU contraction of multiply-adds flips a
near-tie (tests/test_torch_traverse.py:66): at most 0.5% of elements
beyond 1e-4·|x| + 1e-6 (NaN equals NaN)."""

import importlib.util
import os
import sys

import numpy as np

from raytracer_tpu.utils import jaxcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Tracing dominates the cost of an interpret-mode run; 6 iterations reach
# the stacks' pops at the same cost as 2.
PACKETS, ITERS = 2, 6
BAD_FRAC, RTOL, ATOL = 0.005, 1e-4, 1e-6


def load_script(monkeypatch, name: str, argv):
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    monkeypatch.setattr(jaxcache, "enable", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(f"_probe_{name[:-3]}",
                                                  os.path.join(ROOT, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def agree(got, want) -> int:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    both_nan = np.isnan(got) & np.isnan(want)
    bad = ~both_nan & ~(np.abs(got - want) <= ATOL + RTOL * np.abs(want))
    assert bad.mean() <= BAD_FRAC, f"{bad.sum()} of {bad.size} elements differ"
    return int(bad.sum())
