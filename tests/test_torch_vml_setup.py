"""Importing raytracer_tpu_torch sets up MKL's VML on one thread, so the first
multi-threaded float kernel of a process (torch.sqrt of 100,000 elements on
8 threads here) is as accurate as any later one (within 1e-6 of the float64
root; VML's sqrt is within an ulp, not correctly rounded). Without it, that
first call could race in MKL's set-up and return ~12-bit square roots for
one thread's chunk (the cause of test_sampler_methods_match[0]'s
order-dependent failures)."""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

PROCESSES = 24

CHILD = """
import numpy as np
import torch
import raytracer_tpu_torch  # noqa: F401
torch.set_num_threads(8)
u = torch.from_numpy(np.random.default_rng(0).random(100_000, dtype=np.float32))
exact = np.sqrt(u.numpy().astype(np.float64))
print(int((np.abs(torch.sqrt(u).numpy() - exact) > 1e-6).sum()))
"""


def test_first_threaded_sqrt_is_exact_after_import():
    def run(_):
        out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        return int(out.stdout.split()[-1])

    with ThreadPoolExecutor(8) as pool:
        wrong = list(pool.map(run, range(PROCESSES)))
    assert wrong == [0] * PROCESSES
