"""raytracer_tpu_torch fused path loop (plain version of K3) ≡ the JAX
fused Pallas kernel in interpret mode: several packets, roulette active
past min_bounces, sample regeneration — the whole integrator contract."""

import numpy as np
import pytest
import torch
from torch_fused_ref import materials_scenes, render_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    return materials_scenes()


def test_plain_matches_jax_fused_deep(scenes):
    """The cross-compiler tolerance of tests/test_fused_megakernel.py:70-73:
    at most 0.5% of elements beyond 5e-4 + 2e-4|x|, means within 1e-3."""
    out, ref = render_pair(scenes, 5, width=256, height=16, spp=4, max_bounces=8)
    bad = np.abs(out - ref) > (5e-4 + 2e-4 * np.abs(ref))
    assert bad.mean() < 0.005, f"{bad.sum()}/{bad.size} elements diverge"
    np.testing.assert_allclose(out.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), atol=1e-3, rtol=1e-3)
