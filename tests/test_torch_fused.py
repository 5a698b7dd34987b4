"""raytracer_tpu_torch fused path loop (plain version of K3) ≡ the JAX
fused Pallas kernel in interpret mode, one packet.

Both draw from the same ktf counters, so they trace the same paths;
only floating-point rounding differs (XLA's contraction and cos/sin
against PyTorch's)."""

import numpy as np
import pytest
import torch
from torch_fused_ref import materials_scenes, render_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    return materials_scenes()


def test_plain_matches_jax_fused_one_packet(scenes):
    """atol 2e-4 / rtol 1e-4 on every pixel but at most one in 500.

    The exception is a path that flips at an ill-conditioned decision:
    here (seed 21, pixel row 1, column 51) a diffuse bounce leaves the
    r=999 ground sphere almost tangentially, where |oc|^2 - r^2 is pure
    float32 rounding noise, so an ulp of difference upstream decides
    between re-hitting the sphere and seeing the sky. Both JAX
    integrators take the sky; the port re-hits the sphere. The port's
    kernel and plain version agree bit for bit on the card."""
    out, ref = render_pair(scenes, 21, width=128, height=8, spp=2, max_bounces=4)
    close = np.isclose(out, ref, atol=2e-4, rtol=1e-4).all(axis=-1)
    assert (~close).sum() <= close.size // 500, np.argwhere(~close)
    np.testing.assert_allclose(out[close], ref[close], atol=2e-4, rtol=1e-4)
