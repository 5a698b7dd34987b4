"""raytracer_tpu_torch building blocks of the plain versions ≡ the JAX
ops: sphere intersection, material lookup and scatter, triangle brute
force. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import materials as jmat
from raytracer_tpu.ops import sphere as jsphere
from raytracer_tpu.ops import triangle as jtri
from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu.utils import ktf as jktf
from raytracer_tpu_torch.ops import materials as tmat
from raytracer_tpu_torch.ops import sphere as tsphere
from raytracer_tpu_torch.ops import triangle as ttri
from raytracer_tpu_torch.scene import builder as tbuilder
from raytracer_tpu_torch.utils import ktf

torch.set_num_threads(2)


def _rays(seed, n, spread=0.3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("t_max", [3e38, 0.4])
def test_intersect_spheres_matches(t_max):
    js, ts = jbuilder.cornell_materials_scene("assets/models"), tbuilder.cornell_materials_scene(
        build_bvh=False)
    o, d = _rays(1, 8192)
    jt, jid = jsphere.intersect_spheres(jnp.asarray(o), jnp.asarray(d), js.spheres.center,
                                        js.spheres.radius, 1e-3, t_max)
    tt, tid = tsphere.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d),
                                        ts.spheres.center, ts.spheres.radius, 1e-3, t_max)
    jt, jid = np.asarray(jt), np.asarray(jid)
    tt, tid = tt.numpy(), tid.numpy()
    # On the r=999 ground sphere (index 0) |oc|^2 - r^2 cancels about six
    # digits, so the order in which XLA and the port round shows in t at
    # the 1e-4 level, and a ray that grazes it may hit in one and miss in
    # the other (at most 1 ray in 1000). The small spheres agree to 1e-5.
    jhit, thit = jt < 1e30, tt < 1e30
    differ = (jhit != thit) | (jid != tid)
    assert ((jid[differ] == 0) | (tid[differ] == 0)).all()
    assert differ.sum() <= len(jt) // 1000
    ground = ~differ & (jid == 0) & jhit
    small = ~differ & ~ground
    np.testing.assert_allclose(tt[small], jt[small], rtol=1e-5)
    np.testing.assert_allclose(tt[ground], jt[ground], rtol=0, atol=1e-3)
    assert jhit.mean() > 0.05 and ((jid > 0) & jhit).any()


def _shading_inputs(seed, n, n_mat):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    front = (d * nrm).sum(1) < 0
    nrm = np.where(front[:, None], nrm, -nrm).astype(np.float32)
    mid = rng.integers(-1, n_mat + 1, n).astype(np.int32)  # off-table ids too
    pix = rng.integers(0, 1 << 20, n).astype(np.int32)
    return d, nrm, front, mid, pix


def test_lookup_and_scatter_params_match():
    js = jbuilder.cornell_materials_scene("assets/models")
    ts = tbuilder.cornell_materials_scene(build_bvh=False)
    d, nrm, front, mid, pix = _shading_inputs(2, 4096, ts.materials.count)
    jp = jmat.lookup_params(js.materials, jnp.asarray(mid))
    tp = tmat.lookup_params(ts.materials, torch.from_numpy(mid))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jsmp = jktf.sampler(jax.random.key(3), pix, 5, 2)
    tsmp = ktf.sampler(3, torch.from_numpy(pix), 5, 2)
    jr = jmat.scatter_params(jsmp, jnp.asarray(d), jnp.asarray(nrm), jnp.asarray(front), jp)
    tr = tmat.scatter_params(tsmp, torch.from_numpy(d), torch.from_numpy(nrm),
                             torch.from_numpy(front), tp)
    np.testing.assert_allclose(tr.direction.numpy(), np.asarray(jr.direction), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tr.attenuation.numpy(), np.asarray(jr.attenuation))
    np.testing.assert_array_equal(tr.is_light.numpy(), np.asarray(jr.is_light))
    np.testing.assert_array_equal(tr.emission.numpy(), np.asarray(jr.emission))
    # `scattered` flips only where metal_ok sits on its boundary.
    assert (tr.scattered.numpy() != np.asarray(jr.scattered)).mean() < 1e-3

    # The fused kernel's restatement of the same scatter agrees with it.
    inv_dl = 1.0 / torch.linalg.vector_norm(torch.from_numpy(d), dim=-1)
    scd, att, scattered = tmat.scatter_fused(
        torch.from_numpy(d), torch.from_numpy(nrm), torch.from_numpy(front), inv_dl, tp,
        tsmp.unit_vector(ktf.SCATTER), tsmp.uniform(ktf.DIELECTRIC))
    np.testing.assert_allclose(scd.numpy(), tr.direction.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(att.numpy(), tr.attenuation.numpy())
    assert (scattered.numpy() != tr.scattered.numpy()).mean() < 1e-3


def test_triangle_brute_force_matches():
    rng = np.random.default_rng(4)
    verts = rng.uniform(-1, 1, (120, 3)).astype(np.float32)
    faces = rng.integers(0, 120, (200, 3)).astype(np.int32)
    o, d = _rays(5, 1024, spread=3.0)
    jt, jid = jtri.intersect_tris_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts),
                                        jnp.asarray(faces), 1e-3, 3e38)
    tt, tid = ttri.intersect_tris_brute(torch.from_numpy(o), torch.from_numpy(d),
                                        torch.from_numpy(verts), torch.from_numpy(faces),
                                        1e-3, 3e38)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    hit = np.asarray(jt) < 1e30
    np.testing.assert_array_equal(tid.numpy()[hit], np.asarray(jid)[hit])
