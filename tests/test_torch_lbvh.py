"""raytracer_tpu_torch's LBVH (ops/bvh.build_lbvh), its single-triangle
test and its lockstep traversal (ops/traverse.intersect_bvh) ≡ the JAX
package's.

The Morton codes, the clz helper and the tree are bitwise: left, right
and prim_index exactly, node_min / node_max bit for bit. XLA compiles
the codes' `centroid - lo` into a fused multiply-add with the centroid's
product; the port's `_fma32` is checked against exact rational
arithmetic, hard cases (a product on a float32 midpoint) included.
Random meshes share one size, so JAX compiles its jitted build once. The
single-triangle test is bitwise against JAX's evaluated op by op; under
jit XLA contracts its products, so the traversal's t is held to rtol 1e-4
(the tests/test_pallas_traverse.py rule), ids equal wherever there is a
hit (they are equal everywhere here)."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu.ops import bvh as jbvh
from raytracer_tpu.ops import triangle as jtri
from raytracer_tpu.ops.traverse import intersect_bvh as jintersect_bvh
from raytracer_tpu.scene.types import TriMesh as JTriMesh
from raytracer_tpu_torch.convert import bvh_from_numpy, to_numpy_tree
from raytracer_tpu_torch.ops import bvh as tbvh
from raytracer_tpu_torch.ops import packets
from raytracer_tpu_torch.ops import traverse as ttraverse
from raytracer_tpu_torch.ops.triangle import intersect_tri_single
from raytracer_tpu_torch.scene.types import TriMesh
from raytracer_tpu_torch.utils import profiling

torch.set_num_threads(2)

T = 512  # every random mesh: one JAX compile of build_lbvh
FIELDS = ("left", "right", "node_min", "node_max", "prim_index")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _random_mesh(seed, t=T, v=300):
    rs = np.random.default_rng(seed)
    return (rs.uniform(-1, 1, (v, 3)).astype(np.float32),
            rs.integers(0, v, (t, 3)).astype(np.int32),
            rs.integers(0, 5, t).astype(np.int32))


def _both(verts, faces, fmat):
    return (JTriMesh(vertices=jnp.asarray(verts), faces=jnp.asarray(faces),
                     face_mat=jnp.asarray(fmat)),
            TriMesh.from_arrays(verts, faces, fmat))


def _assert_same_tree(jb, tb):
    for f in FIELDS:
        want, got = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert want.dtype == got.dtype and want.shape == got.shape, f
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f)


def test_morton3d_matches_jax():
    rs = np.random.default_rng(0)
    p = rs.uniform(-0.1, 1.1, (20000, 3)).astype(np.float32)
    p[:6] = [[0, 0, 0], [1, 1, 1], [1023 / 1024, 0.5, 1e-9], [-1, 2, 0.999],
             [0.5, 0.5, 0.5], [np.nextafter(np.float32(1), np.float32(0))] * 3]
    want = np.asarray(jbvh.morton3d(jnp.asarray(p))).astype(np.int64)
    np.testing.assert_array_equal(packets.morton3d(torch.from_numpy(p)).numpy(), want)


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest the rational x (ties to even)."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - x),
                                     int(np.asarray(y).view(np.int32)) & 1))


def test_fma32_rounds_once():
    rs = np.random.default_rng(7)
    a = rs.normal(size=3000).astype(np.float32)
    b = rs.normal(size=3000).astype(np.float32)
    c = (rs.normal(size=3000) * rs.choice([1e-9, 1.0, 1e9], 3000)).astype(np.float32)
    # A product exactly on a float32 midpoint, nudged by a tiny c either way:
    # rounding the sum twice (to float64, then float32) goes wrong here.
    m = np.float32(1 + 2 ** -12)
    a[:4], b[:4] = m, m
    c[:4] = [2.0 ** -60, -2.0 ** -60, 0.0, -(1 + 2 ** -11)]
    got = tbvh._fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.asarray([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[0] != got[1]


def test_clz32_matches_jax():
    rs = np.random.default_rng(1)
    x = rs.integers(0, 2 ** 32, 50000, dtype=np.uint64)
    x[:34] = [0, 2 ** 32 - 1] + [1 << k for k in range(32)]
    x[34:66] = [(1 << k) - 1 for k in range(1, 33)]
    want = np.asarray(jbvh._clz32(jnp.asarray(x.astype(np.uint32))))
    got = tbvh._clz32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_lbvh_matches_jax_on_random_meshes(seed):
    jm, tm = _both(*_random_mesh(seed))
    _assert_same_tree(jbvh.build_lbvh(jm), tbvh.build_lbvh(tm))


def test_build_lbvh_equal_codes_keep_the_face_order():
    """Many triangles with one centroid (so one Morton code): JAX's sort
    keeps equal codes in face order (a stable sort), as torch.sort(stable=True)
    does, and the ties split by leaf index in both."""
    verts, faces, fmat = _random_mesh(3)
    faces[100:400] = faces[7]            # 300 copies of one triangle
    faces[450:480] = faces[450][::-1]    # same centroid, reversed winding
    jm, tm = _both(verts, faces, fmat)
    jb, tb = jbvh.build_lbvh(jm), tbvh.build_lbvh(tm)
    _assert_same_tree(jb, tb)
    prim = tb.prim_index.numpy()
    run = prim[np.isin(prim, np.r_[7, 100:400])]
    assert np.all(np.diff(run) > 0)       # ascending face ids within the run


def test_build_lbvh_single_triangle():
    """T == 1: one dummy internal node pointing twice at the leaf, the flat
    axis padded by 5e-7."""
    verts = np.asarray([[0.1, 0.5, -0.2], [0.7, 0.5, 0.3], [0.2, 0.5, 0.9]], np.float32)
    jm, tm = _both(verts, np.asarray([[0, 1, 2]], np.int32), np.zeros(1, np.int32))
    jb, tb = jbvh.build_lbvh(jm), tbvh.build_lbvh(tm)
    _assert_same_tree(jb, tb)
    assert tb.left.tolist() == [1] and tb.node_min.shape == (2, 3)


def test_intersect_tri_single_matches_jax_op_by_op():
    rs = np.random.default_rng(4)
    n = 20000
    o, d, v0, e1, e2 = (rs.normal(size=(n, 3)).astype(np.float32) for _ in range(5))
    t_max = rs.uniform(-1, 8, n).astype(np.float32)
    with jax.disable_jit():
        jok, jt = jtri.intersect_tri_single(*(jnp.asarray(x) for x in (o, d, v0, e1, e2)),
                                            1e-3, jnp.asarray(t_max))
    ok, t = intersect_tri_single(*(torch.from_numpy(x) for x in (o, d, v0, e1, e2)),
                                 1e-3, torch.from_numpy(t_max))
    assert ok.any() and not ok.all()
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(jt))


@pytest.mark.parametrize("limit", ["big", "per_ray"])
def test_intersect_bvh_matches_jax(limit):
    verts, faces, fmat = _random_mesh(0)
    jm, tm = _both(verts, faces, fmat)
    jb = jbvh.build_lbvh(jm)
    tb = bvh_from_numpy(to_numpy_tree(jb))
    rs = np.random.default_rng(5)
    o = rs.uniform(-3, 3, (2048, 3)).astype(np.float32)
    d = rs.normal(size=(2048, 3)).astype(np.float32)
    d[:5, 1] = 0.0   # axis-parallel rays: ±inf in 1/d
    t_max = (np.float32(3e38) if limit == "big"
             else rs.uniform(-0.5, 4.0, 2048).astype(np.float32))
    jt, jid = jintersect_bvh(jnp.asarray(o), jnp.asarray(d), jm, jb, 1e-3, jnp.asarray(t_max))
    with profile(activities=[ProfilerActivity.CPU]):
        t, tid = ttraverse.intersect_bvh(torch.from_numpy(o), torch.from_numpy(d), tm, tb, 1e-3,
                                         torch.as_tensor(t_max))
    calls = [r for r in profiling.recorded() if r.name == "rt.lbvh.traverse"]
    jt, jid = np.asarray(jt), np.asarray(jid)
    hit = jt < 1e30
    assert hit.mean() > 0.03
    np.testing.assert_array_equal(t.numpy() < 1e30, hit)
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-4)
    np.testing.assert_array_equal(tid.numpy()[hit], jid[hit])
    np.testing.assert_array_equal(tid.numpy(), jid)
    assert tid.dtype == torch.int32
    c = calls[0].counts
    assert len(calls) == 1
    assert c["host_reads"] == c["lbvh.steps"] + 1 and c["lbvh.steps"] > 10
