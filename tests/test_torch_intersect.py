"""raytracer_tpu_torch.ops.intersect and K4's coherence-sort path ≡ the
JAX package.

The sort keys are integers: bitwise. K4 gives every ray its own walk, so
the sorted and unsorted records of the port are bitwise equal (the
comparison with JAX's Pallas sort path is tests/test_torch_intersect_pallas.py).
intersect_scene's hit decisions are exact; shade_hit's recomputed
attributes agree to 1e-5. A scene that holds only the LBVH goes through
the lockstep traversal (ops/traverse.intersect_bvh) in both packages:
ids equal, t within rtol 1e-4 (XLA contracts its products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import intersect as jis
from raytracer_tpu.ops.bvh import build_lbvh as jbuild_lbvh
from raytracer_tpu.ops.packets import _coherence_keys
from raytracer_tpu.scene.builder import build_scene_bvh4 as jbuild_bvh4
from raytracer_tpu.scene.builder import cornell_materials_scene, cornell_spheres_scene
from raytracer_tpu.scene.types import TriMesh as JTriMesh
from raytracer_tpu_torch.convert import bvh4_from_numpy, scene_from_numpy, to_numpy_tree
from raytracer_tpu_torch.ops import intersect as tis
from raytracer_tpu_torch.ops.bvh4 import BIG
from raytracer_tpu_torch.ops.cuda_traverse import intersect_bvh4, trace_closest
from raytracer_tpu_torch.ops.packets import coherence_keys, root_box

torch.set_num_threads(2)


def _mesh(seed, t=300, v=220):
    rs = np.random.default_rng(seed)
    return (rs.uniform(-1, 1, (v, 3)).astype(np.float32),
            rs.integers(0, v, (t, 3)).astype(np.int32),
            rs.integers(0, 5, t).astype(np.int32))


def _rays(seed, n, span=3.0):
    rs = np.random.default_rng(100 + seed)
    return (rs.uniform(-span, span, (n, 3)).astype(np.float32),
            rs.normal(size=(n, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def trees():
    """The JAX package's BVH8 (native builder) over a random mesh, and
    the same tables in the port."""
    verts, faces, fmat = _mesh(0)
    jm = JTriMesh(vertices=jnp.asarray(verts), faces=jnp.asarray(faces),
                  face_mat=jnp.asarray(fmat))
    jb = jbuild_bvh4(jm)
    return jb, bvh4_from_numpy(to_numpy_tree(jb))


def test_coherence_keys_bitwise(trees):
    jb4, b4 = trees
    o, d = _rays(0, 4096, span=1.5)
    d[:7, 0] = 0.0  # axis-parallel rays: the octant takes the >= 0 side
    lo, inv = root_box(b4)
    jlo = jnp.min(jb4.bounds[0, :, 0:3], axis=0)
    jhi = jnp.max(jnp.where(jb4.bounds[0, :, 3:6] > -BIG, jb4.bounds[0, :, 3:6], -BIG), axis=0)
    jinv = 1.0 / jnp.maximum(jhi - jlo, 1e-12)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    want = np.asarray(_coherence_keys(jnp.asarray(o), jnp.asarray(d), jlo, jinv))
    got = coherence_keys(torch.from_numpy(o), torch.from_numpy(d), lo, inv).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.max() >= 2**31  # octants 4-7 overflow int32: the keys are int64
    np.testing.assert_array_equal(np.argsort(got, kind="stable"),
                                  np.asarray(jnp.argsort(jnp.asarray(want))))


def _two_level_scene():
    """Spheres + a 300-triangle mesh with a few large faces split off
    into the brute pre-pass (the two-level layout of the bunny scene)."""
    verts, faces, fmat = _mesh(5, t=400, v=300)
    verts = 0.3 * verts
    big = np.float32([[-2, -0.5, -2], [2, -0.5, -2], [0, -0.5, 2.5],
                      [-2, 0.9, 2], [2, 0.9, 2], [0, 0.9, -2.5]])
    verts = np.concatenate([verts, big])
    faces = np.concatenate([faces, [[300, 301, 302], [303, 304, 305]]]).astype(np.int32)
    fmat = np.concatenate([fmat, [5, 6]]).astype(np.int32)
    base = cornell_spheres_scene()
    mesh = JTriMesh(vertices=jnp.asarray(verts), faces=jnp.asarray(faces),
                    face_mat=jnp.asarray(fmat))
    js = base.replace(mesh=mesh, bvh4=jbuild_bvh4(mesh))
    assert js.bvh4.brute_tri is not None
    return js


@pytest.mark.parametrize("which", ["spheres", "two_level"])
def test_intersect_scene_and_shade_hit_match(which):
    js = cornell_spheres_scene() if which == "spheres" else _two_level_scene()
    ts = scene_from_numpy(to_numpy_tree(js))
    o, d = _rays(3, 512, span=0.8)
    o[:128] = np.float32([0.0, 0.3, 1.6])  # toward the spheres
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    jids = jis.intersect_scene(js, jo, jd, 1e-3)
    tids = tis.intersect_scene(ts, to, td, 1e-3)
    for k in ("hit", "prim_type", "prim_id"):
        np.testing.assert_array_equal(getattr(tids, k).numpy(), np.asarray(getattr(jids, k)),
                                      err_msg=k)
    np.testing.assert_allclose(tids.t.numpy(), np.asarray(jids.t), rtol=1e-5)
    hit = tids.hit.numpy()
    assert hit.mean() > 0.5
    if which == "two_level":
        assert (tids.prim_type.numpy()[hit] == tis.PRIM_TRI).any()
    ja = jis.shade_hit(js, jo, jd, jids)
    ta = tis.shade_hit(ts, to, td, tids)
    for k in ("front_face", "mat_id"):
        np.testing.assert_array_equal(getattr(ta, k).numpy()[hit],
                                      np.asarray(getattr(ja, k))[hit], err_msg=k)
    for k in ("point", "normal", "uv"):
        np.testing.assert_allclose(getattr(ta, k).numpy()[hit], np.asarray(getattr(ja, k))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_sorted_equals_unsorted_bitwise(trees):
    _, b8 = trees
    o, d = (torch.from_numpy(x) for x in _rays(2, 2048, span=1.2))
    t_max = torch.from_numpy(np.random.default_rng(2).uniform(-0.5, 3.0, 2048).astype(np.float32))
    srt = trace_closest(o, d, b8, t_max, sort=True)
    uns = trace_closest(o, d, b8, t_max, sort=False)
    for k in srt:
        assert torch.equal(srt[k], uns[k]), k
    assert srt["hit"].float().mean() > 0.2
    t, tid = intersect_bvh4(o, d, b8, 1e-3, t_max)
    assert torch.equal(t, srt["t"]) and torch.equal(tid, srt["tri_id"])


def test_intersect_scene_detaches_the_search():
    """Gradients reach shading, never the hit decision."""
    ts = scene_from_numpy(to_numpy_tree(cornell_spheres_scene()))
    o, d = (torch.from_numpy(x) for x in _rays(4, 64, span=0.5))
    d = d.clone().requires_grad_(True)
    ids = tis.intersect_scene(ts, o, d, 1e-3)
    assert not ids.t.requires_grad
    attrs = tis.shade_hit(ts, o, d, ids)
    (g,) = torch.autograd.grad(attrs.point[ids.hit].sum(), d)
    assert torch.isfinite(g).all() and (g != 0).any()


@pytest.fixture(scope="module")
def lbvh_scene():
    """The JAX package's cornell_materials scene with only the LBVH
    (scene.bvh, no bvh4), and the port's conversion of it."""
    js = cornell_materials_scene()
    js = js.replace(bvh=jbuild_lbvh(js.mesh), bvh4=None)
    ts = scene_from_numpy(to_numpy_tree(js))
    assert ts.bvh4 is None and ts.bvh is not None
    moved = ts.to("cpu")   # Scene.to carries the LBVH (as the sharded paths' replicas do)
    assert torch.equal(moved.bvh.node_min, ts.bvh.node_min)
    return js, ts


def test_lbvh_only_scene_is_refused(lbvh_scene, monkeypatch, tmp_path):
    """Only the fused path refuses an LBVH-only scene (it needs a bvh4):
    the CLI's --integrator fused says so, and the wavefront takes
    intersect_scene instead of trace_frame_fused."""
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.models.fused import fused_available

    _, ts = lbvh_scene
    assert not tis.fused_trace_available(ts) and not fused_available(ts, None)
    monkeypatch.setattr(cli, "build_scene", lambda name, assets: ts)
    with pytest.raises(SystemExit, match="needs a bvh4 scene"):
        cli.main(["--integrator", "fused", "--device", "cpu", "--width", "8", "--height", "8",
                  "--out", str(tmp_path / "x.png")])


def test_lbvh_only_scene_matches_jax(lbvh_scene):
    """intersect_scene and shade_hit on a scene that holds only the LBVH
    (ops/traverse.intersect_bvh): ids equal, t within rtol 1e-4."""
    js, ts = lbvh_scene
    o, d = _rays(7, 1024, span=0.25)
    o[:512] = np.float32([0.0, 0.05, 0.29])   # the showcase camera's position
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    jids = jis.intersect_scene(js, jo, jd, 1e-3)
    tids = tis.intersect_scene(ts, to, td, 1e-3)
    for k in ("hit", "prim_type", "prim_id"):
        np.testing.assert_array_equal(getattr(tids, k).numpy(), np.asarray(getattr(jids, k)),
                                      err_msg=k)
    np.testing.assert_allclose(tids.t.numpy(), np.asarray(jids.t), rtol=1e-4)
    hit = tids.hit.numpy()
    assert (tids.prim_type.numpy()[hit] == tis.PRIM_TRI).mean() > 0.5
    ja, ta = jis.shade_hit(js, jo, jd, jids), tis.shade_hit(ts, to, td, tids)
    np.testing.assert_array_equal(ta.mat_id.numpy()[hit], np.asarray(ja.mat_id)[hit])
    np.testing.assert_allclose(ta.point.numpy()[hit], np.asarray(ja.point)[hit],
                               rtol=1e-4, atol=1e-5)


def test_lbvh_only_scene_renders_as_jax(lbvh_scene):
    """The differentiable renderer (render_image, the megakernel path) on
    the LBVH-only scene against JAX's, under the image tolerance (at most
    0.5% of elements beyond 5e-4 + 2e-4|x|, means within 1e-3)."""
    from raytracer_tpu.camera import showcase_camera as jshowcase_camera
    from raytracer_tpu.config import RenderConfig as JRenderConfig
    from raytracer_tpu.render import render_image as jrender_image
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.convert import camera_from_numpy
    from raytracer_tpu_torch.render import render_image

    js, ts = lbvh_scene
    kw = dict(width=16, height=8, spp=2, max_bounces=3)
    jcam = jshowcase_camera(JRenderConfig(**kw))
    want = np.asarray(jrender_image(js, jcam, JRenderConfig(**kw), jax.random.key(3)))
    with torch.no_grad():
        got = render_image(ts, camera_from_numpy(to_numpy_tree(jcam)), RenderConfig(**kw),
                           3).numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01
    assert (np.abs(got - want) > 5e-4 + 2e-4 * np.abs(want)).mean() <= 0.005
    assert abs(got.mean() - want.mean()) <= 1e-3


def test_bvh_path_below_jax_packet_min(monkeypatch):
    """Below the JAX package's PACKET_MIN_RAYS the port still takes the
    BVH path (K4 through its sort on the card, its plain version here):
    8 rays."""
    js = _two_level_scene()
    ts = scene_from_numpy(to_numpy_tree(js))
    o, d = _rays(6, 8, span=0.2)
    calls = []
    import raytracer_tpu_torch.ops.intersect as mod

    real = mod.intersect_bvh4
    monkeypatch.setattr(mod, "intersect_bvh4", lambda *a: calls.append(len(a[0])) or real(*a))
    tis.intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d), 1e-3)
    assert calls == [8]
    assert jis.PACKET_MIN_RAYS > 8
