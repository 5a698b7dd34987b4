"""K1's cull of the brute pre-pass (csrc/traverse.cuh `brute_skip`, its
plain mirror ops/cuda_traverse.brute_may_hit) never skips a triangle that
the exhaustive float32 Möller–Trumbore test would accept, so the culled
pre-pass gives the exhaustive one's hit record bit for bit.

The property is checked where rounding is worst: rays aimed at vertices
and edges, grazing rays nearly parallel to a triangle's plane, origins on
the plane, axis-parallel directions with ±0 components, origins on a
box's faces, and t_best / t_min at an accepted t. On the reference scene's
32 brute triangles and on a synthetic set (thin, tiny, large, far from the
origin, axis-aligned, a zero edge)."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from raytracer_tpu_torch.camera import generate_rays, showcase_camera
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import cuda_traverse as ct
from raytracer_tpu_torch.ops.bvh4 import BIG, Bvh4
from raytracer_tpu_torch.ops.triangle import moller_trumbore
from raytracer_tpu_torch.scene.builder import reference_scene
from raytracer_tpu_torch.utils import ktf

torch.set_num_threads(2)
T_MIN = 1e-3


@pytest.fixture(scope="module")
def ref_bvh():
    return reference_scene().bvh4


def _synthetic_tri() -> np.ndarray:
    """f32[14, 9] (v0, e1, e2) near the unit cube: random, thin, tiny,
    axis-aligned quads of three walls, and one row with a zero edge."""
    rng = np.random.default_rng(11)
    rows = []
    for _ in range(5):
        v0 = rng.uniform(-1, 1, 3)
        rows.append(np.concatenate([v0, rng.normal(size=3), rng.normal(size=3)]))
    rows.append(np.concatenate([[0.1, 0.2, 0.3], [1.2, 0.0, 0.0], [0.6, 1e-4, 0.0]]))  # thin
    rows.append(np.concatenate([[0.5, -0.5, 0.2], [1e-3, 0, 0], [0, 1e-3, 1e-4]]))     # tiny
    for axis in range(3):                                                            # walls
        e1, e2 = np.zeros(3), np.zeros(3)
        e1[(axis + 1) % 3], e2[(axis + 2) % 3] = 1.0, 1.0
        v0 = np.full(3, -0.5)
        rows.append(np.concatenate([v0, e1, e2]))
        rows.append(np.concatenate([v0 + e1 + e2, -e1, -e2]))
    rows.append(np.concatenate([[0.2, 0.2, 0.2], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))   # zero edge
    return np.asarray(rows, np.float32)


def _brute_only(tri: np.ndarray) -> Bvh4:
    """A tree whose root is empty, with `tri` as its brute set."""
    t = torch.from_numpy(tri)
    tb = t.shape[0]
    return Bvh4(bounds=torch.full((1, 8, 6), float("inf")),
                children=torch.full((1, 8), -1, dtype=torch.int32),
                tri=torch.zeros((8, 9)), prim_index=torch.full((8,), -1, dtype=torch.int32),
                face_mat=torch.zeros((8,), dtype=torch.int32), brute_tri=t,
                brute_prim=torch.arange(tb, dtype=torch.int32),
                brute_mat=torch.arange(tb, dtype=torch.int32) % 5, brute_box=ct.brute_boxes(t))


@pytest.fixture(scope="module")
def sets(ref_bvh):
    """The brute sets: the reference scene's, the synthetic one, and the
    synthetic one moved far from the origin (1000, -2000, 500), where the
    cull measures distances from the set's own centre."""
    synth = _synthetic_tri()
    far = synth.copy()
    far[:, 0:3] += np.float32([1000.0, -2000.0, 500.0])
    return {"reference": ref_bvh, "synthetic": _brute_only(synth), "far": _brute_only(far)}


KINDS = ("vertex", "edge", "inside", "outside", "grazing", "on_plane", "axis", "box_face")


def _rays(tri: np.ndarray, boxes: np.ndarray, kind: str, seed: int, n: int):
    """n rays (o, d, triangle index) of one kind aimed at the triangles."""
    rng = np.random.default_rng(seed)
    j = rng.integers(0, tri.shape[0], n)
    v0, e1, e2 = (tri[j, 3 * k:3 * k + 3].astype(np.float64) for k in range(3))
    nrm = np.cross(e1, e2)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-300)
    scale = np.maximum(np.abs(e1).max(1), np.abs(e2).max(1))[:, None] + 1e-6
    if kind == "vertex":
        u = rng.integers(0, 3, n)
        bary = np.stack([(u == 1), (u == 2)], 1).astype(np.float64)
    elif kind == "edge":
        t = rng.uniform(size=n)
        e = rng.integers(0, 3, n)
        bary = np.where((e == 0)[:, None], np.stack([t, 0 * t], 1),
                        np.where((e == 1)[:, None], np.stack([0 * t, t], 1),
                                 np.stack([t, 1 - t], 1)))
    elif kind == "outside":
        bary = rng.uniform(-0.3, 1.3, (n, 2))
    else:
        a, b = rng.uniform(size=n), rng.uniform(size=n)
        flip = a + b > 1
        bary = np.stack([np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)], 1)
    p = v0 + bary[:, :1] * e1 + bary[:, 1:] * e2
    # Offsets of the target off the plane, from 0 to a tenth of the triangle.
    off = rng.choice([0.0, 1.0], n) * 10 ** rng.uniform(-12, -1, n) * rng.choice([-1, 1], n)
    p = p + (off[:, None] * scale) * nrm
    d = rng.normal(size=(n, 3))
    if kind in ("grazing", "on_plane"):
        d = d - (d * nrm).sum(1, keepdims=True) * nrm
        eps = rng.choice([0.0, 1.0], n) * 10 ** rng.uniform(-10, -1, n) * rng.choice([-1, 1], n)
        d = d / np.linalg.norm(d, axis=1, keepdims=True) + eps[:, None] * nrm
    if kind == "axis":
        axis = rng.integers(0, 3, n)
        d = np.zeros((n, 3)) * rng.choice([-1.0, 1.0], (n, 3))     # ±0 components
        d[np.arange(n), axis] = rng.choice([-1.0, 1.0], n) * 10 ** rng.uniform(-3, 3, n)
    d = d * 10 ** rng.uniform(-2, 2, (n, 1))
    t0 = 10 ** rng.uniform(-3, 1, n)
    o = p - t0[:, None] * d
    if kind == "on_plane":
        o = p - t0[:, None] * (d - (d * nrm).sum(1, keepdims=True) * nrm)
    if kind == "box_face":
        # Origins with one coordinate exactly on a face of the padded box.
        axis = rng.integers(0, 3, n)
        side = rng.integers(0, 2, n)
        o[np.arange(n), axis] = boxes[j, 4 * side + axis]
        flat = rng.uniform(size=n) < 0.5   # and no motion along it: 0 * inf
        d[flat, axis[flat]] = rng.choice([-0.0, 0.0], int(flat.sum()))
    return o.astype(np.float32), d.astype(np.float32), j


def _check_never_culls_a_hit(tri, boxes, o, d, j, t_lim_kind):
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    tri_t = torch.from_numpy(tri)
    rec = tri_t[torch.from_numpy(j)]
    ok, t = moller_trumbore(o_t, d_t, rec[:, 0:3], rec[:, 3:6], rec[:, 6:9])
    n = o.shape[0]
    t_min = T_MIN
    if t_lim_kind == "big":
        t_best = torch.full((n,), float(BIG))
    elif t_lim_kind == "at_t":
        # The smallest t_best that accepts t, and t_min at t itself.
        t_best = torch.nextafter(t, torch.tensor(float("inf")))
        t_min = None
    else:
        t_best = torch.from_numpy(np.random.default_rng(3).uniform(0, 4, n).astype(np.float32))
    mins = t if t_min is None else torch.full((n,), t_min)
    acc = ok & (t >= mins) & (t < t_best)
    may = ct.brute_may_hit(o_t, d_t, torch.from_numpy(boxes), mins, t_best)
    may = may[torch.arange(n), torch.from_numpy(j)]
    bad = acc & ~may
    assert not bool(bad.any()), (
        f"culled an accepted triangle: ray {int(torch.nonzero(bad)[0])} "
        f"o={o[bad.numpy()][0].tolist()} d={d[bad.numpy()][0].tolist()} "
        f"tri={j[bad.numpy()][0]} t={float(t[bad][0])}")
    return int(acc.sum())


@pytest.mark.parametrize("which", ["reference", "synthetic", "far"])
@settings(max_examples=80, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(kind=st.sampled_from(KINDS), seed=st.integers(0, 2**31 - 1),
       t_lim=st.sampled_from(["big", "random"]))
def test_cull_never_skips_an_accepted_triangle(sets, which, kind, seed, t_lim):
    bvh = sets[which]
    tri = bvh.brute_tri.numpy()
    boxes = bvh.brute_box.numpy()
    o, d, j = _rays(tri, boxes, kind, seed, 4096)
    _check_never_culls_a_hit(tri, boxes, o, d, j, t_lim)


@pytest.mark.parametrize("which", ["reference", "synthetic", "far"])
def test_cull_at_the_accepted_t(sets, which):
    """t_min equal to MT's t and t_best one ulp above it: the tightest
    interval that accepts, for every kind of ray."""
    bvh = sets[which]
    tri = bvh.brute_tri.numpy()
    boxes = bvh.brute_box.numpy()
    accepted = 0
    for k, kind in enumerate(KINDS):
        o, d, j = _rays(tri, boxes, kind, 900 + k, 96)
        accepted += _check_never_culls_a_hit(tri, boxes, o, d, j, "at_t")
    assert accepted > 100


def test_grazing_rays_fail_the_guard(ref_bvh):
    """Unit rays within 1e-8 to 3e-6 of a triangle's plane, 0.05-1 away,
    aimed near it: MT's t is rounding noise there, so MT accepts some of
    them where the ray misses the padded box. The box test alone would
    skip those; the guard sends them to MT."""
    tri = ref_bvh.brute_tri.numpy()
    rng = np.random.default_rng(5)
    n = 65536
    j = rng.integers(0, tri.shape[0], n)
    v0, e1, e2 = (tri[j, 3 * k:3 * k + 3].astype(np.float64) for k in range(3))
    nrm = np.cross(e1, e2)
    nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    d = rng.normal(size=(n, 3))
    d = d - (d * nrm).sum(1, keepdims=True) * nrm
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = d + (10 ** rng.uniform(-8, -5.5, n) * rng.choice([-1, 1], n))[:, None] * nrm
    uv = rng.uniform(-0.2, 1.2, (n, 2))
    p = v0 + uv[:, :1] * e1 + uv[:, 1:] * e2
    p = p + (10 ** rng.uniform(-9, -4, n) * rng.choice([-1, 1], n))[:, None] * nrm
    o_t = torch.from_numpy((p - rng.uniform(0.05, 1.0, (n, 1)) * d).astype(np.float32))
    d_t = torch.from_numpy(d.astype(np.float32))
    boxes = ref_bvh.brute_box
    box_only = boxes.clone()
    box_only[:-1, 8:11] = float("inf")   # |d . m| >= sd always: the box test alone
    rec = ref_bvh.brute_tri[torch.from_numpy(j)]
    ok, t = moller_trumbore(o_t, d_t, rec[:, 0:3], rec[:, 3:6], rec[:, 6:9])
    acc = ok & (t >= T_MIN)
    big = torch.full((n,), float(BIG))
    idx = torch.arange(n), torch.from_numpy(j)
    with_guard = ct.brute_may_hit(o_t, d_t, boxes, T_MIN, big)[idx]
    without = ct.brute_may_hit(o_t, d_t, box_only, T_MIN, big)[idx]
    assert not bool((acc & ~with_guard).any())
    assert int((acc & ~without).sum()) > 0, "the box test alone should skip some noisy hits"


def test_brute_boxes_made_once_per_scene():
    """The builder makes the cull table once, with the brute set;
    `.to(device)` carries it and the culled pre-pass reads it without
    making another. The padded boxes contain their triangles' vertices,
    and the last row holds the centre and a radius that bounds every
    vertex."""
    before = ct.BOX_BUILDS["brute_boxes"]
    ref_bvh = reference_scene().bvh4
    assert ct.BOX_BUILDS["brute_boxes"] == before + 1
    first = ref_bvh.brute_box
    moved = ref_bvh.to("cpu")
    assert moved.brute_box is first
    o, d, t_lim = _scene_rays(moved, 3, 256)
    ct.brute_prepass_plain(o, d, moved, t_lim, T_MIN)
    assert ct.BOX_BUILDS["brute_boxes"] == before + 1

    tri = ref_bvh.brute_tri.double()
    verts = torch.stack([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6], tri[:, 0:3] + tri[:, 6:9]], 1)
    box = first.double()
    assert bool((box[:-1, None, 0:3] < verts).all() and (verts < box[:-1, None, 4:7]).all())
    c, r = box[-1, 0:3], box[-1, 3]
    assert bool(((verts - c).abs().amax(-1) <= r).all())
    assert first.shape == (tri.shape[0] + 1, 12)


def _scene_rays(bvh, seed: int, n: int = 4096):
    """n rays: showcase-camera rays of the 2K frame, rays from seeded
    points inside the brute set's box, and bounce rays leaving the
    exhaustive pre-pass's hits in seeded directions on the hit side."""
    rng = np.random.default_rng(seed)
    m = n // 4
    cfg = RenderConfig(width=2560, height=1440, spp=8, max_bounces=20)
    px = torch.from_numpy(rng.integers(0, cfg.width, m).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, cfg.height, m).astype(np.int32))
    o_cam, d_cam = generate_rays(showcase_camera(cfg), px, py, cfg.width, cfg.height,
                                 ktf.sampler(0, py * cfg.width + px))
    box = bvh.brute_box
    o_cam = o_cam + box[-1, 0:3]    # the camera moves with the set's centre
    lo, hi = box[:-1, 0:3].amin(0), box[:-1, 4:7].amax(0)
    o_in = lo + (hi - lo) * torch.from_numpy(rng.uniform(0.05, 0.95, (n - 2 * m, 3))
                                             .astype(np.float32))
    d_in = torch.from_numpy(rng.normal(size=(n - 2 * m, 3)).astype(np.float32))
    src_o = torch.cat([o_cam, o_in])[:m]
    src_d = torch.cat([d_cam, d_in])[:m]
    t, prim, _, nrm, _ = ct.brute_prepass_plain(src_o, src_d, bvh, torch.full((m,), float(BIG)),
                                                T_MIN, cull=False)
    hit = prim >= 0
    p = src_o + torch.where(hit, t, torch.zeros_like(t))[:, None] * src_d
    side = torch.where(((src_d * nrm).sum(1) < 0)[:, None], nrm, -nrm)
    w = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    d_b = torch.where(((w * side).sum(1) < 0)[:, None], -w, w)
    o = torch.cat([o_cam, o_in, p]).contiguous()
    d = torch.cat([d_cam, d_in, d_b]).contiguous()
    t_lim = torch.from_numpy(np.where(rng.uniform(size=n) < 0.75, np.float32(BIG),
                                      rng.uniform(-0.5, 1.5, n).astype(np.float32)))
    return o, d, t_lim


@pytest.mark.parametrize("which", ["reference", "synthetic", "far"])
def test_culled_prepass_equals_exhaustive(sets, which):
    """The culled pre-pass (triangles in index order, each against the
    running best, skipped where the cull says so) gives the exhaustive
    pre-pass of the plain traversal bit for bit on 4,096 seeded rays, and
    tests fewer triangles."""
    bvh = sets[which]
    o, d, t_lim = _scene_rays(bvh, 21)
    t, prim, mat, nrm, tests = ct.brute_prepass_plain(o, d, bvh, t_lim, T_MIN, cull=True)
    # The plain traversal on the brute set alone (a tree whose root is
    # empty) is the exhaustive pre-pass.
    empty = dataclasses.replace(bvh, bounds=torch.full((1, 8, 6), float("inf")),
                                children=torch.full((1, 8), -1, dtype=torch.int32))
    ref = ct._traverse_plain(o, d, empty, t_lim, T_MIN)
    for got, want in zip((t, prim, mat, nrm), ref):
        assert torch.equal(got.view(torch.int32) if got.is_floating_point() else got,
                           want.view(torch.int32) if want.is_floating_point() else want)
    live = t_lim > T_MIN
    tb = bvh.brute_tri.shape[0]
    assert int(tests[~live].sum()) == 0
    # The cull does cull: 3.3 of 32 MTs per live ray on the reference
    # scene, 4.1 of 14 on the synthetic set (its triangles are large).
    limit = 0.15 if which == "reference" else 0.4
    assert int(tests.sum()) < limit * tb * int(live.sum())
    assert int((prim >= 0).sum()) > 0.2 * o.shape[0]
