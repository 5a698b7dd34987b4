"""Scene builders for the milestone configs and the reference world (port
of raytracer_tpu/scene/builder.py).

The reference hardcodes its world inside the `createRandomWorld` device
kernel (CUDAKernels.h:56-84): loaded meshes + a ground sphere
(Lambertian 0.5, center (0,-1000,0), r=999) + a mirror sphere
(Metal (0.7,0.6,0.5) roughness 0, center (0.2,0.2,0), r=0.05). Here
scenes are host-side constructors returning tensor dataclasses on the
CPU; `Scene.to(device)` moves them.

`build_sphere_tree` builds the fused path loop's sphere tree (the
reference's scene-level BVH over its objects, Core/BVHNode.cuh:21-84),
which a scene of more than 16 spheres needs on the fused path.

As in the JAX module, missing asset files are generated
(scene/assets.ensure_assets; the default directory is the repository's
assets/models, where they are committed), and when the native BVH
builder is unavailable the tree comes from the LBVH (ops/bvh.build_lbvh,
collapsed by ops/bvh4.build_bvh4). Unlike the JAX module, that fallback
is taken on `NativeUnavailable` alone, and with a warning that names the
failure; the tree's `builder` field says which builder made it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings

import numpy as np
import torch

from raytracer_tpu_torch.ops.bvh import build_lbvh
from raytracer_tpu_torch.ops.bvh4 import build_bvh4, widen_bvh
from raytracer_tpu_torch.ops.cuda_traverse import brute_boxes
from raytracer_tpu_torch.scene import native
from raytracer_tpu_torch.scene.assets import ensure_assets
from raytracer_tpu_torch.scene.obj_io import load_scene_objs
from raytracer_tpu_torch.scene.types import (
    DIELECTRIC,
    DIFFUSE_LIGHT,
    LAMBERTIAN,
    METAL,
    Materials,
    Scene,
    Spheres,
    SphereTree,
    TriMesh,
)
from raytracer_tpu_torch.utils import profiling

# The reference's hardcoded extras (CUDAKernels.h:69-73).
GROUND_SPHERE = dict(center=(0.0, -1000.0, 0.0), radius=999.0, albedo=(0.5, 0.5, 0.5))
MIRROR_SPHERE = dict(center=(0.2, 0.2, 0.0), radius=0.05, albedo=(0.7, 0.6, 0.5))
BVH_WIDTH = 8  # default tree width; RAYTRACER_TPU_BVH_WIDTH overrides it
ASSETS_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                          "assets", "models"))
MAX_SWEEP = 16  # spheres the sphere tree leaves to the sweep (csrc/path.cuh sphere_search)


@contextlib.contextmanager
def tree_width(width: int):
    """RAYTRACER_TPU_BVH_WIDTH set to `width` for the builds inside the
    block, restored after it."""
    old = os.environ.get("RAYTRACER_TPU_BVH_WIDTH")
    os.environ["RAYTRACER_TPU_BVH_WIDTH"] = str(width)
    try:
        yield
    finally:
        if old is None:
            del os.environ["RAYTRACER_TPU_BVH_WIDTH"]
        else:
            os.environ["RAYTRACER_TPU_BVH_WIDTH"] = old


def cornell_spheres_scene() -> Scene:
    """BASELINE config[0]: Cornell-style lighting with analytic spheres
    only (no mesh/BVH)."""
    mats = Materials.from_lists(
        types=[LAMBERTIAN, METAL, LAMBERTIAN, LAMBERTIAN, DIELECTRIC, DIFFUSE_LIGHT, METAL],
        albedos=[
            GROUND_SPHERE["albedo"],  # 0 ground
            MIRROR_SPHERE["albedo"],  # 1 mirror (rough 0)
            (0.65, 0.05, 0.05),       # 2 red diffuse
            (0.12, 0.45, 0.15),       # 3 green diffuse
            (1.0, 1.0, 1.0),          # 4 glass
            (0.0, 0.0, 0.0),          # 5 light
            (0.8, 0.85, 0.88),        # 6 rough metal
        ],
        emissions=[(0, 0, 0)] * 5 + [(15.0, 15.0, 15.0), (0, 0, 0)],
        roughnesses=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3],
        iors=[1.0, 1.0, 1.0, 1.0, 1.5, 1.0, 1.0],
    )
    spheres = Spheres.from_lists(
        centers=[
            GROUND_SPHERE["center"],
            MIRROR_SPHERE["center"],
            (-0.45, 0.2, -0.3),
            (0.45, 0.15, 0.35),
            (0.0, 0.22, 0.3),
            (0.0, 1.4, 0.0),
            (-0.2, 0.12, 0.55),
        ],
        radii=[GROUND_SPHERE["radius"], MIRROR_SPHERE["radius"], 0.2, 0.15, 0.22, 0.45, 0.12],
        mat_ids=[0, 1, 2, 3, 4, 5, 6],
    )
    return Scene(materials=mats, spheres=spheres, mesh=TriMesh.empty(), name="cornell_spheres")


def fit_light_rect(mesh: TriMesh, materials: Materials):
    """Fit a rectangle to the scene's mesh emitter (faces whose material
    is DiffuseLight) for the edge-aware visibility gradient estimator
    (config.edge_aware_lights; models/megakernel.py). Host numpy, as in
    the JAX package; returns f32[16] = center(3) normal(3) u_axis(3)
    v_axis(3) half_u half_v mat_id pad, or None without a mesh light or
    when the light faces are not coplanar (one rectangle would then aim
    the gradient term at a light that is not there)."""
    if mesh.faces is None or mesh.faces.shape[0] == 0:
        return None
    fm = mesh.face_mat.numpy()
    types = materials.type.numpy()
    light_faces = np.nonzero(types[fm] == DIFFUSE_LIGHT)[0]
    if light_faces.size == 0:
        return None
    verts = mesh.vertices.numpy()
    faces = mesh.faces.numpy()
    pts = verts[faces[light_faces]].reshape(-1, 3).astype(np.float64)
    center = pts.mean(axis=0)
    f0 = faces[light_faces[0]]
    n = np.cross(verts[f0[1]] - verts[f0[0]], verts[f0[2]] - verts[f0[0]])
    n = n / max(np.linalg.norm(n), 1e-12)
    # Every light vertex must lie on the first face's plane to within
    # 1e-3 of the emitter's extent.
    plane_res = np.abs((pts - center) @ n).max()
    extent = max(float(np.linalg.norm(pts - center, axis=1).max()), 1e-12)
    if plane_res > 1e-3 * extent:
        warnings.warn(
            "fit_light_rect: DIFFUSE_LIGHT faces are not coplanar "
            f"(plane residual {plane_res:.2e} vs extent {extent:.2e}); "
            "disabling the edge-aware light rectangle for this scene")
        return None
    d = pts - center
    d = d - np.outer(d @ n, n)
    _, v = np.linalg.eigh(d.T @ d)
    u_ax = v[:, -1]
    u_ax = u_ax / max(np.linalg.norm(u_ax), 1e-12)
    v_ax = np.cross(n, u_ax)
    hu = float(np.abs(d @ u_ax).max())
    hv = float(np.abs(d @ v_ax).max())
    rect = np.concatenate([center, n, u_ax, v_ax, [hu, hv, float(fm[light_faces[0]]), 0.0]])
    return torch.from_numpy(rect.astype(np.float32))


def add_reference_extras(mesh: TriMesh, materials: Materials, name: str = "scene") -> Scene:
    """Append the hardcoded ground and mirror spheres (CUDAKernels.h:69-73)
    after the OBJ materials, in createRandomWorld's addMaterial order."""
    m = materials.count
    mats = Materials.from_lists(
        types=np.concatenate([materials.type.numpy(), [LAMBERTIAN, METAL]]),
        albedos=np.concatenate(
            [materials.albedo.numpy(),
             np.asarray([GROUND_SPHERE["albedo"], MIRROR_SPHERE["albedo"]], np.float32)]),
        emissions=np.concatenate([materials.emission.numpy(), np.zeros((2, 3), np.float32)]),
        roughnesses=np.concatenate([materials.roughness.numpy(), np.zeros(2, np.float32)]),
        iors=np.concatenate([materials.ior.numpy(), np.ones(2, np.float32)]),
    )
    spheres = Spheres.from_lists(
        centers=[GROUND_SPHERE["center"], MIRROR_SPHERE["center"]],
        radii=[GROUND_SPHERE["radius"], MIRROR_SPHERE["radius"]],
        mat_ids=[m, m + 1],
    )
    return Scene(materials=mats, spheres=spheres, mesh=mesh, name=name,
                 light_rect=fit_light_rect(mesh, mats))


def reference_scene(assets_dir: str | None = None, with_bunny: bool = True,
                    build_bvh: bool = True) -> Scene:
    """The full reference world (SceneManager.h:101-103 +
    CUDAKernels.h:56-84): CornellBox-Original.obj (+ bunny), jointly
    normalized, plus the hardcoded ground and mirror spheres. Missing
    asset files are generated."""
    paths = ensure_assets(ASSETS_DIR if assets_dir is None else assets_dir)
    files = [paths["cornell"]] + ([paths["bunny"]] if with_bunny else [])
    mesh, materials = load_scene_objs(files)
    scene = add_reference_extras(mesh, materials,
                                 name="cornell_bunny" if with_bunny else "cornell")
    if build_bvh:
        scene = scene.replace(bvh4=build_scene_bvh4(mesh))
    return scene


def partition_brute_faces(mesh: TriMesh, area_ratio: float = 100.0,
                          max_brute: int = 64, min_tree: int = 256):
    """Split off a handful of LARGE triangles (Cornell walls/boxes/light)
    to be tested brute-force before traversal, so the tree's root box
    shrinks to the dense mesh.

    Returns (brute_ids, tree_ids) as int64 arrays of ORIGINAL face ids;
    brute_ids is empty when no triangle dwarfs the median area or the
    mesh is too small to split."""
    faces = mesh.faces.numpy()
    verts = mesh.vertices.numpy()
    t = faces.shape[0]
    all_ids = np.arange(t, dtype=np.int64)
    if t < min_tree + 1:
        return all_ids[:0], all_ids
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    area = np.linalg.norm(np.cross(e1, e2), axis=1)
    med = np.median(area)
    big = np.where(area > area_ratio * max(med, 1e-30))[0]
    if big.size == 0 or big.size > max_brute or t - big.size < min_tree:
        return all_ids[:0], all_ids
    keep = np.ones(t, bool)
    keep[big] = False
    return big.astype(np.int64), all_ids[keep]


def _bvh4(mesh: TriMesh, caller: str):
    """The native binned-SAH BVH4 over `mesh`, or where the native builder
    raises `NativeUnavailable`, build_bvh4 of its LBVH, with a warning
    that names `caller`."""
    try:
        return native.build_bvh4_native(mesh)
    except native.NativeUnavailable as e:
        warnings.warn(f"{caller}: the native builder is unavailable ({e}); "
                      "building the LBVH and collapsing it instead")
        return build_bvh4(mesh, build_lbvh(mesh))


def build_scene_bvh4(mesh: TriMesh):
    """Native binned-SAH BVH4 (native/scenekit.cpp) over the dense-mesh
    faces, widened to RAYTRACER_TPU_BVH_WIDTH (8 by default) as the JAX
    builder reads it, with oversized triangles split off for the
    brute-force pre-pass. prim ids in both halves are ORIGINAL face
    indices. The kernels of csrc/ take widths 4 and 8 (utils/cudalib.bvh_view);
    a 4-wide tree also serves the v5- and v6-layout probes (probes/).

    When the native builder raises `NativeUnavailable`, the 4-wide tree
    is build_bvh4(sub, build_lbvh(sub)) instead (with a warning); the
    widening and the brute remap are the same."""
    brute_ids, tree_ids = partition_brute_faces(mesh)
    if brute_ids.size:
        sub = TriMesh(vertices=mesh.vertices,
                      faces=mesh.faces[torch.from_numpy(tree_ids)],
                      face_mat=mesh.face_mat[torch.from_numpy(tree_ids)])
    else:
        sub = mesh
    b4 = _bvh4(sub, "build_scene_bvh4")
    width = int(os.environ.get("RAYTRACER_TPU_BVH_WIDTH", str(BVH_WIDTH)))
    if width > 4:
        b4 = widen_bvh(b4, width)
    if not brute_ids.size:
        return b4

    # Remap sub-mesh prim ids back to original face ids; leaf-alignment
    # padding slots carry -1 and must stay -1.
    pi = b4.prim_index.numpy()
    prim = np.where(pi >= 0, tree_ids[np.maximum(pi, 0)], -1).astype(np.int32)
    verts = mesh.vertices.numpy()
    faces = mesh.faces.numpy()
    fmat = mesh.face_mat.numpy()
    bf = faces[brute_ids]
    v0 = verts[bf[:, 0]]
    bt = np.concatenate([v0, verts[bf[:, 1]] - v0, verts[bf[:, 2]] - v0],
                        axis=1).astype(np.float32)
    bp = brute_ids.astype(np.int32)
    bm = fmat[brute_ids].astype(np.int32)
    pad = (-bt.shape[0]) % 8  # degenerate padding rows (MT self-rejects)
    if pad:
        bt = np.concatenate([bt, np.zeros((pad, 9), np.float32)])
        bp = np.concatenate([bp, np.zeros((pad,), np.int32)])
        bm = np.concatenate([bm, np.zeros((pad,), np.int32)])
    return dataclasses.replace(
        b4,
        prim_index=torch.from_numpy(prim),
        brute_tri=torch.from_numpy(bt),
        brute_prim=torch.from_numpy(bp),
        brute_mat=torch.from_numpy(bm),
        brute_box=brute_boxes(torch.from_numpy(bt)),
    )


def cornell_materials_scene(assets_dir: str | None = None, build_bvh: bool = True) -> Scene:
    """BASELINE config[1]: the Cornell box with a glass sphere and a
    rough-metal sphere inside — all four material types. With
    `build_bvh` the BVH is what the JAX CLI attaches to this scene
    (build_scene_bvh4 of its mesh). Missing asset files are generated."""
    paths = ensure_assets(ASSETS_DIR if assets_dir is None else assets_dir)
    mesh, materials = load_scene_objs([paths["cornell"]])
    base = add_reference_extras(mesh, materials, name="cornell_materials")
    m = base.materials
    mats = Materials.from_lists(
        types=np.concatenate([m.type.numpy(), [DIELECTRIC, METAL]]),
        albedos=np.concatenate(
            [m.albedo.numpy(), np.asarray([(1.0, 1.0, 1.0), (0.8, 0.7, 0.4)], np.float32)]),
        emissions=np.concatenate([m.emission.numpy(), np.zeros((2, 3), np.float32)]),
        roughnesses=np.concatenate([m.roughness.numpy(), [0.0, 0.25]]).astype(np.float32),
        iors=np.concatenate([m.ior.numpy(), [1.5, 1.0]]).astype(np.float32),
    )
    sp = base.spheres
    mcount = m.count
    spheres = Spheres.from_lists(
        centers=np.concatenate(
            [sp.center.numpy(), np.asarray([(-0.08, -0.21, 0.05), (0.1, -0.23, 0.12)], np.float32)]),
        radii=np.concatenate([sp.radius.numpy(), [0.09, 0.07]]).astype(np.float32),
        mat_ids=np.concatenate([sp.mat_id.numpy(), [mcount, mcount + 1]]).astype(np.int32),
    )
    scene = Scene(materials=mats, spheres=spheres, mesh=base.mesh, name="cornell_materials",
                  light_rect=base.light_rect)
    if build_bvh:
        scene = scene.replace(bvh4=build_scene_bvh4(scene.mesh))
    return scene


def partition_sweep_spheres(radius: np.ndarray):
    """partition_brute_faces's rule applied to spheres: the spheres whose
    box dwarfs the median sphere's (a radius above 10 times the median's,
    so a box area above 100 times, as the faces' area ratio) are swept by
    every ray instead of swallowing the tree's root box; at most
    MAX_SWEEP of them, and at least one sphere stays in the tree, else
    none is split off. Returns (sweep ids, tree ids), int64 arrays of
    sphere indices, ascending."""
    r = np.abs(np.asarray(radius, np.float64))
    ids = np.arange(r.shape[0], dtype=np.int64)
    big = r > 10.0 * max(float(np.median(r)), 1e-30)
    if not big.any() or big.sum() > MAX_SWEEP or big.all():
        return ids[:0], ids
    return ids[big], ids[~big]


def sphere_boxes(center: np.ndarray, radius: np.ndarray) -> np.ndarray:
    """The spheres' boxes f32[S, 6] (lo xyz, hi xyz), c -/+ |r| rounded
    outward to float32: the tree's leaves. The walk grows them for each
    ray (sphere_growth)."""
    c = np.asarray(center, np.float64).reshape(-1, 3)
    r = np.abs(np.asarray(radius, np.float64))[:, None]
    lo64, hi64 = c - r, c + r
    lo32, hi32 = lo64.astype(np.float32), hi64.astype(np.float32)
    lo32 = np.where(lo32 > lo64, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi64, np.nextafter(hi32, np.float32(np.inf)), hi32)
    return np.concatenate([lo32, hi32], axis=1)


EPS32 = 2.0 ** -24  # float32's unit roundoff


def sphere_growth(center: np.ndarray, radius: np.ndarray) -> tuple:
    """(cx, cy, cz, h, ga, gb, gc): the walk grows every box of the tree by
    g = (ga L + gb) L + gc for a ray from o, L = |o - c| + h, c the
    centre of the spheres' boxes and h the farthest sphere centre from it,
    so L >= |o - c_i| for every sphere i of the tree.

    Why: the sweep's root of a ray with |o - c_i| = L rounds its
    discriminant by at most ~15 eps |d|^2 L^2, so the point of its root
    (a grazing hit, or a miss the sweep takes by a rounding) lies within
    |r| + 7.6 eps L^2 / |r| + 8 eps L + 4 eps |r| of the centre; the slab
    test and the grown bounds round by 3 eps (L + |r| + g) + eps |c_i| more.
    g is twice 10 eps L^2 / r_min + 12 eps L + 4 eps (|c| + h + 2 r_max),
    so the walk visits every box whose sphere the sweep takes, its ties
    included, from any origin: a few thousandths of a unit at the RTIOW
    scene's camera, more for rays from far on its ground."""
    c = np.asarray(center, np.float64).reshape(-1, 3)
    r = np.abs(np.asarray(radius, np.float64))
    mid = 0.5 * ((c - r[:, None]).min(axis=0) + (c + r[:, None]).max(axis=0))
    h = float(np.linalg.norm(c - mid, axis=1).max())
    r_min = max(float(r.min()), 1e-6 * (h + 1.0))
    r_max = float(r.max())
    ga, gb = 2.0 * 10.0 * EPS32 / r_min, 2.0 * 12.0 * EPS32
    gc = 2.0 * 4.0 * EPS32 * (float(np.linalg.norm(mid)) + h + 2.0 * r_max)
    return (float(mid[0]), float(mid[1]), float(mid[2]), h, ga, gb, gc)


def build_sphere_tree(spheres: Spheres) -> SphereTree:
    """The fused path loop's sphere tree over `spheres` (any device; the
    tree comes back on the CPU). partition_sweep_spheres splits off the
    sweep set. The native binned-SAH builder (scene/native.build_bvh4_native,
    the triangle builder) builds a 4-wide tree over the rest, each sphere
    given as the one triangle (lo, hi, (lo + hi) / 2) of its box
    (sphere_boxes): that triangle's box is the sphere's, and its centroid
    the box's centre, to a rounding. Its leaves are aligned to rows of 8 slots, and
    ops/bvh4.widen_bvh widens it to 8. Where the native builder is
    unavailable, the LBVH collapsed by build_bvh4 builds it instead, as in
    build_scene_bvh4. Span `rt.scene.sphere_tree`; counter
    `sphere_tree.nodes`, the tree's node count."""
    with profiling.span("rt.scene.sphere_tree"):
        c = spheres.center.detach().cpu().numpy().astype(np.float32)
        r = spheres.radius.detach().cpu().numpy().astype(np.float32)
        sweep, rest = partition_sweep_spheres(r)
        box = sphere_boxes(c[rest], r[rest])
        lo, hi = box[:, :3], box[:, 3:]
        verts = np.stack([lo, hi, 0.5 * (lo + hi)], axis=1).reshape(-1, 3)
        n = rest.shape[0]
        mesh = TriMesh(vertices=torch.from_numpy(verts),
                       faces=torch.arange(3 * n, dtype=torch.int32).reshape(n, 3),
                       face_mat=torch.zeros((n,), dtype=torch.int32))
        wide = widen_bvh(_bvh4(mesh, "build_sphere_tree"), 8)
        slot = wide.prim_index.numpy()
        ids = np.where(slot >= 0, rest[np.maximum(slot, 0)], -1).astype(np.int32)
        rec = np.concatenate([c[ids], r[ids, None]], axis=1)
        rec[slot < 0] = 0.0
        tree = SphereTree(bounds=wide.bounds, children=wide.children, sph=torch.from_numpy(rec),
                          ids=torch.from_numpy(ids), sweep=torch.from_numpy(sweep.astype(np.int32)),
                          stack_depth=wide.stack_depth, grow=sphere_growth(c[rest], r[rest]))
        profiling.count("sphere_tree.nodes", tree.nodes)
    return tree
