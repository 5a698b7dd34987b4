"""SoA scene representation (port of raytracer_tpu/scene/types.py).

Frozen dataclasses of tensors: a material table, a sphere list and one
merged triangle soup, plus the BVH8 (ops/bvh4.Bvh4), or the binary LBVH
(Bvh, ops/bvh.build_lbvh) of a scene that holds only that, the fitted
light rectangle of the differentiable path, and the sphere tree
(SphereTree, scene/builder.build_sphere_tree) of a scene of many spheres. `.to(device)` moves
every tensor field, recursively.

Material type tags follow the reference enum order
(Core/Material.cuh:8-14): Lambertian=0, Metal=1, Dielectric=2,
DiffuseLight=3.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3


def tensors_to(obj, device):
    """Copy of a dataclass with every tensor field (and nested dataclass)
    moved to `device`."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if torch.is_tensor(v):
            kw[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            kw[f.name] = tensors_to(v, device)
    return dataclasses.replace(obj, **kw)


def _f32(x, shape=None) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.float32)
    return t.reshape(shape) if shape is not None else t


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32)


class _ToDevice:
    def to(self, device):
        return tensors_to(self, device)


@dataclasses.dataclass(frozen=True)
class Materials(_ToDevice):
    """Material table (reference MaterialData, Core/Material.cuh:16-47)."""

    type: torch.Tensor       # i32[M]
    albedo: torch.Tensor     # f32[M,3]
    emission: torch.Tensor   # f32[M,3]
    roughness: torch.Tensor  # f32[M]
    ior: torch.Tensor        # f32[M]

    @staticmethod
    def from_lists(types, albedos, emissions=None, roughnesses=None, iors=None) -> "Materials":
        m = len(types)
        return Materials(
            type=_i32(np.asarray(types)),
            albedo=_f32(np.asarray(albedos, np.float32), (m, 3)),
            emission=torch.zeros((m, 3)) if emissions is None
            else _f32(np.asarray(emissions, np.float32), (m, 3)),
            roughness=torch.zeros((m,)) if roughnesses is None
            else _f32(np.asarray(roughnesses, np.float32)),
            ior=torch.ones((m,)) if iors is None else _f32(np.asarray(iors, np.float32)),
        )

    @property
    def count(self) -> int:
        return self.type.shape[0]


@dataclasses.dataclass(frozen=True)
class Spheres(_ToDevice):
    """Analytic spheres (reference Core/Sphere.cuh)."""

    center: torch.Tensor  # f32[S,3]
    radius: torch.Tensor  # f32[S]
    mat_id: torch.Tensor  # i32[S]

    @staticmethod
    def from_lists(centers, radii, mat_ids) -> "Spheres":
        return Spheres(
            center=_f32(np.asarray(centers, np.float32), (-1, 3)),
            radius=_f32(np.asarray(radii, np.float32)),
            mat_id=_i32(np.asarray(mat_ids)),
        )

    @staticmethod
    def empty() -> "Spheres":
        # One far-away degenerate sentinel keeps shapes static and never hits.
        return Spheres(center=_f32([[1e30, 1e30, 1e30]]), radius=torch.zeros((1,)),
                       mat_id=torch.zeros((1,), dtype=torch.int32))

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@dataclasses.dataclass(frozen=True)
class TriMesh(_ToDevice):
    """Merged triangle soup; per-corner vn/vt pools ride along as data
    (shading uses geometric normals, like the reference)."""

    vertices: torch.Tensor  # f32[V,3]
    faces: torch.Tensor     # i32[T,3] vertex indices
    face_mat: torch.Tensor  # i32[T] material ids (already globally offset)
    normals: Optional[torch.Tensor] = None  # f32[T,3,3]
    uvs: Optional[torch.Tensor] = None      # f32[T,3,2]

    @staticmethod
    def from_arrays(vertices, faces, face_mat, normals=None, uvs=None) -> "TriMesh":
        return TriMesh(
            vertices=_f32(np.asarray(vertices, np.float32), (-1, 3)),
            faces=_i32(np.asarray(faces, np.int32)).reshape(-1, 3),
            face_mat=_i32(np.asarray(face_mat, np.int32)),
            normals=None if normals is None
            else _f32(np.asarray(normals, np.float32), (-1, 3, 3)),
            uvs=None if uvs is None else _f32(np.asarray(uvs, np.float32), (-1, 3, 2)),
        )

    @staticmethod
    def empty() -> "TriMesh":
        # Degenerate sentinel triangle: zero area → |det| < ε → never hits.
        return TriMesh(vertices=torch.zeros((3, 3)),
                       faces=torch.tensor([[0, 1, 2]], dtype=torch.int32),
                       face_mat=torch.zeros((1,), dtype=torch.int32))

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]


@dataclasses.dataclass(frozen=True)
class Bvh(_ToDevice):
    """LBVH over the triangle soup (built by ops/bvh.build_lbvh).

    Node indexing convention: internal nodes are 0..T-2; child index
    c >= T-1 refers to leaf/triangle (c - (T-1)) in *sorted* order;
    `prim_index` maps sorted leaf position → original triangle id.
    """

    left: torch.Tensor        # i32[T-1]
    right: torch.Tensor       # i32[T-1]
    node_min: torch.Tensor    # f32[2T-1,3] (internal then leaves)
    node_max: torch.Tensor    # f32[2T-1,3]
    prim_index: torch.Tensor  # i32[T]


@dataclasses.dataclass(frozen=True)
class SphereTree(_ToDevice):
    """An 8-wide tree over the spheres' padded boxes (the fused path
    loop's sphere search, csrc/path.cuh sphere_search; plain version
    ops/sphere.closest_sphere_tree), built by scene/builder.build_sphere_tree.
    Child codes as ops/bvh4's; a leaf range names slots of `sph` / `ids`."""

    bounds: torch.Tensor    # f32[N, 8, 6] child boxes (min3, max3); empty slots inf/-inf
    children: torch.Tensor  # i32[N, 8]
    sph: torch.Tensor       # f32[L, 4] center, radius in leaf order (zero on padding)
    ids: torch.Tensor       # i32[L] leaf slot -> sphere index (-1 on padding)
    sweep: torch.Tensor     # i32[B] the spheres every ray tests first, ascending
    stack_depth: int = 0    # worst-case stack bound of the walk (ops/bvh4.compute_stack_depth)
    # (cx, cy, cz, h, ga, gb, gc), floats: the walk grows its boxes by
    # (ga L + gb) L + gc for a ray from o, L = |o - c| + h
    # (scene/builder.sphere_growth).
    grow: tuple = (0.0,) * 7

    @property
    def nodes(self) -> int:
        return self.children.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene(_ToDevice):
    materials: Materials
    spheres: Spheres
    mesh: TriMesh
    bvh4: Optional[Any] = None  # ops/bvh4.Bvh4 (BVH8 after widening)
    # Fitted rectangle of the mesh emitter for the edge-aware visibility
    # gradient (scene/builder.fit_light_rect): f32[16] = center(3)
    # normal(3) u_axis(3) v_axis(3) half_u half_v mat_id(float) pad.
    # None when the scene has no (planar) mesh light.
    light_rect: Optional[torch.Tensor] = None
    name: str = "scene"
    # The binary LBVH, traversed by ops/traverse.intersect_bvh when the
    # scene has no bvh4 (ops/intersect.intersect_scene). Last, so that no
    # positional construction shifts.
    bvh: Optional[Bvh] = None
    # The sphere tree the fused path loop finds spheres through; a scene of
    # more than cudalib.MAX_SPHERES spheres needs one there.
    sphere_tree: Optional[SphereTree] = None

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)
