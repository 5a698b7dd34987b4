"""OBJ/MTL loading with the reference's exact consolidation semantics
(port of raytracer_tpu/scene/obj_io.py; the parsing is the same NumPy
code, only the returned containers are the port's tensor dataclasses).

Replicates SceneManager.h:198-329:
  * one merged mesh per OBJ file (all shapes share the attrib vertex pool),
  * triangulation by fan (tinyobj LoadObj default),
  * MTL → material inference priority emissive > translucent > specular >
    diffuse, metal roughness fallback sqrt(2/(shininess+2))
    (SceneManager.h:222-247),
  * per-face material ids; out-of-range ids clamp to 0 against the
    *global-so-far* material count (SceneManager.h:259-265),
  * material-id offset for mesh i = number of UNIQUE face-material ids of
    mesh i-1 only — not cumulative (SceneManager.h:143-145,177). For the
    Cornell+bunny pair this sends the (material-less) bunny to the first
    material appended after the OBJ tables, i.e. the hardcoded ground
    Lambertian(0.5) — a reference quirk we reproduce for image parity.
  * joint renormalization after EVERY file load: all meshes loaded so far
    are re-centered and re-scaled to max extent 0.6
    (SceneManager.h:307-325).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from raytracer_tpu_torch.scene.types import (
    DIELECTRIC,
    DIFFUSE_LIGHT,
    LAMBERTIAN,
    METAL,
    Materials,
    TriMesh,
)


@dataclass
class MtlMaterial:
    name: str = ""
    diffuse: tuple = (0.6, 0.6, 0.6)   # tinyobj default Kd
    specular: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    dissolve: float = 1.0
    shininess: float = 1.0
    ior: float = 1.0
    roughness: float = 0.0  # PBR extension 'Pr'


@dataclass
class MaterialData:
    """Host-side material record (reference MaterialData,
    Core/Material.cuh:16-47) produced by the MTL inference rules."""

    type: int
    albedo: tuple
    roughness: float
    ior: float
    emission: tuple


@dataclass
class MeshData:
    """Per-file mesh (reference MeshData, SceneManager.h:13-17)."""

    vertices: np.ndarray          # f32[V,3]
    faces: np.ndarray             # i32[T,3]
    face_material_ids: np.ndarray  # i32[T] (local tinyobj ids, clamped)
    # Per-corner vn/vt resolved at load (SceneManager.h:280-289 carries
    # the same data per-vertex); None when the OBJ has no vn/vt lines.
    normals: np.ndarray | None = None  # f32[T,3,3]
    uvs: np.ndarray | None = None      # f32[T,3,2]


def _parse_mtl(path: str) -> list[MtlMaterial]:
    mats: list[MtlMaterial] = []
    cur: MtlMaterial | None = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "newmtl":
                cur = MtlMaterial(name=parts[1] if len(parts) > 1 else "")
                mats.append(cur)
            elif cur is None:
                continue
            elif tag == "Kd":
                cur.diffuse = tuple(float(x) for x in parts[1:4])
            elif tag == "Ks":
                cur.specular = tuple(float(x) for x in parts[1:4])
            elif tag == "Ke":
                cur.emission = tuple(float(x) for x in parts[1:4])
            elif tag == "d":
                cur.dissolve = float(parts[1])
            elif tag == "Tr":
                cur.dissolve = 1.0 - float(parts[1])
            elif tag == "Ns":
                cur.shininess = float(parts[1])
            elif tag == "Ni":
                cur.ior = float(parts[1])
            elif tag == "Pr":
                cur.roughness = float(parts[1])
    return mats


def infer_material(mat: MtlMaterial) -> MaterialData:
    """MTL → MaterialData heuristic (SceneManager.h:222-247)."""
    if any(e > 0.0 for e in mat.emission):
        mtype = DIFFUSE_LIGHT
    elif mat.dissolve < 1.0:
        mtype = DIELECTRIC
    elif mat.specular[0] > 0.0:
        mtype = METAL
    else:
        mtype = LAMBERTIAN
    rough = 0.0
    if mtype == METAL:
        rough = mat.roughness if mat.roughness > 0.0 else math.sqrt(2.0 / (mat.shininess + 2.0))
    ior = mat.ior if mtype == DIELECTRIC else 1.0
    return MaterialData(mtype, mat.diffuse, rough, ior, mat.emission)


def load_obj(
    filename: str, global_materials: list[MaterialData]
) -> MeshData:
    """Load one OBJ file, appending its inferred materials to
    `global_materials` (mutated, matching SceneManager's accumulation).
    Face material ids stay file-local; invalid ids clamp to 0 against the
    global-so-far count (SceneManager.h:259-265).
    """
    base_dir = os.path.dirname(filename)
    positions: list[tuple] = []
    vn_pool: list[tuple] = []
    vt_pool: list[tuple] = []
    faces: list[tuple] = []
    face_mats: list[int] = []
    corner_vn: list[tuple] = []  # per-face (i0,i1,i2) into vn_pool, -1 absent
    corner_vt: list[tuple] = []
    local_mats: list[MtlMaterial] = []
    mat_index_by_name: dict[str, int] = {}
    cur_mat = -1

    def _resolve(tok: str, pool_len: int) -> int:
        if not tok:
            return -1
        i = int(tok)
        return i - 1 if i > 0 else pool_len + i

    with open(filename) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vn":
                vn_pool.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vt":
                vt_pool.append(tuple(float(x) for x in parts[1:3]))
            elif tag == "mtllib":
                for m in _parse_mtl(os.path.join(base_dir, parts[1])):
                    mat_index_by_name[m.name] = len(local_mats)
                    local_mats.append(m)
            elif tag == "usemtl":
                cur_mat = mat_index_by_name.get(parts[1], -1)
            elif tag == "f":
                idx, nidx, tidx = [], [], []
                for vtok in parts[1:]:
                    comps = vtok.split("/")
                    idx.append(_resolve(comps[0], len(positions)))
                    tidx.append(_resolve(comps[1] if len(comps) > 1 else "",
                                         len(vt_pool)))
                    nidx.append(_resolve(comps[2] if len(comps) > 2 else "",
                                         len(vn_pool)))
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    corner_vn.append((nidx[0], nidx[k], nidx[k + 1]))
                    corner_vt.append((tidx[0], tidx[k], tidx[k + 1]))
                    face_mats.append(cur_mat)

    n_global_before = len(global_materials)
    global_materials.extend(infer_material(m) for m in local_mats)
    n_global_after = len(global_materials)

    # Clamp: faceMatId invalid if <0 or >= global material count *at this
    # point in loading* (SceneManager.h:262-264 checks m_SceneMaterialsData).
    clamped = [
        fm if 0 <= fm < n_global_after else 0 for fm in face_mats
    ]
    del n_global_before

    # Resolve per-corner shading attributes; a face missing its vn/vt
    # index gets zeros for that corner (matches tinyobj's -1 sentinel
    # handling in the reference's vertex fill, SceneManager.h:280-289).
    t = len(faces)
    normals = uvs = None
    if vn_pool and t:
        vn_arr = np.asarray(vn_pool, np.float32).reshape(-1, 3)
        ci = np.asarray(corner_vn, np.int64)
        normals = np.where((ci >= 0)[..., None],
                           vn_arr[np.clip(ci, 0, len(vn_arr) - 1)], 0.0
                           ).astype(np.float32)
    if vt_pool and t:
        vt_arr = np.asarray(vt_pool, np.float32).reshape(-1, 2)
        ci = np.asarray(corner_vt, np.int64)
        uvs = np.where((ci >= 0)[..., None],
                       vt_arr[np.clip(ci, 0, len(vt_arr) - 1)], 0.0
                       ).astype(np.float32)

    return MeshData(
        vertices=np.asarray(positions, np.float32).reshape(-1, 3),
        faces=np.asarray(faces, np.int32).reshape(-1, 3),
        face_material_ids=np.asarray(clamped, np.int32),
        normals=normals,
        uvs=uvs,
    )


def _renormalize(meshes: list[MeshData]) -> None:
    """Joint recenter + rescale of all meshes loaded so far to max extent
    0.6 (SceneManager.h:307-325). Runs after *every* file load, so earlier
    meshes are normalized repeatedly — the reference quirk."""
    mn = np.full(3, np.inf, np.float32)
    mx = np.full(3, -np.inf, np.float32)
    for m in meshes:
        if len(m.vertices):
            mn = np.minimum(mn, m.vertices.min(axis=0))
            mx = np.maximum(mx, m.vertices.max(axis=0))
    center = (mn + mx) * 0.5
    scale = 0.6 / float((mx - mn).max())
    for m in meshes:
        m.vertices = ((m.vertices - center) * scale).astype(np.float32)


def load_scene_objs(filenames: list[str]):
    """Load + consolidate a list of OBJ files (SceneManager::initMeshes).

    Returns (TriMesh merged soup with *global* face material ids,
    Materials table from all files' inferred materials). No file gives
    the empty mesh (TriMesh.empty's degenerate triangle, which no ray
    hits) and no material: a scene of spheres alone.
    """
    if not filenames:
        return TriMesh.empty(), Materials.from_lists(types=[], albedos=np.zeros((0, 3)))
    global_mats: list[MaterialData] = []
    meshes: list[MeshData] = []
    for fn in filenames:
        meshes.append(load_obj(fn, global_mats))
        _renormalize(meshes)

    # Per-mesh material-id offset = unique count of the PREVIOUS mesh's
    # face ids only (SceneManager.h:143-145,177) — reference quirk.
    all_verts, all_faces, all_face_mats = [], [], []
    all_normals, all_uvs = [], []
    v_off = 0
    for i, m in enumerate(meshes):
        if i == 0:
            mat_off = 0
        else:
            prev = meshes[i - 1]
            mat_off = len(set(prev.face_material_ids.tolist()))
        all_verts.append(m.vertices)
        all_faces.append(m.faces + v_off)
        all_face_mats.append(m.face_material_ids + mat_off)
        t = len(m.faces)
        all_normals.append(m.normals if m.normals is not None
                           else np.zeros((t, 3, 3), np.float32))
        all_uvs.append(m.uvs if m.uvs is not None
                       else np.zeros((t, 3, 2), np.float32))
        v_off += len(m.vertices)

    # Carry vn/vt only when at least one file supplied them (meshes
    # without them get zero rows — distinguishable from unit normals).
    has_vn = any(m.normals is not None for m in meshes)
    has_vt = any(m.uvs is not None for m in meshes)
    mesh = TriMesh.from_arrays(
        np.concatenate(all_verts, axis=0),
        np.concatenate(all_faces, axis=0),
        np.concatenate(all_face_mats, axis=0),
        normals=np.concatenate(all_normals, axis=0) if has_vn else None,
        uvs=np.concatenate(all_uvs, axis=0) if has_vt else None,
    )
    if global_mats:
        materials = Materials.from_lists(
            types=[m.type for m in global_mats],
            albedos=[m.albedo for m in global_mats],
            emissions=[m.emission for m in global_mats],
            roughnesses=[m.roughness for m in global_mats],
            iors=[m.ior for m in global_mats],
        )
    else:
        materials = Materials.from_lists(types=[LAMBERTIAN], albedos=[(0.5, 0.5, 0.5)])
    return mesh, materials
