"""The benchmark's own OBJ/MTL loader: the reference renderer's scene
consolidation (SceneManager.h:198-329 of the CUDA RayTracer the port
follows), written again from that description in NumPy.

  * one merged mesh per OBJ file, polygons triangulated as a fan;
  * MTL -> material by priority emissive > translucent > specular >
    diffuse; a metal's roughness is Pr, else sqrt(2 / (Ns + 2));
  * a face's material id outside [0, materials loaded so far) becomes 0;
  * mesh i's material ids are offset by the number of distinct face
    material ids of mesh i - 1 alone (not a running sum);
  * after every file, all meshes loaded so far are re-centred together
    and scaled to a largest extent of 0.6.

Only positions, faces and material ids are read: shading uses geometric
normals.
"""

from __future__ import annotations

import math
import os

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT = 0, 1, 2, 3


def _parse_mtl(path: str) -> list[dict]:
    mats: list[dict] = []
    if not os.path.exists(path):
        return mats
    cur = None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag, args = parts[0], parts[1:]
            if tag == "newmtl":
                cur = dict(name=args[0] if args else "", Kd=(0.6, 0.6, 0.6), Ks=(0.0, 0.0, 0.0),
                           Ke=(0.0, 0.0, 0.0), d=1.0, Ns=1.0, Ni=1.0, Pr=0.0)
                mats.append(cur)
            elif cur is None:
                continue
            elif tag in ("Kd", "Ks", "Ke"):
                cur[tag] = tuple(float(x) for x in args[:3])
            elif tag == "d":
                cur["d"] = float(args[0])
            elif tag == "Tr":
                cur["d"] = 1.0 - float(args[0])
            elif tag in ("Ns", "Ni", "Pr"):
                cur[tag] = float(args[0])
    return mats


def _material(m: dict) -> tuple:
    """(type, albedo, emission, roughness, ior) of one MTL record."""
    if any(e > 0.0 for e in m["Ke"]):
        kind = DIFFUSE_LIGHT
    elif m["d"] < 1.0:
        kind = DIELECTRIC
    elif m["Ks"][0] > 0.0:
        kind = METAL
    else:
        kind = LAMBERTIAN
    rough = 0.0
    if kind == METAL:
        rough = m["Pr"] if m["Pr"] > 0.0 else math.sqrt(2.0 / (m["Ns"] + 2.0))
    ior = m["Ni"] if kind == DIELECTRIC else 1.0
    return kind, m["Kd"], m["Ke"], rough, ior


def _load_one(path: str, materials: list) -> dict:
    base = os.path.dirname(path)
    verts, faces, fmat = [], [], []
    names: dict[str, int] = {}
    local: list[dict] = []
    cur = -1
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                verts.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "mtllib":
                for m in _parse_mtl(os.path.join(base, parts[1])):
                    names[m["name"]] = len(local)
                    local.append(m)
            elif tag == "usemtl":
                cur = names.get(parts[1], -1)
            elif tag == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    fmat.append(cur)
    materials.extend(_material(m) for m in local)
    n = len(materials)
    return dict(v=np.asarray(verts, np.float32).reshape(-1, 3),
                f=np.asarray(faces, np.int64).reshape(-1, 3),
                m=np.asarray([x if 0 <= x < n else 0 for x in fmat], np.int64))


def _rescale(meshes: list[dict]) -> None:
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    for m in meshes:
        if len(m["v"]):
            lo = np.minimum(lo, m["v"].min(axis=0))
            hi = np.maximum(hi, m["v"].max(axis=0))
    centre = (lo + hi) * 0.5
    scale = 0.6 / float((hi - lo).max())
    for m in meshes:
        m["v"] = ((m["v"] - centre) * scale).astype(np.float32)


def load(paths: list[str]):
    """(vertices f32[V,3], faces i64[T,3], face material i64[T], materials)
    of the OBJ files, consolidated as the module docstring says; materials
    is a list of (type, albedo, emission, roughness, ior)."""
    materials: list = []
    meshes: list[dict] = []
    for p in paths:
        meshes.append(_load_one(p, materials))
        _rescale(meshes)
    verts, faces, fmat, v_off = [], [], [], 0
    for i, m in enumerate(meshes):
        off = 0 if i == 0 else len(set(meshes[i - 1]["m"].tolist()))
        verts.append(m["v"])
        faces.append(m["f"] + v_off)
        fmat.append(m["m"] + off)
        v_off += len(m["v"])
    if not materials:
        materials = [(LAMBERTIAN, (0.5, 0.5, 0.5), (0.0, 0.0, 0.0), 0.0, 1.0)]
    return np.concatenate(verts), np.concatenate(faces), np.concatenate(fmat), materials
