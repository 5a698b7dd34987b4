"""ctypes binding to the native binned-SAH BVH4 builder (port of
raytracer_tpu/scene/native.py).

The source is the repository's `native/scenekit.cpp`, unchanged. It is
compiled with g++ at first use into this package's git-ignored build
directory (`raytracer_tpu_torch/_build/`), keyed by the source's content
hash, and never into `native/`: the tracked `native/libscenekit.so`
belongs to the JAX package. A missing source, a failed build or load, or
a failed tree build raises `NativeUnavailable`, on which
scene/builder.build_scene_bvh4 falls back to the LBVH (with a warning).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

from raytracer_tpu_torch.ops.bvh4 import (MAX_LEAF, Bvh4, align_leaves_to_rows,
                                          compute_stack_depth)

_LIB = None


class NativeUnavailable(RuntimeError):
    """The native builder cannot build here (source missing, g++ failed or
    absent, the library does not load, or it refused the mesh)."""


_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SOURCE = os.path.join(_REPO, "native", "scenekit.cpp")
BUILD_DIR = os.path.join(_REPO, "raytracer_tpu_torch", "_build")
_FLAGS = ["-O3", "-shared", "-fPIC"]  # the JAX loader's flags: same tables


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(SOURCE):
        raise NativeUnavailable(f"native BVH builder source missing: {SOURCE}")
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libscenekit-{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        try:
            res = subprocess.run(["g++", *_FLAGS, "-o", tmp, SOURCE],
                                 capture_output=True, text=True)
        except OSError as e:
            raise NativeUnavailable(f"scenekit build failed: {e}") from e
        if res.returncode != 0:
            raise NativeUnavailable(f"scenekit build failed:\n{res.stderr}")
        os.replace(tmp, lib_path)
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as e:
        raise NativeUnavailable(f"scenekit load failed: {e}") from e
    lib.scenekit_build_bvh4.restype = ctypes.c_int
    lib.scenekit_build_bvh4.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _LIB = lib
    return lib


def build_bvh4_native(mesh, max_leaf: int = MAX_LEAF) -> Bvh4:
    """TriMesh → Bvh4 via the native binned-SAH builder, leaves aligned to
    8-triangle rows."""
    lib = _load()
    verts = np.ascontiguousarray(mesh.vertices.numpy(), np.float32)
    faces = np.ascontiguousarray(mesh.faces.numpy(), np.int32)
    t = faces.shape[0]
    bounds = np.empty((t, 4, 6), np.float32)
    children = np.empty((t, 4), np.int32)
    prim = np.empty((t,), np.int32)
    n4 = lib.scenekit_build_bvh4(verts.ctypes.data, verts.shape[0], faces.ctypes.data, t,
                                 max_leaf, bounds.ctypes.data, children.ctypes.data,
                                 prim.ctypes.data)
    if n4 <= 0:
        raise NativeUnavailable(f"scenekit_build_bvh4 returned {n4}")

    fperm = faces[prim]
    v0 = verts[fperm[:, 0]]
    e1 = verts[fperm[:, 1]] - v0
    e2 = verts[fperm[:, 2]] - v0
    tri = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
    face_mat = mesh.face_mat.numpy()[prim].astype(np.int32)
    children_al, tri, prim, face_mat = align_leaves_to_rows(children[:n4], tri, prim, face_mat)
    return Bvh4(
        bounds=torch.from_numpy(bounds[:n4].copy()),
        children=torch.from_numpy(children_al),
        tri=torch.from_numpy(tri),
        prim_index=torch.from_numpy(prim),
        face_mat=torch.from_numpy(face_mat),
        stack_depth=compute_stack_depth(children_al),
        builder="native",
    )
