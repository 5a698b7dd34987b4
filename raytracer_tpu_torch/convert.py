"""Hand-off of the JAX package's scene and camera into the port's types.

`to_numpy_tree(obj)` turns any dataclass tree (the JAX package's Scene,
Bvh4 or Camera included) into nested dicts of numpy arrays with
`np.asarray`, without importing JAX. `scene_from_numpy` and
`camera_from_numpy` rebuild the port's dataclasses from such dicts, so
one scene can reach both packages in the tests, whichever of the BVH8
(`bvh4`) and the binary LBVH (`bvh`) it holds.

`key_words`, `params_from_numpy` and `adam_state_from_numpy` hand over
the differentiable path's state: jax.random keys as their int32 words,
a params dict (material fields and camera fields), and Adam's state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.camera import Camera
from raytracer_tpu_torch.ops.bvh4 import Bvh4
from raytracer_tpu_torch.scene.types import Bvh, Materials, Scene, Spheres, TriMesh


def to_numpy_tree(obj):
    """Dataclass → {field: numpy array | python scalar | nested dict | None}."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    return np.asarray(obj)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))  # a copy; keeps 0-d shapes


def _build(cls, d: dict, **override):
    kw = {f.name: _t(d.get(f.name)) for f in dataclasses.fields(cls) if f.name in d}
    kw.update(override)
    return cls(**kw)


def bvh4_from_numpy(d: dict) -> Bvh4:
    return _build(Bvh4, {k: v for k, v in d.items() if k != "stack_depth"},
                  stack_depth=int(d["stack_depth"]))


def bvh_from_numpy(d: dict) -> Bvh:
    """The JAX Bvh's fields as numpy (to_numpy_tree) → the port's Bvh."""
    return _build(Bvh, d)


def scene_from_numpy(d: dict) -> Scene:
    """The JAX Scene's fields as numpy (to_numpy_tree) → the port's Scene."""
    return Scene(
        materials=_build(Materials, d["materials"]),
        spheres=_build(Spheres, d["spheres"]),
        mesh=_build(TriMesh, d["mesh"]),
        bvh4=None if d.get("bvh4") is None else bvh4_from_numpy(d["bvh4"]),
        bvh=None if d.get("bvh") is None else bvh_from_numpy(d["bvh"]),
        light_rect=_t(d.get("light_rect")),
        name=d.get("name", "scene"),
    )


def camera_from_numpy(d: dict) -> Camera:
    """The JAX Camera's fields as numpy → the port's Camera."""
    return _build(Camera, {k: np.asarray(v, np.float32) for k, v in d.items()
                           if k != "aspect_ratio"},
                  aspect_ratio=float(d["aspect_ratio"]))


def key_words(key_data) -> tuple:
    """`jax.random.key_data(key)` as numpy (uint32 [..., 2]) → the port's
    key (k0, k1), int32 tensors of the leading shape."""
    kd = np.asarray(key_data).astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.array(kd[..., 0])), torch.from_numpy(np.array(kd[..., 1]))


def params_from_numpy(params: dict) -> dict:
    """A JAX params dict (material fields and cam_* fields) as numpy →
    float32 tensors of the same shapes."""
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()}


def adam_state_from_numpy(step, mu: dict, nu: dict):
    """JAX's AdamState fields as numpy → the port's diff/inverse.AdamState."""
    from raytracer_tpu_torch.diff.inverse import AdamState

    return AdamState(step=int(np.asarray(step)), mu=params_from_numpy(mu),
                     nu=params_from_numpy(nu))
