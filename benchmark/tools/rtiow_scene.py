"""Write benchmark/configs/rtiow_final_1200.json: the final scene of "Ray
Tracing in One Weekend" (v4.0, Shirley, Black, Hollasch; section 14.1 "A
Final Render", main.cc), its world loop run once with numpy's
default_rng(0), and the book's camera and render settings.

    python3 -m benchmark.tools.rtiow_scene [--check]

With --check, compare the committed file with what this writes and exit
1 where they differ.

The world: a ground sphere of radius 1000 at (0, -1000, 0), Lambertian
0.5; for a, b in [-11, 11): choose_mat, then the centre (a + 0.9 u, 0.2,
b + 0.9 u), kept where it lies more than 0.9 from (4, 0.2, 0): below 0.8
Lambertian with albedo u3 * u3, below 0.95 metal with albedo in [0.5, 1)
and fuzz in [0, 0.5), else glass of index 1.5, radius 0.2; then glass,
Lambertian (0.4, 0.2, 0.1) and metal (0.7, 0.6, 0.5) fuzz 0 spheres of
radius 1 at (0, 1, 0), (-4, 1, 0), (4, 1, 0). Every sphere has a material
of its own. Numbers are rounded to 6 decimals.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

from benchmark import manifest

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
PATH = os.path.join(manifest.HERE, "configs", "rtiow_final_1200.json")
LOOKFROM, LOOKAT = (13.0, 2.0, 3.0), (0.0, 0.0, 0.0)
VFOV, DEFOCUS_ANGLE, FOCUS_DIST = 20.0, 0.6, 10.0


def _r(x) -> float:
    return round(float(x), 6)


def world(seed: int = 0) -> dict:
    """The scene's "materials" and "spheres" (each sphere names its own
    material by index), from the book's loop under default_rng(seed)."""
    rng = np.random.default_rng(seed)
    mats, spheres = [], []

    def add(center, radius, mat):
        spheres.append({"center": [_r(c) for c in center], "radius": _r(radius),
                        "material": len(mats)})
        mats.append(mat)

    add((0.0, -1000.0, 0.0), 1000.0, {"type": LAMBERTIAN, "albedo": [0.5, 0.5, 0.5]})
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if math.dist(center, (4.0, 0.2, 0.0)) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                mat = {"type": LAMBERTIAN, "albedo": [_r(x) for x in albedo]}
            elif choose < 0.95:
                albedo = 0.5 + 0.5 * rng.random(3)
                mat = {"type": METAL, "albedo": [_r(x) for x in albedo],
                       "roughness": _r(0.5 * rng.random())}
            else:
                mat = {"type": DIELECTRIC, "albedo": [1.0, 1.0, 1.0], "ior": 1.5}
            add(center, 0.2, mat)
    add((0.0, 1.0, 0.0), 1.0, {"type": DIELECTRIC, "albedo": [1.0, 1.0, 1.0], "ior": 1.5})
    add((-4.0, 1.0, 0.0), 1.0, {"type": LAMBERTIAN, "albedo": [0.4, 0.2, 0.1]})
    add((4.0, 1.0, 0.0), 1.0, {"type": METAL, "albedo": [0.7, 0.6, 0.5], "roughness": 0.0})
    return {"objs": [], "materials": mats, "spheres": spheres}


def camera() -> dict:
    """The book's camera in the port's terms: yaw and pitch of the view
    direction v = unit(lookat - lookfrom) under camera.camera_basis's
    convention (its front is -v: v = (cos yaw cos pitch, sin pitch, sin
    yaw cos pitch)), so yaw = atan2(v_z, v_x), pitch = asin(v_y); the
    focus distance is |position - target|, so the target lies
    focus_dist along v; the aperture is the lens's diameter, 2
    focus_dist tan(defocus_angle / 2)."""
    v = np.subtract(LOOKAT, LOOKFROM)
    v = v / np.linalg.norm(v)
    return {"position": list(LOOKFROM),
            "target": [_r(p + FOCUS_DIST * x) for p, x in zip(LOOKFROM, v)],
            "world_up": [0.0, 1.0, 0.0],
            "yaw": _r(math.degrees(math.atan2(v[2], v[0]))),
            "pitch": _r(math.degrees(math.asin(v[1]))),
            "fov_degrees": VFOV,
            "aperture": _r(2.0 * FOCUS_DIST * math.tan(math.radians(DEFOCUS_ANGLE / 2.0)))}


def config(seed: int = 0) -> dict:
    scene = world(seed)
    return {
        "name": "rtiow_final_1200",
        "source": "Ray Tracing in One Weekend v4.0 (Shirley, Black, Hollasch), 14.1 A Final "
                  "Render, main.cc: world loop, camera and render settings",
        "deployment": "The most widely rendered public path-tracing scene: "
                      f"{len(scene['spheres'])} spheres, each with a material of its own (Lambertian, fuzzed metal, glass), lit by the "
                      "sky alone, at the book's 1200x675, 500 samples per pixel and 50 bounces "
                      "with no Russian roulette, in passes of 64 samples",
        "guarantees": "every pixel is the mean of its samples' radiance, each sample's path "
                      "traced with the draws keyed by (pixel, sample, bounce, purpose); the "
                      "same seed gives the same image",
        "resolution": [1200, 675],
        "spp": 500,
        "spp_per_pass": 64,
        "max_bounces": 50,
        "min_bounces": 50,
        "rr_max_prob": 0.95,
        "t_min": 0.001,
        "emission_quirk": False,
        "rng": "ktf",
        "bvh_width": 8,
        "camera": camera(),
        "scene": scene,
        "reduced": [],
        "assumed": {
            "scene": "the sphere list comes from the book's loop run once with numpy's "
                     "default_rng(0) (benchmark/tools/rtiow_scene.py), not from the book's "
                     "std::mt19937 draws, whose order C++ leaves unspecified: the same "
                     "distribution of ~485 spheres (487 here), not the book's own draws",
            "rng": "the counter-based Threefry draws the port's fused path specifies "
                   "(utils/ktf), in place of the book's per-thread generator",
            "camera": "yaw, pitch and target derived from lookfrom (13,2,3) and lookat "
                      "(0,0,0) under camera.camera_basis's convention: yaw = atan2(v_z, v_x), "
                      "pitch = asin(v_y) of v = unit(lookat - lookfrom); target = lookfrom + "
                      "10 v, since the port's focus distance is |position - target|; "
                      "aperture = 2 * 10 * tan(0.3 deg), the lens's diameter; min_bounces 50 "
                      "= max_bounces, so roulette never fires (the book's estimator)",
        },
    }


def dumps(cfg: dict) -> str:
    """The file's text: one key a line, one material or sphere a line."""
    lines = ["{"]
    items = list(cfg.items())
    for i, (k, v) in enumerate(items):
        end = "," if i + 1 < len(items) else ""
        if k == "scene":
            lines.append(f' "scene": {{"objs": {json.dumps(v["objs"])},')
            for name in ("materials", "spheres"):
                rows = [f"   {json.dumps(x)}" for x in v[name]]
                lines.append(f'  "{name}": [')
                lines.append(",\n".join(rows))
                lines.append("  ]," if name == "materials" else "  ]}" + end)
        else:
            lines.append(f" {json.dumps(k)}: {json.dumps(v)}{end}")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv) -> int:
    text = dumps(config())
    if "--check" in argv:
        with open(PATH) as f:
            same = f.read() == text
        print("the committed file is the generator's" if same else f"{PATH} differs")
        return 0 if same else 1
    with open(PATH, "w") as f:
        f.write(text)
    print(f"wrote {PATH}: {len(config()['scene']['spheres'])} spheres")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
