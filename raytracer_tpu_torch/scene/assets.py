"""Procedural scene assets (port of raytracer_tpu/scene/assets.py).

The reference renders assets/models/CornellBox-Original.obj + bunny.obj
(SceneManager.h:101-103), but its asset files are gitignored
(.gitignore:9-10). These writers generate stand-ins with the same
structure, byte for byte the files the JAX package writes (and the ones
committed under assets/models):

  * `write_cornell_box` emits the classic Cornell-Box-Original layout
    (floor/ceiling/back/left/right walls, two rotated boxes, area light)
    with the standard material palette, as OBJ+MTL, so the whole loading
    path (materials, usemtl groups, quads → triangulation) runs.
  * `write_bunny_substitute` emits a displaced icosphere of 81,920
    triangles standing in for the Stanford bunny (the same triangle-count
    scale as the real asset), with no materials, so it inherits the
    reference's off-by-table material quirk and renders with the ground
    Lambertian(0.5), as the real program does.

`ensure_assets` writes only the files that are missing. Numpy and text
only.
"""

from __future__ import annotations

import math
import os

import numpy as np

CORNELL_MTL = """# Cornell box (standard palette)
newmtl leftWall
Kd 0.63 0.065 0.05
newmtl rightWall
Kd 0.14 0.45 0.091
newmtl floor
Kd 0.725 0.71 0.68
newmtl ceiling
Kd 0.725 0.71 0.68
newmtl backWall
Kd 0.725 0.71 0.68
newmtl shortBox
Kd 0.725 0.71 0.68
newmtl tallBox
Kd 0.725 0.71 0.68
newmtl light
Kd 0.78 0.78 0.78
Ke 17.0 12.0 4.0
"""


def _box_quads(cx, cz, w, d, h, angle_deg, y0=0.0):
    """Axis box footprint w×d, height h, rotated about y, centered (cx,cz)."""
    a = math.radians(angle_deg)
    ca, sa = math.cos(a), math.sin(a)
    corners = []
    for sx, sz in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        x, z = sx * w / 2, sz * d / 2
        corners.append((cx + x * ca - z * sa, cz + x * sa + z * ca))
    v = []
    for y in (y0, y0 + h):
        for x, z in corners:
            v.append((x, y, z))
    # bottom(0-3), top(4-7); quads: top + 4 sides (no bottom, sits on floor)
    quads = [
        (4, 5, 6, 7),
        (0, 1, 5, 4),
        (1, 2, 6, 5),
        (2, 3, 7, 6),
        (3, 0, 4, 7),
    ]
    return v, quads


def write_cornell_box(path: str) -> None:
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    with open(mtl_path, "w") as f:
        f.write(CORNELL_MTL)

    verts: list[tuple] = []
    groups: list[tuple[str, list[tuple]]] = []

    def add_quad(mat, quad_verts):
        base = len(verts)
        verts.extend(quad_verts)
        groups.append((mat, [(base, base + 1, base + 2, base + 3)]))

    # Walls (standard Cornell-Original coordinates, open toward +Z).
    add_quad("floor", [(-1.01, 0.0, 0.99), (1.0, 0.0, 0.99), (1.0, 0.0, -1.04), (-0.99, 0.0, -1.04)])
    add_quad("ceiling", [(-1.02, 1.99, 0.99), (-1.02, 1.99, -1.04), (1.0, 1.99, -1.04), (1.0, 1.99, 0.99)])
    add_quad("backWall", [(-0.99, 0.0, -1.04), (1.0, 0.0, -1.04), (1.0, 1.99, -1.04), (-1.02, 1.99, -1.04)])
    add_quad("rightWall", [(1.0, 0.0, -1.04), (1.0, 0.0, 0.99), (1.0, 1.99, 0.99), (1.0, 1.99, -1.04)])
    add_quad("leftWall", [(-1.01, 0.0, 0.99), (-0.99, 0.0, -1.04), (-1.02, 1.99, -1.04), (-1.02, 1.99, 0.99)])
    add_quad("light", [(-0.24, 1.98, 0.16), (-0.24, 1.98, -0.22), (0.23, 1.98, -0.22), (0.23, 1.98, 0.16)])

    for name, (cx, cz, w, d, h, ang) in {
        "shortBox": (0.33, 0.37, 0.6, 0.6, 0.6, -17.0),
        "tallBox": (-0.34, -0.29, 0.6, 0.6, 1.2, 17.0),
    }.items():
        v, quads = _box_quads(cx, cz, w, d, h, ang)
        base = len(verts)
        verts.extend(v)
        groups.append((name, [tuple(base + i for i in q) for q in quads]))

    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        for x, y, z in verts:
            f.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
        for mat, quads in groups:
            f.write(f"usemtl {mat}\n")
            for q in quads:
                f.write("f " + " ".join(str(i + 1) for i in q) + "\n")


def _icosphere(subdiv: int):
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )
    for _ in range(subdiv):
        vlist = verts.tolist()
        cache: dict[tuple, int] = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (np.asarray(vlist[a]) + np.asarray(vlist[b])) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m.tolist())
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces


def write_bunny_substitute(path: str, subdiv: int = 6) -> None:
    """~69k-triangle organic blob (displaced icosphere): subdiv 6 →
    81920 tris, the same scale as the 69k-triangle Stanford bunny."""
    verts, faces = _icosphere(subdiv)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    # Smooth low-frequency displacement for bunny-like lumpiness.
    disp = (
        1.0
        + 0.18 * np.sin(3.1 * x + 1.3) * np.cos(2.3 * y)
        + 0.12 * np.sin(4.7 * z + 0.5) * np.sin(2.9 * y + 2.1)
        + 0.08 * np.cos(5.3 * x - 1.7 * z)
    )
    verts = verts * disp[:, None]
    # Squash to sit like a bunny: taller than wide, flattened base.
    verts[:, 1] = np.maximum(verts[:, 1] * 1.15, -0.72)
    verts[:, 1] -= verts[:, 1].min()
    # Match the RAW Stanford bunny's coordinate scale (extent ~0.155,
    # near the origin). This matters for scene composition:
    # SceneManager.h:307-325 re-normalizes ALL meshes after each load,
    # so Cornell (raw extent ~2.03) is scaled to 0.6 first, and the
    # joint pass over {0.6-box ∪ small bunny} is then a no-op — the
    # bunny must arrive small to sit INSIDE the box like the real asset.
    # We center it on the tall block's top face in normalized coords
    # (raw block top y=1.2 → 0.061; center (-0.34,-0.29) → (-0.098,-0.078))
    # to match the reference screenshot's bunny-on-pedestal framing.
    ext = (verts.max(0) - verts.min(0)).max()
    verts *= 0.155 / ext
    verts[:, 0] -= verts[:, 0].mean() + 0.098
    verts[:, 2] -= verts[:, 2].mean() + 0.078
    verts[:, 1] += 0.061 - verts[:, 1].min()
    with open(path, "w") as f:
        f.write("# procedural bunny-substitute (no materials, like the real asset)\n")
        for vx, vy, vz in verts:
            f.write(f"v {vx:.5f} {vy:.5f} {vz:.5f}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")


def ensure_assets(assets_dir: str) -> dict:
    """Generate the model files if missing; returns their paths."""
    os.makedirs(assets_dir, exist_ok=True)
    cornell = os.path.join(assets_dir, "CornellBox-Original.obj")
    bunny = os.path.join(assets_dir, "bunny.obj")
    if not os.path.exists(cornell):
        write_cornell_box(cornell)
    if not os.path.exists(bunny):
        write_bunny_substitute(bunny)
    return {"cornell": cornell, "bunny": bunny}
