"""Measure, once, the work per camera path that the K3 and K4 rooflines
count (run on a card; the result is written into metrics/*.json by hand,
with this derivation, and never computed again by the harness).

    python3 -m benchmark.tools.freeze_counts <cell> <spp> <seed> [<seed> ...]

K3-profile renders the cell's whole frame with each request seed of the
given run seeds and returns every lane's K1 steps and path iterations.
Operations per path = (MT_OPS x K1 steps + CULL_OPS x brute triangles x
traced rays) / paths: one Moller-Trumbore record (55 operations) per K1
step (a node's slab tests or a leaf's records count as one record: a
lower bound) and the brute pre-pass's cull (31 operations) of each brute
triangle by each traced ray. Traced rays = path iterations - spp x lanes
(a sample's last iteration traces none when roulette ends it). Bytes per
path: each traced ray's origin, direction and limit in and its record
(t, material, normal) out, 48 bytes, as K4 takes them one call per
bounce; K3 keeps its rays on chip and reads 24 bytes per lane.
"""

from __future__ import annotations

import json
import sys

import torch

from benchmark import imaging, manifest, program

MT_OPS, CULL_OPS = 55, 31


def main(argv):
    cell, spp, seeds = argv[0], int(argv[1]), [int(s) for s in argv[2:]]
    bench = manifest.benchmark()
    cfg = manifest.config(manifest.workload(bench, cell)["config"])
    dev = torch.device("cuda")
    program.kernel_library(dev)
    rcfg = program.render_config(cfg)
    cam = program.camera(cfg, rcfg)
    sc, _ = program.scene(cfg, manifest.ROOT, dev)
    from raytracer_tpu_torch.models.fused import _fused_pixel_grid
    from raytracer_tpu_torch.ops.cuda_megakernel import render_tiles_fused

    px, py, _ = (t.to(dev) for t in _fused_pixel_grid(rcfg))
    n_brute = 0 if sc.bvh4.brute_tri is None else int(sc.bvh4.brute_tri.shape[0])
    rows = []
    for s in seeds:
        seed = imaging.request_seed(s, 0)
        _, _, _, k1, iters = render_tiles_fused(sc, cam, rcfg, seed, px, py, spp=spp,
                                                profile=True, lane_counts=True)
        lanes = px.shape[0]
        paths = lanes * spp
        steps, it = int(k1.long().sum()), int(iters.long().sum())
        traced = it - spp * lanes
        ops = MT_OPS * steps + CULL_OPS * n_brute * traced
        rows.append(dict(seed=s, request_seed=seed, lanes=lanes, spp=spp, k1_steps=steps,
                         path_iterations=it, traced_rays=traced, n_brute=n_brute,
                         ops_per_path=ops / paths, k3_bytes_per_path=24 * lanes / paths,
                         k4_bytes_per_path=48 * traced / paths))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"mean_ops_per_path": sum(r["ops_per_path"] for r in rows) / len(rows),
                      "mean_k4_bytes_per_path": sum(r["k4_bytes_per_path"] for r in rows)
                      / len(rows)}))


if __name__ == "__main__":
    main(sys.argv[1:])
