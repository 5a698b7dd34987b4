"""Measure, once, the work per camera path that k3_roofline.rtiow and
mfu.rtiow count, in a cell whose spheres K3 finds through the sphere
tree (run on a card; the result is written into
metrics/k3_roofline.rtiow.json by hand, with this derivation, and never
computed again by the harness).

    python3 -m benchmark.tools.freeze_counts_spheres <cell> <spp> <seed> [<seed> ...]

K3-profile renders the cell's whole frame with each request seed of the
given run seeds (the entry's set-up: the scene and its tree) and returns
every lane's path iterations, K1 steps, sphere-tree steps and sphere
tests. Every path iteration traces a ray: the cell's min_bounces equals
max_bounces, so roulette never ends one (the tool refuses another cell).
Operations per path = (SPHERE_OPS x (tree sphere tests + sweep spheres x
traced rays) + SLAB_OPS x sphere-tree steps + MT_OPS x K1 steps) / paths:
a sphere test is its 32 fp32 operations (3 subtractions for o - c, 5
for half_b, 7 for c, 3 for the discriminant, a max and a square root, 4
for the two roots, 4 range tests, a select, 3 comparisons); a step of
the tree's walk (a node's eight slab tests, or a leaf) counts one slab
test, 25 operations, and a K1 step one Moller-Trumbore record, 55, as
k3_roofline.json counts them: lower bounds. Bytes per path: the lanes'
pixel ids and rgb, 24 bytes a lane, as k3_roofline.json. The frame's
lane grid pads it to whole packets (1200 x 675: 870,400 lanes for
810,000 pixels); the padding lanes repeat a pixel, and only each pixel's
own lane (the grid's `inv`) is counted.
"""

from __future__ import annotations

import json
import sys

import torch

from benchmark import imaging, manifest

SPHERE_OPS, SLAB_OPS, MT_OPS = 32, 25, 55


def main(argv):
    cell, spp, seeds = argv[0], int(argv[1]), [int(s) for s in argv[2:]]
    bench = manifest.benchmark()
    w = manifest.workload(bench, cell)
    cfg, traffic = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    if cfg["min_bounces"] < cfg["max_bounces"]:
        raise SystemExit(f"{cell}: roulette can end a path iteration without a ray")
    dev = torch.device("cuda")
    runner = manifest.entry(traffic["entry"]).Runner(cfg, traffic, seeds[0], [dev],
                                                     manifest.ROOT)
    runner.setup()
    sc, rcfg, cam = runner.scene, runner.rcfg, runner.cam
    from raytracer_tpu_torch.models.fused import _fused_pixel_grid
    from raytracer_tpu_torch.ops.cuda_megakernel import render_tiles_fused

    px, py, inv = (torch.as_tensor(t).to(dev) for t in _fused_pixel_grid(rcfg))
    n_sweep = int(sc.sphere_tree.sweep.shape[0])
    rows = []
    for s in seeds:
        seed = imaging.request_seed(s, 0)
        _, _, _, k1, iters, steps, tests = render_tiles_fused(
            sc, cam, rcfg, seed, px, py, spp=spp, profile=True, lane_counts=True)
        lanes = inv.shape[0]
        paths = lanes * spp
        k1s, it = int(k1[inv].long().sum()), int(iters[inv].long().sum())
        st, te = int(steps[inv].long().sum()), int(tests[inv].long().sum())
        ops = SPHERE_OPS * (te + n_sweep * it) + SLAB_OPS * st + MT_OPS * k1s
        rows.append(dict(seed=s, request_seed=seed, lanes=lanes, spp=spp, traced_rays=it,
                         sphere_tree_steps=st, sphere_tests=te, sweep_spheres=n_sweep,
                         k1_steps=k1s, rays_per_path=it / paths, ops_per_path=ops / paths,
                         bytes_per_path=24 * lanes / paths))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"mean_ops_per_path": sum(r["ops_per_path"] for r in rows) / len(rows)}))


if __name__ == "__main__":
    main(sys.argv[1:])
