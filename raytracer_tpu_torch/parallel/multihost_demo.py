"""Multi-process worker: one rank of a torch.distributed run (the port's
counterpart of scripts/multihost_cpu_demo.py).

    python -m raytracer_tpu_torch.parallel.multihost_demo ADDR:PORT NPROCS RANK OUTDIR \
        [--device cpu|cuda] [--size small|card]

Each rank joins the process group at tcp://ADDR:PORT, builds the same
problem (`problem`), and through the global mesh (one shard per rank)
runs `run`: render_image_multihost, the rebalanced wavefront and one
mesh-sharded train step. It writes OUTDIR/rank<RANK>.npz. A caller holds
the ranks' files to each other and to `run` over an in-process mesh or
a single device. With --device cuda, rank 0 builds the kernels and the
scene library before the others start (behind a barrier); the gloo
backend is taken when ranks share a card.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

SIZES = {
    # The JAX package's multi-process test size (tests/test_multiprocess.py),
    # cornell_spheres on the CPU; the rebalance on 2,048 tile lanes.
    "small": dict(scene="cornell_spheres", render=dict(width=16, height=8, spp=2, max_bounces=3),
                  rebalance=dict(width=128, height=16, spp=2, max_bounces=4),
                  train=dict(width=16, height=8, spp=2, max_bounces=3)),
    # The CLI's frame on the reference scene (Cornell box + bunny); the
    # train step on cornell_materials at the inverse-rendering preset's
    # 128x128 and 6 bounces, 8 samples.
    "card": dict(scene="cornell_bunny", render=dict(width=640, height=360, spp=4, max_bounces=8),
                 rebalance=dict(width=640, height=360, spp=4, max_bounces=8),
                 train=dict(width=128, height=128, spp=8, max_bounces=6)),
}
SEED, TARGET_SEED, INIT_SEED, STEP_SEED, REBALANCE_DIV = 7, 99, 1, 5, 8


def problem(size: str, device) -> dict:
    """The scenes, cameras, configs, target and initial params of `size`
    on `device`, made from fixed seeds."""
    from raytracer_tpu_torch.camera import make_camera, showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.render import render_image
    from raytracer_tpu_torch.scene import builder
    from raytracer_tpu_torch.utils import rng

    spec = SIZES[size]
    device = torch.device(device)
    if spec["scene"] == "cornell_spheres":
        scene = builder.cornell_spheres_scene().to(device)
        train_scene = scene
    else:
        scene = builder.reference_scene().to(device)
        train_scene = builder.cornell_materials_scene().to(device)
    out = {"scene": scene, "train_scene": train_scene}
    for name in ("render", "rebalance", "train"):
        cfg = RenderConfig(**spec[name])
        if spec["scene"] == "cornell_spheres":
            cam = make_camera(aspect_ratio=cfg.aspect_ratio, fov_degrees=cfg.fov_degrees,
                              aperture=cfg.aperture)
        else:
            cam = showcase_camera(cfg)
        out[name] = (cfg, cam.to(device))
    cfg, cam = out["train"]
    with torch.no_grad():
        out["target"] = render_image(train_scene, cam, cfg, TARGET_SEED)
    out["params"] = inverse.init_params(train_scene, key=rng.key(INIT_SEED, device), noise=0.1)
    return out


def run(mesh, prob: dict) -> dict:
    """The three sharded calls over `mesh` → numpy results and seconds."""
    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.parallel.multihost import render_image_multihost
    from raytracer_tpu_torch.parallel.sharding import render_image_wavefront_rebalanced

    def timed(fn):
        for d in {d for d in mesh.devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        r = fn()
        for d in {d for d in mesh.devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)
        return r, time.perf_counter() - t0

    cfg, cam = prob["render"]
    img, img_s = timed(lambda: render_image_multihost(prob["scene"], cam, cfg, SEED, mesh))
    cfg, cam = prob["rebalance"]
    (reb, iters), reb_s = timed(lambda: render_image_wavefront_rebalanced(
        prob["scene"], cam, cfg, SEED, mesh, rebalance_div=REBALANCE_DIV, report_iters=True))
    cfg, cam = prob["train"]
    step = inverse.make_train_step(prob["train_scene"], cam, cfg, prob["target"], mesh=mesh)
    params = prob["params"]
    (p1, _, loss), step_s = timed(lambda: step(params, inverse.adam_init(params), STEP_SEED))
    out = {"img": img.cpu().numpy(), "rebalanced": reb.cpu().numpy(),
           "iters": iters.numpy(), "loss": np.float32(loss.item()),
           "seconds": np.array([img_s, reb_s, step_s])}
    out.update({f"param_{k}": v.detach().cpu().numpy() for k, v in p1.items()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("addr")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("outdir")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--size", default="card", choices=sorted(SIZES))
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from raytracer_tpu_torch.parallel import multihost

    backend = "gloo" if args.device == "cpu" else None
    multihost.initialize(f"tcp://{args.addr}", args.nprocs, args.rank, backend=backend)
    if not dist.is_initialized():
        raise SystemExit("multihost_demo: needs at least 2 processes")
    device = torch.device("cpu") if args.device == "cpu" else multihost.local_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)   # before the first collective (NCCL binds to it)

    def setup():
        if device.type == "cuda":
            from raytracer_tpu_torch.utils import cudalib

            cudalib.lib()
        return problem(args.size, device)

    # Rank 0 builds the kernels and the native scene library first; the
    # others then find them built.
    prob = setup() if args.rank == 0 else None
    dist.barrier()
    prob = setup() if prob is None else prob
    mesh = multihost.global_mesh(device)
    res = run(mesh, prob)
    backend_name = dist.get_backend()
    np.savez(os.path.join(args.outdir, f"rank{args.rank}.npz"), backend=backend_name,
             device=str(device), **res)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {args.rank}: wrote {args.outdir}/rank{args.rank}.npz ({backend_name})",
          flush=True)


if __name__ == "__main__":
    main()
