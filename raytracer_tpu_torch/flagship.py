"""Render the flagship artifact (the port's twin of
scripts/flagship_render.py): the reference's headline workload — 2K
(2560x1440) Cornell box + bunny, the interior showcase camera, 20-bounce
paths — at high spp through the fused path loop (K3, ktf draws, key 0)
via the resumable checkpoint driver (16-spp batches, an npz accumulator
written after each; a rerun resumes).

Usage: python -m raytracer_tpu_torch.flagship [spp] [out_png] [ckpt]
           [--stats PATH] [--device cuda|cpu]

Everything it writes goes under the git-ignored renders/ by default: the
PNG (renders/flagship_2k.png), the checkpoint (renders/flagship_ckpt.npz)
and the stats JSON (renders/flagship.json), which names the card and its
power limit. `--device cpu` runs the plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

WIDTH, HEIGHT = 2560, 1440
DEFAULT_SPP = 512
DEFAULT_OUT = os.path.join("renders", "flagship_2k.png")
DEFAULT_CKPT = os.path.join("renders", "flagship_ckpt.npz")
DEFAULT_STATS = os.path.join("renders", "flagship.json")


def main(argv=None) -> dict:
    from raytracer_tpu_torch.camera import showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.io.checkpoint import render_image_resumable
    from raytracer_tpu_torch.ops.tonemap import to_rgba8
    from raytracer_tpu_torch.scene.builder import reference_scene
    from raytracer_tpu_torch.utils.image import write_png
    from raytracer_tpu_torch.utils.profiling import device_line

    ap = argparse.ArgumentParser(description="The flagship 2K render")
    ap.add_argument("spp", nargs="?", type=int, default=DEFAULT_SPP)
    ap.add_argument("out_png", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("ckpt", nargs="?", default=DEFAULT_CKPT)
    ap.add_argument("--stats", default=DEFAULT_STATS, help="where the stats JSON goes")
    ap.add_argument("--device", default="cuda",
                    help="cuda launches the kernels; cpu runs their plain versions")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible (use --device cpu for "
                         "the plain version)")

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=args.spp, max_bounces=20,
                       spp_per_pass=16, rng_impl="ktf")
    scene = reference_scene().to(device)
    cam = showcase_camera(cfg)
    for path in (args.out_png, args.ckpt, args.stats):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    linear = render_image_resumable(scene, cam, cfg, 0, args.ckpt, integrator="fused")
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    write_png(args.out_png, to_rgba8(linear).cpu().numpy())
    stats = {
        "artifact": args.out_png,
        "width": cfg.width, "height": cfg.height, "spp": cfg.spp,
        "max_bounces": cfg.max_bounces,
        "integrator": "fused (K3, raytracer_tpu_torch/csrc/megakernel.cuh)",
        "camera": "showcase (interior, matches reference screenshot)",
        "wall_s_this_run": wall,
        "camera_rays": cfg.width * cfg.height * cfg.spp,
        "mean_rgb": float(linear.mean()),
        "finite": bool(torch.isfinite(linear).all()),
        "card": device_line(device),
        "note": "resumable 16-spp batches via io/checkpoint.render_image_resumable; "
                "wall_s_this_run excludes any prior resumed batches",
    }
    with open(args.stats, "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
