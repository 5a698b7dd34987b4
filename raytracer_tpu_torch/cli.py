"""Command-line entry point (port of raytracer_tpu/cli.py): renders a PNG.

Usage (the default device is the CUDA card):
    python -m raytracer_tpu_torch.cli --scene cornell_bunny --width 2560 --height 1440 \
        --spp 8 --max-bounces 20 --out render.png
    python -m raytracer_tpu_torch.cli --scene cornell_bunny --width 2560 --height 1440 \
        --spp 2000 --checkpoint ckpt.npz
    python -m raytracer_tpu_torch.cli --integrator fused --scene cornell_bunny --serve 8000

`wavefront` (the default, as in the JAX CLI) is models/wavefront.py:
K4 for every bounce's closest hit and K2 for the draws, the draw family
of cfg.rng_impl. `fused` is the fused path-loop kernel (ktf draws): K3,
one lane per thread, or with RAYTRACER_TPU_INTERLEAVE=2 in the
environment K5, two lanes per thread (the JAX package's switch);
`megakernel` is the differentiable renderer (render.render_image_chunked).
`--checkpoint` makes the render resumable (io/checkpoint.py),
`--serve PORT` serves a preview that sharpens batch by batch
(viewer.py, megakernel integrator), and `--sharded` shards the pixels of
the differentiable renderer over every visible card, as the JAX CLI's
`--sharded` does (parallel/sharding.render_image_sharded; with
`--device cpu` one CPU shard). `--profile DIR` writes a torch.profiler
trace of the render into DIR (TensorBoard; utils/profiling.trace, the
card's kernels included on a card) and logs a `render` metrics record
(camera rays/s, seconds) to stderr. The JAX CLI enters its trace on the
`--serve` branch only; here it covers the render on every branch, as its
help text says.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch

INTEGRATORS = ("fused", "wavefront", "megakernel")


SCENES = ("cornell_bunny", "cornell", "cornell_materials", "cornell_spheres")


def build_scene(name: str, assets_dir: str | None):
    from raytracer_tpu_torch.scene import builder

    if name == "cornell_spheres":
        return builder.cornell_spheres_scene()
    if name == "cornell_materials":
        return builder.cornell_materials_scene(assets_dir)
    return builder.reference_scene(assets_dir, with_bunny=(name == "cornell_bunny"))


def main(argv=None):
    from raytracer_tpu_torch.camera import make_camera, showcase_camera
    from raytracer_tpu_torch.config import PRESETS, RenderConfig

    ap = argparse.ArgumentParser(description="PyTorch + CUDA path tracer")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--scene", default="cornell_bunny", choices=SCENES)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--max-bounces", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--npy", default=None, help="also dump the linear f32 image")
    ap.add_argument("--assets", default=None, help="model directory (default: the repo's)")
    ap.add_argument("--integrator", choices=INTEGRATORS, default="wavefront")
    ap.add_argument("--checkpoint", default=None,
                    help="npz accumulation checkpoint for resumable renders")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live auto-refreshing preview at PORT while rendering")
    ap.add_argument("--camera", default="showcase", choices=["showcase", "reference"])
    ap.add_argument("--sharded", action="store_true",
                    help="shard pixels over every visible card (the differentiable renderer)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the render to DIR (TensorBoard)")
    ap.add_argument("--device", default="cuda",
                    help="cuda launches the kernels; cpu runs their plain versions")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset] if args.preset else RenderConfig(
        width=1024, height=576, spp=64, max_bounces=20)
    overrides = {f: getattr(args, f) for f in ("width", "height", "spp")
                 if getattr(args, f) is not None}
    if args.max_bounces is not None:
        overrides["max_bounces"] = args.max_bounces
    if args.integrator == "fused":
        overrides["rng_impl"] = "ktf"
    cfg = cfg.replace(**overrides)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible (use --device cpu for "
                         "the plain version)")
    scene = build_scene(args.scene, args.assets).to(device)
    if args.camera == "reference":
        cam = make_camera(aspect_ratio=cfg.aspect_ratio, fov_degrees=cfg.fov_degrees,
                          aperture=cfg.aperture)
    else:
        cam = showcase_camera(cfg)

    if args.integrator == "fused":
        from raytracer_tpu_torch.ops.cuda_megakernel import fused_unavailable

        why = fused_unavailable(scene)
        if why is not None:
            raise SystemExit(f"--integrator fused needs a bvh4 scene of width 4 or 8 and, above "
                             f"16 spheres, its sphere tree: {why}")
    from raytracer_tpu_torch.utils.profiling import Meter, log_metrics, trace

    prof = trace(args.profile, device) if args.profile else contextlib.nullcontext()
    if args.serve is not None:
        import os

        from raytracer_tpu_torch import viewer

        os.makedirs("preview", exist_ok=True)
        srv = viewer.serve("preview", port=args.serve)
        print(f"serving the preview at http://localhost:{srv.server_address[1]}/",
              file=sys.stderr)
        try:
            with prof, Meter(cfg.width, cfg.height, cfg.spp) as meter:
                linear = viewer.progressive_render(
                    scene, cam, cfg, args.seed, out_path=os.path.join("preview", "preview.png"))
                _synchronize(device)
        finally:
            srv.shutdown()
            srv.server_close()
    else:
        with prof, Meter(cfg.width, cfg.height, cfg.spp) as meter:
            linear = _render(args, scene, cam, cfg, device)
            _synchronize(device)
    log_metrics("render", rays_per_sec=meter.rays_per_sec, seconds=meter.elapsed)
    _write_outputs(args, cfg, linear, meter.elapsed, device)


def _render(args, scene, cam, cfg, device):
    """The render of the chosen branch → linear f32[H,W,3]."""
    if args.checkpoint:
        from raytracer_tpu_torch.io.checkpoint import render_image_resumable

        return render_image_resumable(scene, cam, cfg, args.seed, args.checkpoint,
                                      integrator=args.integrator)
    if args.sharded:
        from raytracer_tpu_torch.parallel.sharding import make_mesh, render_image_sharded

        mesh = make_mesh([device] if device.type == "cpu" else None)
        return render_image_sharded(scene, cam, cfg, args.seed, mesh=mesh)
    if args.integrator == "fused":
        from raytracer_tpu_torch.models.fused import render_image_fused

        return render_image_fused(scene, cam, cfg, args.seed)
    if args.integrator == "wavefront":
        from raytracer_tpu_torch.models.wavefront import render_image_wavefront

        return render_image_wavefront(scene, cam, cfg, args.seed)
    from raytracer_tpu_torch.render import render_image_chunked

    with torch.no_grad():
        return render_image_chunked(scene, cam, cfg, args.seed)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _write_outputs(args, cfg, linear, dt, device):
    from raytracer_tpu_torch.ops.tonemap import to_rgba8
    from raytracer_tpu_torch.utils.image import write_npy, write_png

    rays = cfg.width * cfg.height * cfg.spp
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{cfg.width}x{cfg.height} spp={cfg.spp} in {dt:.3f}s "
          f"({rays / dt / 1e6:.2f} M camera rays/s on {name})", file=sys.stderr)
    # The reference renders bottom-up and flips at present time; the lane
    # layout already maps image row 0 to the top.
    write_png(args.out, to_rgba8(linear).cpu().numpy())
    if args.npy:
        write_npy(args.npy, linear.cpu().numpy())
    print(args.out)


if __name__ == "__main__":
    main()
