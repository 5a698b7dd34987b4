"""Render the five BASELINE.json milestone configs and write the results
(the port's twin of scripts/milestones.py).

Usage: python -m raytracer_tpu_torch.milestones [--out renders/] [--quick]
           [--only 1,...,5] [--device cuda|cpu]

  (1) cornell_spheres_256   — analytic spheres only, through the wavefront
  (2) cornell_materials_512 — Cornell triangles + all four material types
  (3) bunny_1080p           — the 81,952-triangle reference scene (K4)
  (4) inverse_render        — recover perturbed albedo and emission of
                              cornell_spheres from a target (Adam, lr 0.03)
  (5) reference_2k          — the full reference workload, resumable

Configs 1-3 render through models/wavefront.render_image_wavefront and
config 5 through io/checkpoint.render_image_resumable (the wavefront);
the integer seeds 1, 2, 3, 40 (config 4's target; 41 its init noise,
100 + i its step i) and 5 stand where the script has jax.random.key(…).
Each config is a function (cfg, seed, device, out=None) → record, so a
caller can pass a reduced cfg; `main` maps the config.PRESETS entries and
`--quick`'s cuts exactly as the script does. The records and file names
are the script's (`{name}.png`, `4_inverse_losses.json`,
`5_reference_2k.ckpt.npz`, `milestones.json` under --out), each record
with the card's name and power limit under "card" and the numbers
unrounded. A render's record also carries its linear image (f32[H,W,3],
on the CPU) under "image" and config 4's record its loss curve under
"losses", which milestones.json leaves out. The default
device is the card; `--device cpu` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from raytracer_tpu_torch.camera import make_camera, showcase_camera
from raytracer_tpu_torch.config import PRESETS
from raytracer_tpu_torch.utils.profiling import device_line

INVERSE_STEPS, INVERSE_QUICK_STEPS = 60, 10
INIT_SEED_OFFSET = 1   # config 4: init noise from seed + 1 (41)
STEP_SEED0 = 100       # config 4: step i draws with seed 100 + i


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _default_camera(cfg):
    return make_camera(aspect_ratio=cfg.aspect_ratio, fov_degrees=cfg.fov_degrees,
                       aperture=cfg.aperture)


def _emit(name, cfg, img, dt, device, out) -> dict:
    img = img.cpu()
    rays = cfg.width * cfg.height * cfg.spp
    rec = {"config": name, "size": [cfg.width, cfg.height], "spp": cfg.spp, "seconds": dt,
           "mrays_per_sec": rays / dt / 1e6, "mean_rgb": img.mean(dim=(0, 1)).tolist(),
           "finite": bool(torch.isfinite(img).all()), "card": device_line(device),
           "image": img}
    if out is not None:
        from raytracer_tpu_torch.ops.tonemap import to_rgba8
        from raytracer_tpu_torch.utils.image import write_png

        write_png(os.path.join(out, f"{name}.png"), to_rgba8(img).numpy())
    return rec


def _wavefront(name, scene, cam, cfg, seed, device, out) -> dict:
    from raytracer_tpu_torch.models.wavefront import render_image_wavefront

    scene = scene.to(device)
    img, dt = _timed(lambda: render_image_wavefront(scene, cam, cfg, seed), device)
    return _emit(name, cfg, img, dt, device, out)


def cornell_spheres(cfg, seed, device, out=None) -> dict:
    """Config 1: cornell_spheres, the reference camera pose."""
    from raytracer_tpu_torch.scene import builder

    return _wavefront("1_cornell_spheres", builder.cornell_spheres_scene(),
                      _default_camera(cfg), cfg, seed, device, out)


def cornell_materials(cfg, seed, device, out=None) -> dict:
    """Config 2: cornell_materials with its BVH8, the showcase camera."""
    from raytracer_tpu_torch.scene import builder

    return _wavefront("2_cornell_materials", builder.cornell_materials_scene(),
                      showcase_camera(cfg), cfg, seed, device, out)


def bunny_1080p(cfg, seed, device, out=None) -> dict:
    """Config 3: the reference scene (Cornell box + bunny), the showcase camera."""
    from raytracer_tpu_torch.scene import builder

    return _wavefront("3_bunny_1080p", builder.reference_scene(), showcase_camera(cfg), cfg,
                      seed, device, out)


def inverse_render(cfg, seed, device, out=None, steps: int = INVERSE_STEPS) -> dict:
    """Config 4: the target rendered with `seed`, albedo and emission
    noised by 0.15 with seed + 1, then `steps` Adam steps (lr 0.03), step i
    drawing with seed STEP_SEED0 + i. The record has the first and last
    loss and, under "losses", every step's."""
    from raytracer_tpu_torch.diff import inverse
    from raytracer_tpu_torch.render import render_image
    from raytracer_tpu_torch.scene import builder
    from raytracer_tpu_torch.utils import rng

    scene = builder.cornell_spheres_scene().to(device)
    cam = _default_camera(cfg)
    with torch.no_grad():
        target = render_image(scene, cam, cfg, seed)
    params = inverse.init_params(scene, fields=("albedo", "emission"),
                                 key=rng.key(seed + INIT_SEED_OFFSET, torch.device(device)),
                                 noise=0.15)
    state = inverse.adam_init(params)
    step = inverse.make_train_step(scene, cam, cfg, target, lr=0.03)
    losses = []

    def run():
        nonlocal params, state
        for i in range(steps):
            params, state, loss = step(params, state, STEP_SEED0 + i)
            losses.append(float(loss))

    _, dt = _timed(run, device)
    rec = {"config": "4_inverse_render", "steps": steps, "seconds": dt,
           "loss_first": losses[0], "loss_last": losses[-1], "card": device_line(device),
           "losses": losses}
    if out is not None:
        with open(os.path.join(out, "4_inverse_losses.json"), "w") as f:
            json.dump(losses, f)
    return rec


def reference_2k(cfg, seed, device, out=None) -> dict:
    """Config 5: the reference scene, the showcase camera, through the
    resumable driver (the checkpoint under `out`, or a temporary one)."""
    import tempfile

    from raytracer_tpu_torch.io.checkpoint import render_image_resumable
    from raytracer_tpu_torch.scene import builder

    scene = builder.reference_scene().to(device)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(out if out is not None else tmp, "5_reference_2k.ckpt.npz")
        img, dt = _timed(lambda: render_image_resumable(scene, showcase_camera(cfg), cfg, seed,
                                                        ckpt), device)
    return _emit("5_reference_2k", cfg, img, dt, device, out)


# (number, function, preset, --quick's cut of spp, seed), as in the script.
CONFIGS = (
    (1, cornell_spheres, "cornell_spheres_256", 4, 1),
    (2, cornell_materials, "cornell_materials_512", 8, 2),
    (3, bunny_1080p, "bunny_1080p", 8, 3),
    (4, inverse_render, "inverse_render", None, 40),
    (5, reference_2k, "reference_2k", 8, 5),
)


def json_record(rec: dict) -> dict:
    """The record without its image and loss curve: what milestones.json
    holds (the curve goes to 4_inverse_losses.json)."""
    return {k: v for k, v in rec.items() if k not in ("image", "losses")}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="The five BASELINE milestone configs")
    ap.add_argument("--out", default="renders")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None, help="comma-separated subset 1-5")
    ap.add_argument("--device", default="cuda",
                    help="cuda launches the kernels; cpu runs their plain versions")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible (use --device cpu for "
                         "the plain version)")
    os.makedirs(args.out, exist_ok=True)
    only = {int(x) for x in args.only.split(",")} if args.only else {1, 2, 3, 4, 5}

    results = []
    for number, fn, preset, quick_spp, seed in CONFIGS:
        if number not in only:
            continue
        cfg = PRESETS[preset]
        kw = {}
        if number == 4:
            kw["steps"] = INVERSE_QUICK_STEPS if args.quick else INVERSE_STEPS
        elif args.quick:
            cfg = cfg.replace(spp=quick_spp)
        rec = fn(cfg, seed, device, out=args.out, **kw)
        print(json.dumps(json_record(rec)), flush=True)
        results.append(rec)

    with open(os.path.join(args.out, "milestones.json"), "w") as f:
        json.dump([json_record(r) for r in results], f, indent=1)
    return results


if __name__ == "__main__":
    main()
