#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (raytracer_tpu_torch) on one
NVIDIA card: builds every kernel from csrc/, checks each against its
plain PyTorch version, and drives the main path — the reference scene
(Cornell box + bunny, BVH8 with the brute split) through the fused
path-loop kernel at 2560x1440, spp 8, 20 bounces.

    python3 chip_smoke.py              # every phase (what CI runs)
    python3 chip_smoke.py --phases 1,2,3   # a subset, while debugging

Every phase raises on failure, so the script exits non-zero. The last
two lines are a JSON object with one entry per kernel and
{"ok": true, "device": {...}}. It needs a CUDA card and imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(ROOT, "assets", "expected_preflight.json")
PREFLIGHT = dict(width=128, height=40, spp=2, max_bounces=12)
PREFLIGHT_RTOL = 0.02      # kernel mean vs the committed CPU-exact mean
MAIN = dict(width=2560, height=1440, spp=8, max_bounces=20)
MAIN_BAND = 0.15           # 2K mean vs the preflight mean (resolution shift)
MAIN_SAMPLE = 16384        # 2K pixels (seeded) re-rendered by the plain version
# Kernel vs plain image ("cross-compiler" tolerance, tests/test_fused_megakernel.py:70-73):
# at most 0.5% of elements beyond 5e-4 + 2e-4|x|, means within 1e-3.
IMG_ATOL, IMG_RTOL, IMG_BAD_FRAC, MEAN_TOL = 5e-4, 2e-4, 0.005, 1e-3
T_RTOL = 1e-4              # traversal t vs plain / brute force
NEAR_TIE_MAX = 1 / 5000    # id flips at equal t allowed per hit ray


def log(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over `reps` calls after a
    warm-up (CUDA events; the plain versions' host work is inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def image_agreement(a, b):
    """(bad element fraction, |mean difference| per channel max, max abs err)."""
    import torch

    diff = (a - b).abs()
    bad = diff > (IMG_ATOL + IMG_RTOL * b.abs())
    mean_diff = (a.mean(dim=(0, 1)) - b.mean(dim=(0, 1))).abs().max().item()
    return bad.float().mean().item(), mean_diff, diff.max().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    from raytracer_tpu_torch.camera import generate_rays, showcase_camera
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.fused import _fused_pixel_grid, render_image_fused
    from raytracer_tpu_torch.ops import cuda_megakernel, cuda_traverse
    from raytracer_tpu_torch.ops.bvh4 import BIG
    from raytracer_tpu_torch.ops.tonemap import to_rgba8
    from raytracer_tpu_torch.ops.triangle import intersect_tris_brute
    from raytracer_tpu_torch.scene.builder import reference_scene
    from raytracer_tpu_torch.schedule import _tiled_pixel_grid, blocked_pixel_grid
    from raytracer_tpu_torch.utils import cudalib, ktf
    from raytracer_tpu_torch.utils.image import write_png

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    kernels = {}

    # ---- 1. device
    smi = gpu_line()
    print(smi, flush=True)
    nvcc_v = subprocess.run([cudalib._nvcc(), "--version"], capture_output=True, text=True,
                            timeout=60).stdout.strip().splitlines()[-1]
    log(1, f"device: {card} | nvidia-smi: {smi} | torch {torch.__version__} "
           f"(CUDA {torch.version.cuda}) | nvcc: {nvcc_v} | count {torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    cudalib.lib()
    build_s = time.perf_counter() - t0
    info = cudalib.BUILD_INFO
    ptxas = [ln.strip() for ln in info.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(2, f"built {os.path.relpath(info['path'], ROOT)} in {build_s:.2f} s "
           f"(cached={info['cached']})")
    for ln in ptxas:
        log(2, f"  ptxas: {ln}")

    scene = None
    if phases & {4, 5, 6, 7}:
        t0 = time.perf_counter()
        scene_cpu = reference_scene()
        scene = scene_cpu.to(dev)
        b = scene_cpu.bvh4
        log(0, f"reference_scene: {scene_cpu.mesh.num_tris} tris, BVH{b.children.shape[1]} "
               f"{b.children.shape[0]} nodes, {b.tri.shape[0]} padded tris, "
               f"{b.brute_tri.shape[0]} brute rows, stack_depth {b.stack_depth}, "
               f"built in {time.perf_counter() - t0:.2f} s")

    # ---- 3. K2: Threefry bit for bit
    if 3 in phases:
        gen = torch.Generator().manual_seed(3)
        n = 1 << 20
        c0 = torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int64).to(torch.int32)
        c1 = torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int64).to(torch.int32)
        c0d, c1d = c0.to(dev), c1.to(dev)
        err = 0
        for seed in (0, 12345, (7 << 32) | 0xDEADBEEF):
            k0, k1 = ktf.key_words(seed)
            x0, x1 = ktf.threefry2x32_kernel(k0, k1, c0d, c1d)
            p0, p1 = ktf.threefry2x32(k0, k1, c0d, c1d)       # plain, on the card
            h0, h1 = ktf.threefry2x32(k0, k1, c0, c1)         # plain, on the host
            for x, ref in ((x0, p0), (x1, p1), (x0.cpu(), h0), (x1.cpu(), h1)):
                err = max(err, int((x.long() - ref.to(x.device).long()).abs().max()))
            if err:
                raise AssertionError(f"K2 threefry differs from utils.ktf under seed {seed}: "
                                     f"max |word difference| {err}")
        k0, k1 = ktf.key_words(0)
        ms = cuda_ms(lambda: ktf.threefry2x32_kernel(k0, k1, c0d, c1d), 50)
        plain_ms = cuda_ms(lambda: ktf.threefry2x32(k0, k1, c0d, c1d), 10)
        kernels["K2"] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms)
        log(3, f"K2 threefry2x32: bitwise equal to utils.ktf (card and host) on 2^20 "
               f"counters x 3 keys; kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms per 2^20 "
               f"blocks on {smi}")

    # ---- 4. K1/K4: traversal vs plain and brute force
    if 4 in phases:
        gen = np.random.default_rng(4)
        cfg = RenderConfig(**MAIN)
        cam = showcase_camera(cfg)
        m = 65536
        pxs = torch.from_numpy(gen.integers(0, cfg.width, m).astype(np.int32)).to(dev)
        pys = torch.from_numpy(gen.integers(0, cfg.height, m).astype(np.int32)).to(dev)
        o_cam, d_cam = generate_rays(cam, pxs, pys, cfg.width, cfg.height,
                                     ktf.sampler(0, pys * cfg.width + pxs))
        v = scene.mesh.vertices
        lo, hi = v.min(dim=0).values, v.max(dim=0).values
        span = hi - lo
        o_box = lo + span * (0.02 + 0.96 * torch.from_numpy(
            gen.uniform(size=(m, 3)).astype(np.float32)).to(dev))
        d_box = torch.from_numpy(gen.normal(size=(m, 3)).astype(np.float32)).to(dev)
        o = torch.cat([o_cam, o_box]).contiguous()
        d = torch.cat([d_cam, d_box]).contiguous()
        before = cuda_traverse.LAUNCHES["trace_closest"]
        rk = cuda_traverse.trace_closest(o, d, scene.bvh4, BIG)
        torch.cuda.synchronize()
        if cuda_traverse.LAUNCHES["trace_closest"] != before + 1:
            raise AssertionError("K4 did not launch")
        rp = cuda_traverse.trace_closest_plain(o, d, scene.bvh4, BIG)

        def compare(ref_t, ref_id, ref_hit, k, what):
            hit_ok = torch.equal(k["hit"], ref_hit)
            both = k["hit"] & ref_hit
            t_ok = bool(((k["t"][both] - ref_t[both]).abs()
                         <= T_RTOL * ref_t[both].abs()).all())
            flips = int((k["tri_id"][both] != ref_id[both]).sum())
            n_hit = int(both.sum())
            if not (hit_ok and t_ok):
                raise AssertionError(f"K4 vs {what}: hit mask equal {hit_ok}, t within "
                                     f"rtol {T_RTOL} {t_ok}")
            if flips > NEAR_TIE_MAX * max(n_hit, 1):
                raise AssertionError(f"K4 vs {what}: {flips} id flips at equal t in {n_hit} hits")
            return flips, n_hit

        f1, h1 = compare(rp["t"], rp["tri_id"], rp["hit"], rk, "plain")
        nb = 8192
        sel = torch.cat([torch.arange(0, nb // 2), torch.arange(m, m + nb // 2)]).to(dev)
        tb, ib = intersect_tris_brute(o[sel], d[sel], scene.mesh.vertices, scene.mesh.faces,
                                      1e-3, BIG, chunk=128)
        sub = {k2: v2[sel] for k2, v2 in rk.items()}
        f2, h2 = compare(tb, ib, tb < BIG, sub, "brute force")
        max_err = float((rk["t"] - rp["t"]).abs()[rk["hit"]].max()) if h1 else 0.0
        ms = cuda_ms(lambda: cuda_traverse.trace_closest(o, d, scene.bvh4, BIG), 20)
        plain_ms = cuda_ms(lambda: cuda_traverse.trace_closest_plain(o, d, scene.bvh4, BIG), 3)
        kernels["K1"] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)
        log(4, f"K4/K1 trace_closest on {2 * m} rays ({m} showcase-camera + {m} in-box): "
               f"{h1} hits; vs plain: hit masks equal, t within rtol {T_RTOL} "
               f"(max |dt| {max_err:.3g}), {f1} near-tie id flips; vs brute force on {nb} "
               f"rays x {scene.mesh.num_tris} tris: {h2} hits, {f2} near-tie id flips "
               f"(limit 1 in 5000); kernel {ms:.3f} ms vs plain {plain_ms:.1f} ms on {smi}")

    # ---- 5. preflight known answer, kernel vs plain
    if 5 in phases:
        with open(EXPECTED) as f:
            expected = json.load(f)["mean_rgb_ktf"]
        cfg = RenderConfig(**PREFLIGHT)
        cam = showcase_camera(cfg)
        img_k = render_image_fused(scene, cam, cfg, 0)
        img_p = render_image_fused(scene, cam, cfg, 0, plain=True)
        torch.cuda.synchronize()
        mean_k = img_k.mean().item()
        rel = abs(mean_k - expected) / expected
        bad, mean_diff, max_err = image_agreement(img_k, img_p)
        if not (torch.isfinite(img_k).all() and rel <= PREFLIGHT_RTOL):
            raise AssertionError(f"preflight mean {mean_k} vs {expected}: rel {rel}")
        if not (bad <= IMG_BAD_FRAC and mean_diff <= MEAN_TOL):
            raise AssertionError(f"K3 vs plain: {bad:.4%} elements beyond tolerance, "
                                 f"mean diff {mean_diff}")
        ms = cuda_ms(lambda: render_image_fused(scene, cam, cfg, 0), 20)
        plain_ms = cuda_ms(lambda: render_image_fused(scene, cam, cfg, 0, plain=True), 2)
        kernels["K3"] = dict(max_abs_err=max_err, preflight_max_abs_err=max_err, ms=ms,
                             plain_ms=plain_ms)
        log(5, f"preflight 128x40 spp2 mb12: kernel mean {mean_k:.6f} vs {expected:.6f} "
               f"(rel {rel:.2e}, gate {PREFLIGHT_RTOL}); plain mean {img_p.mean().item():.6f}; "
               f"kernel vs plain: {bad:.4%} elements beyond 5e-4+2e-4|x| (limit 0.5%), "
               f"mean diff {mean_diff:.2e}, max abs {max_err:.3g}; "
               f"kernel {ms:.3f} ms vs plain {plain_ms:.1f} ms per frame on {smi}")

    # ---- 6. bitwise invariants of the kernel
    if 6 in phases:
        cfg = RenderConfig(width=128, height=64, spp=2, max_bounces=8)
        cam = showcase_camera(cfg)
        px, py, inv = (t.to(dev) for t in _tiled_pixel_grid(cfg))
        whole = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py)
        chunked = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py,
                                                     host_chunk_packets=3)
        shape64 = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py, block=64)
        shape256 = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px, py, block=256)
        px2, py2, inv2 = (t.to(dev) for t in blocked_pixel_grid(cfg, 32, 32, 8, 16))
        blk = cuda_megakernel.render_tiles_fused(scene, cam, cfg, 4, px2, py2)
        checks = {
            "host-chunked == whole": torch.equal(whole, chunked),
            "block 64 == block 128 == block 256": (torch.equal(whole, shape64)
                                                   and torch.equal(whole, shape256)),
            "blocked grid == tiled grid": torch.equal(whole[inv], blk[inv2]),
        }
        cfg4 = RenderConfig(width=128, height=64, spp=4, max_bounces=8, spp_per_pass=4)
        a = render_image_fused(scene, cam, cfg4, 9)
        b2 = render_image_fused(scene, cam, cfg4.replace(spp_per_pass=2), 9)
        checks["spp split by sample_offset (atol 2e-5, rtol 1e-5)"] = bool(
            torch.allclose(a, b2, atol=2e-5, rtol=1e-5))
        for k, ok in checks.items():
            if not ok:
                raise AssertionError(f"kernel invariant failed: {k}")
        log(6, "kernel invariants hold: " + "; ".join(checks))

    # ---- 7. the main path
    if 7 in phases:
        cfg = RenderConfig(**MAIN)
        cam = showcase_camera(cfg)
        render_image_fused(scene, cam, cfg, 0)   # warm-up (same shapes)
        torch.cuda.synchronize()
        cuda_megakernel.LAUNCHES["render_fused"] = 0
        cuda_megakernel.PLAIN_CALLS["render_plain"] = 0
        t0 = time.perf_counter()
        img = render_image_fused(scene, cam, cfg, 0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n3 = cuda_megakernel.LAUNCHES["render_fused"]
        plain_calls = cuda_megakernel.PLAIN_CALLS["render_plain"]
        with open(EXPECTED) as f:
            expected = json.load(f)["mean_rgb_ktf"]
        mean = img.mean().item()
        if not bool(torch.isfinite(img).all()):
            raise AssertionError("2K image has non-finite pixels")
        if abs(mean - expected) / expected > MAIN_BAND:
            raise AssertionError(f"2K mean {mean} outside {MAIN_BAND} of {expected}")
        if n3 < 1 or plain_calls != 0:
            raise AssertionError(f"main path: K3 launches {n3}, plain path-loop calls "
                                 f"{plain_calls}")
        # The main-path frame against the plain version: a seeded sample of
        # pixels, each re-rendered from its lane of the frame's blocked grid
        # at the main config (spp 8, 20 bounces, seed 0). A pixel's radiance
        # depends on its own lane only, so the sample must agree with the
        # same pixels of the kernel's frame under the image tolerance.
        px, py, inv = (t.to(dev) for t in _fused_pixel_grid(cfg))
        pick = torch.from_numpy(np.random.default_rng(7).choice(
            cfg.width * cfg.height, MAIN_SAMPLE, replace=False)).to(dev)
        lane = inv[pick]
        t0 = time.perf_counter()
        ref = cuda_megakernel.render_tiles_fused_plain(scene, cam, cfg, 0, px[lane], py[lane])
        torch.cuda.synchronize()
        sample_plain_s = time.perf_counter() - t0
        got = img.reshape(-1, 3)[pick]
        bad_s, mean_diff_s, max_err_s = image_agreement(got[None], ref[None])
        if not (bad_s <= IMG_BAD_FRAC and mean_diff_s <= MEAN_TOL):
            raise AssertionError(f"2K frame vs plain on {MAIN_SAMPLE} pixels: {bad_s:.4%} "
                                 f"elements beyond tolerance, mean diff {mean_diff_s}")
        log(7, f"2K frame vs plain version on {MAIN_SAMPLE} seeded pixels (blocked-grid lanes, "
               f"spp {cfg.spp}, mb {cfg.max_bounces}): {bad_s:.4%} elements beyond "
               f"5e-4+2e-4|x| (limit 0.5%), mean diff {mean_diff_s:.2e}, max abs "
               f"{max_err_s:.3g}, bitwise equal {torch.equal(got, ref)}; plain took "
               f"{sample_plain_s:.2f} s for them")
        rays = cfg.width * cfg.height * cfg.spp
        # Spread: ten more frames, timed the same way (host clock around a
        # synchronized frame; one K3 launch each). CUDA events around the
        # same calls give the frame's stream time; the remainder of the host
        # time is the card's idle share.
        repeats, dev_s = [], []
        for _ in range(10):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev0.record()
            render_image_fused(scene, cam, cfg, 0)
            ev1.record()
            torch.cuda.synchronize()
            repeats.append(time.perf_counter() - t0)
            dev_s.append(ev0.elapsed_time(ev1) / 1e3)
        idle = 1.0 - sum(dev_s) / sum(repeats)
        os.makedirs(os.path.join(ROOT, "renders"), exist_ok=True)
        png = os.path.join(ROOT, "renders", "chip_smoke_2k.png")
        write_png(png, to_rgba8(img).cpu().numpy())
        med = float(np.median(repeats))
        kernels.setdefault("K3", {}).update(main_s=secs, main_median_s=med,
                                            max_abs_err=max_err_s)
        log(7, f"main path 2560x1440 spp8 mb20 (reference_scene, showcase camera): "
               f"{secs:.4f} s, {rays / secs / 1e6:.2f} M camera rays/s on {smi}; median of "
               f"{len(repeats)} repeats {med:.4f} s ({rays / med / 1e6:.2f} M camera rays/s); "
               f"mean {mean:.6f} "
               f"(band {MAIN_BAND} of {expected:.6f}); K3 launches {n3}, plain path-loop "
               f"calls {plain_calls}; wrote {os.path.relpath(png, ROOT)}; "
               f"repeat frames (s, host clock): {', '.join(f'{r:.4f}' for r in repeats)}; "
               f"stream time (s, CUDA events): {', '.join(f'{r:.4f}' for r in dev_s)}; "
               f"idle share {idle:.3f}")
        launches = n3
    else:
        launches = 0

    # K1 and K2 are __device__ code compiled into K3: on the main path they
    # run inside each K3 launch, so their `launches` is K3's count
    # (`launched_via`). Their ms / plain_ms / max_abs_err come from their
    # standalone launchers (K4 trace_closest.cu, ktf.cu), phases 3 and 4.
    src = "raytracer_tpu_torch/csrc/"
    table = [
        ("fused_path_loop (K3)", "megakernel.cu", "raytracer_tpu/ops/pallas_megakernel.py:623",
         "K3", None),
        ("bvh8_traverse (K1, inline in K3; timed alone through K4 trace_closest.cu)",
         "traverse.cuh", "raytracer_tpu/ops/pallas_traverse.py:319", "K1", "fused_path_loop (K3)"),
        ("threefry2x32 (K2, inline in K3; timed alone through ktf.cu)", "ktf.cuh",
         "raytracer_tpu/utils/ktf.py:65", "K2", "fused_path_loop (K3)"),
    ]
    rows = []
    for name, source, replaces, key, via in table:
        r = kernels.get(key, {})
        row = {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
               "launches": launches, "max_abs_err": r.get("max_abs_err"),
               "ms": r.get("ms"), "plain_ms": r.get("plain_ms")}
        if via:
            row["launched_via"] = via
            row["launches_are"] = f"launches of {via}, which runs this code inline"
        if "main_s" in r:
            row["main_path_s"] = r["main_s"]
            row["main_path_median_s"] = r["main_median_s"]
            row["max_abs_err_is"] = f"2K frame vs plain on {MAIN_SAMPLE} seeded pixels"
        if "preflight_max_abs_err" in r:
            row["preflight_max_abs_err"] = r["preflight_max_abs_err"]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
