"""Several processes, one shard each (port of raytracer_tpu/parallel/multihost.py).

Every process runs the same program: `initialize()` joins the
torch.distributed process group, `global_mesh()` gives one device per
rank, and the sharded renders (parallel/sharding.py) render this rank's
shard and gather the rest, so every rank returns the whole image.

    from raytracer_tpu_torch.parallel import multihost
    multihost.initialize()            # from MASTER_ADDR, RANK, WORLD_SIZE (torchrun)
    mesh = multihost.global_mesh()
    img = multihost.render_image_multihost(scene, cam, cfg, seed, mesh)

In a single process it degrades to the local cards' mesh, so the same
script runs everywhere. parallel/multihost_demo.py is a worker that
runs one render, a rebalanced render and a train step this way.
"""

from __future__ import annotations

import os
import time

import torch

from raytracer_tpu_torch.parallel.sharding import (RAY_AXIS, Mesh, make_mesh,
                                                   render_image_sharded)


def _backend(world_size: int) -> str:
    """nccl when every rank of this host has its own card, else gloo
    (NCCL refuses two ranks on one card; gloo's collectives run on host
    copies). The backend is only the transport: a shard renders on its
    rank's device either way."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= local else "gloo"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> bool:
    """torch.distributed.init_process_group from the arguments, else the
    environment (MASTER_ADDR / MASTER_PORT, RANK, WORLD_SIZE, as torchrun
    sets them). A no-op when the group is already up or when the run is
    single-process. Returns whether a process group is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = int(rank if rank is not None else os.environ["RANK"])
    dist.init_process_group(backend or _backend(world), init_method=init_method or "env://",
                            world_size=world, rank=rank)
    return True


def local_device() -> torch.device:
    """This rank's card: LOCAL_RANK (or the rank) modulo the visible
    cards. Raises without a card."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise RuntimeError("local_device: no CUDA card is visible; pass a device")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def global_mesh(device=None, axis_name: str = RAY_AXIS) -> Mesh:
    """A 1D mesh with one shard per rank of the process group, this
    rank's on `device` (default: local_device()). Without a process
    group: make_mesh over `device`, or over every visible card."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return make_mesh(None if device is None else [device], axis_name)
    device = local_device() if device is None else torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh([device] * dist.get_world_size(), (axis_name,), group=dist.group.WORLD)


def render_image_multihost(scene, cam, cfg, key, mesh: Mesh | None = None,
                           spp: int | None = None) -> torch.Tensor:
    """Full-image render with the pixels sharded over every rank: each
    renders its shard, then all_gathers, so every rank returns the whole
    image f32[H,W,3] on its device."""
    return render_image_sharded(scene, cam, cfg, key, mesh or global_mesh(), spp)


def _sync(devices):
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def scaling_report(scene, cam, cfg, key, device_counts=None, devices=None) -> dict:
    """{count: {seconds, rays_per_sec, efficiency}} of one render sharded
    over the first `count` of `devices` (default: every visible card),
    timed after a warm-up render. Efficiency is per-device throughput
    over the 1-device row's, which is always measured, even when the
    caller's counts start higher, so a 1 → 2 loss cannot hide. On one
    card it returns that row only."""
    every = make_mesh(devices).devices
    counts = device_counts or sorted({1, 2, 4, 8, len(every)})
    if 1 not in counts:
        counts = [1] + list(counts)
    results = {}
    for c in counts:
        if c > len(every):
            continue
        mesh = make_mesh(every[:c])
        render_image_multihost(scene, cam, cfg, key, mesh)
        _sync(mesh.devices)
        t0 = time.perf_counter()
        render_image_multihost(scene, cam, cfg, key, mesh)
        _sync(mesh.devices)
        dt = time.perf_counter() - t0
        results[c] = {"seconds": dt, "rays_per_sec": cfg.width * cfg.height * cfg.spp / dt}
    base = results[1]["rays_per_sec"]
    for c, row in results.items():
        row["efficiency"] = (row["rays_per_sec"] / c) / base
    return results
